"""Collective helpers for DOF-dimension sharding (SURVEY.md §5.7-5.8).

Every solver in eigd_tpu takes an optional ``axis`` argument: ``None`` means
single-device (plain reductions); a string names a ``shard_map`` mesh axis
over which the DOF dimension of all long vectors is sharded. In that case
each inner product over the DOF dimension is a local contraction followed by
a ``psum`` over the axis — the tall-skinny-GEMM + all-reduce pattern that is
the on-device replacement for the MPI domain decomposition the reference
reaches only through TACS (reference crm.py:11,71).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


def psum(x, axis):
    """All-reduce over the shard axis (no-op when axis is None)."""
    return x if axis is None else jax.lax.psum(x, axis)


def pdot(x, y, axis):
    """Inner product / contraction over the (possibly sharded) DOF dim."""
    return psum(x @ y, axis)


def chunked_dot_f32(X, w, axis=None, chunk=8192):
    """(m, n) @ (n, p) contraction in f32 with f64 accumulation across n-chunks.

    A plain f32 matmul may accumulate sequentially over long stretches of n,
    with an error floor growing with n. Splitting n into ``chunk``-sized
    pieces, contracting each in f32, and summing the partials in f64 bounds
    the floor by the chunk length while keeping f32 matmul throughput — the cheap-but-accurate inner product for
    mixed-precision orthogonalization sweeps.
    """
    X = X.astype(jnp.float32)
    w = w.astype(jnp.float32)
    m, n = X.shape
    p = w.shape[1]
    nch = n // chunk
    if nch < 2:
        out = (X @ w).astype(jnp.float64)
        return psum(out, axis)
    # Batched dot with the chunk axis LEADING on both operands: the
    # canonical dot_general form that lowers to a tiled batched matmul.
    # (An einsum with the batch axis in the middle of X can lower to a
    # broadcast-multiply with a (p, n, m) temporary.) The (nch, m, chunk) transpose of X costs one m*n f32 copy
    # at memory bandwidth. A non-divisible tail is contracted separately
    # and added in f64 — it must NOT silently fall back to one plain f32
    # GEMM over all of n, which loses the accuracy guarantee exactly at
    # large n where it matters.
    n_main = nch * chunk
    Xr = X[:, :n_main].reshape(m, nch, chunk).transpose(1, 0, 2)
    wr = w[:n_main].reshape(nch, chunk, p)
    parts = jax.lax.dot_general(
        Xr, wr, (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)  # (nch, m, p)
    out = jnp.sum(parts.astype(jnp.float64), axis=0)
    if n_main < n:
        out = out + (X[:, n_main:] @ w[n_main:]).astype(jnp.float64)
    return psum(out, axis)


def tdot(rows, h):
    """rows^T @ h for a row-stored (r, n) block and a small (r, k) one.

    Contracts the short leading dim directly, so no (n, r) transposed copy
    of ``rows`` is formed. The (n, k) result is sharded over the DOF dim
    like ``rows``, so no psum is needed.
    """
    return jax.lax.dot_general(rows, h, (((0,), (0,)), ((), ())),
                               preferred_element_type=rows.dtype)


def qr_tall(R, axis):
    """Thin QR of a DOF-sharded tall (n, k) block.

    axis=None: plain ``jnp.linalg.qr``. Sharded: CholeskyQR2 — the Gram
    matrix is one psum-reduced GEMM, its Cholesky replicates on every
    device, and a second pass restores orthogonality to working precision
    (standard distributed tall-skinny QR; communication = two (k, k) psums).
    """
    if axis is None:
        return jnp.linalg.qr(R)

    def cholqr(R):
        # Column scaling first: adjoint residual blocks mix columns of very
        # different norms (converged vs active systems), and the Gram matrix
        # squares that conditioning — unscaled CholQR loses orthogonality
        # exactly when some systems have converged.
        cn = jnp.sqrt(psum(jnp.sum(R * R, axis=0), axis))
        s = jnp.where(cn > 0.0, cn, 1.0)
        Rs = R / s[None, :]
        G = psum(Rs.T @ Rs, axis)
        # Tiny diagonal regularization keeps the Cholesky finite for
        # (near-)rank-deficient blocks; the resulting r is still a valid
        # representation Q r ~= R at that rank.
        eps = 50.0 * float(jnp.finfo(R.dtype).eps)
        L = jnp.linalg.cholesky(G + eps * jnp.eye(G.shape[0], dtype=G.dtype))
        Q = solve_triangular(L, Rs.T, lower=True).T
        return Q, L.T * s[None, :]

    Q, r1 = cholqr(R)
    # Second pass restores orthogonality; its input is already normalized.
    eps2 = 50.0 * float(jnp.finfo(R.dtype).eps)
    G2 = psum(Q.T @ Q, axis)
    L2 = jnp.linalg.cholesky(
        G2 + eps2 * jnp.eye(G2.shape[0], dtype=G2.dtype))
    Q = solve_triangular(L2, Q.T, lower=True).T
    return Q, (L2.T @ r1)
