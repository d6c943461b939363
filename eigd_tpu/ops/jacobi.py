"""High-accuracy symmetric eigendecomposition for the reduced (m x m) problem.

XLA's built-in ``jnp.linalg.eigh`` is a QDWH-type iteration whose eigenvector
residuals bottom out around 1e-7 for f64 on this stack (measured; LAPACK gives
1e-16). The reduced Rayleigh-Ritz problem is exactly where that error is
amplified into the full-space eigenvectors, so eigd_tpu polishes the XLA
result with a few sweeps of **parallel-order cyclic Jacobi**: round-robin
pairings give m/2 disjoint (p, q) rotations per round, each round is applied
as one (m, m) x (m, m) GEMM — quadratically convergent, and
backward-stable. Starting from the XLA eigenbasis the matrix is already
near-diagonal, so 2-3 sweeps reach working precision.

This replaces the role LAPACK ``dsyev`` plays in the reference
(eigd/eigenvector_derivatives.py:1394, 1414) with an on-device kernel
instead of a host callback.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _round_robin_pairs(m):
    """Tournament pairings: (m-1) rounds of m/2 disjoint index pairs."""
    assert m % 2 == 0
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for i in range(m // 2):
            pairs.append((players[i], players[m - 1 - i]))
        rounds.append(pairs)
        # rotate all but the first
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.array(rounds, dtype=np.int32)  # (m-1, m/2, 2)


@partial(jax.jit, static_argnames=("sweeps",))
def jacobi_polish(Hmat, theta0, Y0, sweeps=3):
    """Polish an approximate eigendecomposition (theta0, Y0) of symmetric H.

    Transforms M = Y0^T H Y0 (near-diagonal), runs `sweeps` parallel-order
    Jacobi sweeps accumulating the rotations, and returns the refined
    (theta, Y) sorted ascending.
    """
    m = Hmat.shape[0]
    del theta0
    M = Y0.T @ Hmat @ Y0
    M = 0.5 * (M + M.T)

    odd = m % 2 == 1
    if odd:
        # Pad with a decoupled dummy dimension.
        M = jnp.pad(M, ((0, 1), (0, 1)))
        mp = m + 1
    else:
        mp = m

    rounds = jnp.asarray(_round_robin_pairs(mp))  # (mp-1, mp/2, 2)
    R = jnp.eye(mp, dtype=Hmat.dtype)

    def apply_round(carry, pairs):
        M, R = carry
        p = pairs[:, 0]
        q = pairs[:, 1]
        app = M[p, p]
        aqq = M[q, q]
        apq = M[p, q]
        # Jacobi rotation angle. tau**2 overflows for huge |tau| on
        # backends whose f64 has f32 range; use the asymptotic t ~ 1/(2 tau) in that regime and
        # guard the already-diagonal case.
        small = jnp.abs(apq) <= 1e-30 * (jnp.abs(app) + jnp.abs(aqq) + 1e-30)
        tau = (aqq - app) / jnp.where(small, 1.0, 2.0 * apq)
        big = jnp.abs(tau) > 1e8
        tau_safe = jnp.where(big, 1.0, tau)
        t_exact = jnp.sign(tau_safe) / (
            jnp.abs(tau_safe) + jnp.sqrt(1.0 + tau_safe * tau_safe))
        t_asym = 1.0 / (2.0 * jnp.where(big, tau, 1.0))
        t = jnp.where(big, t_asym, t_exact)
        t = jnp.where(small, 0.0, t)
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        s = t * c
        # Disjoint pairs -> assemble one orthogonal rotation matrix.
        G = jnp.eye(mp, dtype=M.dtype)
        G = G.at[p, p].set(c).at[q, q].set(c)
        G = G.at[p, q].set(s).at[q, p].set(-s)
        M = G.T @ M @ G
        M = 0.5 * (M + M.T)
        R = R @ G
        return (M, R), None

    def one_sweep(i, carry):
        (M, R), _ = jax.lax.scan(apply_round, carry, rounds)
        return (M, R)

    M, R = jax.lax.fori_loop(0, sweeps, one_sweep, (M, R))

    theta = jnp.diag(M)[:m]
    Y = (Y0 @ R[:m, :m]) if odd else (Y0 @ R)
    order = jnp.argsort(theta)
    return theta[order], Y[:, order]


def eigh_accurate(Hmat, sweeps=3):
    """Symmetric eigendecomposition at working precision.

    jnp.linalg.eigh for the bulk diagonalization + Jacobi polish for the last
    ~9 digits. Returns (theta, Y) ascending.
    """
    theta0, Y0 = jnp.linalg.eigh(Hmat)
    return jacobi_polish(Hmat, theta0, Y0, sweeps=sweeps)
