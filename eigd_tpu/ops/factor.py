"""Shift-invert factorizations: ``factor(x) = (A - sigma*B)^{-1} x``.

The reference's single hottest native kernel is SuperLU applied to the shifted
matrix (eigenvector_derivatives.py:11-23; SURVEY.md §2.3). The designs here
use only f64 Cholesky and eigh, which every XLA backend has:

* ``CholeskyFactor`` — dense Cholesky of the shifted matrix. Valid whenever the
  shifted matrix is SPD, which holds for sigma below the spectrum in "normal"
  mode (K - sigma*M with sigma < lam_min) and for buckling shifts below the
  first critical load (K + sigma*G). One O(n^3) factorization, then each apply
  is two triangular solves — blocked GEMM-like work for blocked RHS.
* ``EighFactor`` — robust fallback for indefinite shifted matrices: factor via
  a full symmetric eigendecomposition.
* ``CGFactor`` — matrix-free conjugate-gradient "inexact factor" with a Jacobi
  preconditioner, for problems too large to densify; tolerances integrate with
  the adjoint solvers exactly as an exact factor does.

All factors are pytrees and apply to (n,) vectors or (n, k) blocks. Apply
counting — the role of the reference's ``SpLuOperator.count``
(eigenvector_derivatives.py:16-22) — lives in
``eigd_tpu.utils.profile.FactorCounter``, which wraps any factor.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from .operators import as_operator


@jax.tree_util.register_pytree_node_class
class CholeskyFactor:
    """Dense Cholesky factor: apply(x) = (L L^T)^{-1} x.

    ``refine`` steps of iterative refinement (y += solve(x - M y)) remove the
    triangular-solve backward-error floor, which otherwise caps the attainable
    eigenpair residual at ~eps*cond(M); one step is enough to push the factor
    to working precision and costs one GEMM + one solve pair per apply.
    """

    def __init__(self, chol, mat=None, refine=1):
        self.chol = chol
        self.mat = mat
        self.refine = refine if mat is not None else 0

    @classmethod
    def from_matrix(cls, mat, refine=1):
        return cls(jnp.linalg.cholesky(mat), mat=mat if refine else None,
                   refine=refine)

    @property
    def shape(self):
        return self.chol.shape

    @property
    def dtype(self):
        return self.chol.dtype

    def _solve(self, x):
        y = solve_triangular(self.chol, x, lower=True)
        return solve_triangular(self.chol, y, lower=True, trans=1)

    def mv(self, x):
        y = self._solve(x)
        for _ in range(self.refine):
            y = y + self._solve(x - self.mat @ y)
        return y

    def __call__(self, x):
        return self.mv(x)

    def ok(self):
        """False if the matrix was not SPD (NaNs in the factor)."""
        return jnp.all(jnp.isfinite(self.chol))

    def tree_flatten(self):
        return (self.chol, self.mat), self.refine

    @classmethod
    def tree_unflatten(cls, aux, children):
        chol, mat = children
        return cls(chol, mat=mat, refine=aux)


@jax.tree_util.register_pytree_node_class
class EighFactor:
    """Eigendecomposition-based inverse, robust to indefinite shifted matrices.

    apply(x) = Q diag(1/w) Q^T x. O(n^3) setup like Cholesky but ~8x the
    constant; used when the buckling shift makes K + sigma*G indefinite.
    """

    def __init__(self, w, q):
        self.w = w
        self.q = q

    @classmethod
    def from_matrix(cls, mat):
        w, q = jnp.linalg.eigh(mat)
        return cls(w, q)

    @property
    def shape(self):
        n = self.w.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.w.dtype

    def mv(self, x):
        t = self.q.T @ x
        if x.ndim == 1:
            t = t / self.w
        else:
            t = t / self.w[:, None]
        return self.q @ t

    def __call__(self, x):
        return self.mv(x)

    def tree_flatten(self):
        return (self.w, self.q), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
class CGFactor:
    """Matrix-free conjugate-gradient inexact factor with Jacobi preconditioning.

    Applies (A - sigma*B)^{-1} approximately by running a fixed number of
    preconditioned CG iterations (static shapes; early termination is handled
    by freezing converged columns with jnp.where). All columns of a block RHS
    are advanced together so the matvecs stay batched.
    """

    def __init__(self, op, diag, maxiter=200, tol=1e-12):
        self.op = op  # the shifted operator (A - sigma B), an Operator
        self.diag = diag  # its diagonal, for the Jacobi preconditioner
        self.maxiter = maxiter
        self.tol = tol

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return self.diag.dtype

    def mv(self, b):
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        minv = 1.0 / self.diag

        def body(carry, _):
            x, r, p, rz = carry
            ap = self.op.mv(p)
            pap = jnp.sum(p * ap, axis=0)
            alpha = jnp.where(pap != 0.0, rz / jnp.where(pap == 0.0, 1.0, pap), 0.0)
            x = x + alpha[None, :] * p
            r = r - alpha[None, :] * ap
            z = minv[:, None] * r
            rz_new = jnp.sum(r * z, axis=0)
            beta = jnp.where(rz != 0.0, rz_new / jnp.where(rz == 0.0, 1.0, rz), 0.0)
            # freeze converged columns
            active = jnp.sqrt(jnp.sum(r * r, axis=0)) > self.tol
            p = jnp.where(active[None, :], z + beta[None, :] * p, 0.0)
            return (x, r, p, rz_new), None

        x0 = jnp.zeros_like(b)
        r0 = b
        z0 = minv[:, None] * r0
        rz0 = jnp.sum(r0 * z0, axis=0)
        (x, _, _, _), _ = jax.lax.scan(
            body, (x0, r0, z0, rz0), None, length=self.maxiter
        )
        if squeeze:
            x = x[:, 0]
        return x

    def __call__(self, x):
        return self.mv(x)

    def tree_flatten(self):
        return (self.op, self.diag), (self.maxiter, self.tol)

    @classmethod
    def tree_unflatten(cls, aux, children):
        op, diag = children
        return cls(op, diag, *aux)


def make_shift_factor(A, B, sigma, mode="normal", kind="cholesky", **kwargs):
    """Build the shift-invert factor used by the Lanczos solver.

    normal:   factor = (A - sigma*B)^{-1}   (reference natural_frequency.py:338)
    buckling: factor = (B + sigma*A)^{-1}   (reference buckling.py:582)
    """
    A = as_operator(A)
    B = as_operator(B)
    if mode == "normal":
        mat = A.to_dense() - sigma * B.to_dense()
    elif mode == "buckling":
        mat = B.to_dense() + sigma * A.to_dense()
    else:
        raise ValueError(f"Unknown mode {mode!r}")

    if kind == "cholesky":
        return CholeskyFactor.from_matrix(mat)
    if kind == "eigh":
        return EighFactor.from_matrix(mat)
    if kind == "cg":
        from .operators import DenseOperator

        return CGFactor(DenseOperator(mat), jnp.diag(mat), **kwargs)
    raise ValueError(f"Unknown factor kind {kind!r}")
