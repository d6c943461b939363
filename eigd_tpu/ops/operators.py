"""Linear operators for eigd_tpu.

The reference (smdogroup/eigd) keeps matrices as SciPy CSR and factors them
with SuperLU (eigenvector_derivatives.py:11-23). On device the natural
representations are

* ``DenseOperator`` — an explicit (n, n) matrix; matvec is one GEMM. Used
  for small/medium problems and as the input to the dense Cholesky factor.
* ``ElementOperator`` — finite-element form: a batch of per-element dense
  matrices plus a DOF map. matvec = gather -> batched-GEMM -> segment_sum; this
  is the matrix-free form that scales (and shards over the element dimension).
* ``DiagonalOperator`` — diagonal (lumped) matrices.

All operators are registered pytrees so they can cross jit boundaries and be
differentiated through; ``mv`` accepts both vectors (n,) and blocks (n, k) —
blocked matvecs are the main matrix-unit win identified in SURVEY.md §2.4.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DenseOperator:
    """Explicit dense symmetric matrix operator."""

    mat: jax.Array

    @property
    def shape(self):
        return self.mat.shape

    @property
    def dtype(self):
        return self.mat.dtype

    def mv(self, x):
        return self.mat @ x

    def __call__(self, x):
        return self.mv(x)

    def to_dense(self):
        return self.mat

    def tree_flatten(self):
        return (self.mat,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DiagonalOperator:
    """Diagonal matrix operator."""

    diag: jax.Array

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.diag.dtype

    def mv(self, x):
        if x.ndim == 1:
            return self.diag * x
        return self.diag[:, None] * x

    def __call__(self, x):
        return self.mv(x)

    def to_dense(self):
        return jnp.diag(self.diag)

    def tree_flatten(self):
        return (self.diag,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
class ElementOperator:
    """Matrix-free finite-element operator.

    A = sum_e  P_e^T  Ke[e]  P_e  where P_e gathers the element DOFs.

    Parameters
    ----------
    mats : (nelems, d, d) per-element dense matrices (d = DOFs per element).
    dofs : (nelems, d) int32 global DOF index of each element DOF.
    n : global number of DOFs (static).

    The matvec is a gather, a batched (nelems, d, d) x (nelems, d, k) einsum
    (batched), and a segment-sum scatter — the on-device equivalent of the
    reference's COO->CSR assembly + CSR matvec (natural_frequency.py:157-158).
    """

    def __init__(self, mats, dofs, n):
        self.mats = mats
        self.dofs = dofs
        self.n = n

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.mats.dtype

    def mv(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        xe = x[self.dofs]  # (nelems, d, k)
        ye = jnp.einsum("eij,ejk->eik", self.mats, xe)
        d = self.dofs.shape[1]
        y = jax.ops.segment_sum(
            ye.reshape(-1, x.shape[1]),
            self.dofs.reshape(-1),
            num_segments=self.n,
        )
        del d
        if squeeze:
            y = y[:, 0]
        return y

    def __call__(self, x):
        return self.mv(x)

    def to_dense(self):
        out = jnp.zeros((self.n, self.n), dtype=self.mats.dtype)
        return out.at[self.dofs[:, :, None], self.dofs[:, None, :]].add(self.mats)

    def tree_flatten(self):
        return (self.mats, self.dofs), self.n

    @classmethod
    def tree_unflatten(cls, aux, children):
        mats, dofs = children
        return cls(mats, dofs, aux)


Operator = Union[DenseOperator, DiagonalOperator, ElementOperator]


def as_operator(obj) -> Operator:
    """Coerce an array / operator into an Operator. Anything with an ``mv``
    method (e.g. parallel.sharded.GridHaloOperator) passes through."""
    if hasattr(obj, "mv"):
        return obj
    arr = jnp.asarray(obj)
    if arr.ndim == 1:
        return DiagonalOperator(arr)
    if arr.ndim == 2:
        return DenseOperator(arr)
    raise TypeError(f"Cannot interpret {type(obj)} as an operator")


def reduce_operator_dense(op: Operator, free: jax.Array) -> DenseOperator:
    """Apply Dirichlet BC reduction by extracting the free-free block.

    On-device equivalent of the reference's reduce_matrix
    (buckling.py:499-528): instead of deleting CSR rows/cols we gather the
    free-index submatrix of the dense form.
    """
    mat = op.to_dense()
    return DenseOperator(mat[jnp.ix_(free, free)])


def expand_vector(vec, free, n):
    """Scatter a reduced vector (nfree, ...) back to the full space (n, ...)."""
    out = jnp.zeros((n,) + vec.shape[1:], dtype=vec.dtype)
    return out.at[free].set(vec)


def reduce_vector(vec, free):
    """Gather the free entries of a full vector."""
    return vec[free]
