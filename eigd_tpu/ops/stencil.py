"""Structured-grid stencil operators: gather/scatter-free FE matvecs.

The generic ``ElementOperator`` matvec (gather -> batched GEMM ->
segment_sum) spends its time in gathers and scatters. On the regular grids of
every example problem the assembled operator is a 9-point nodal stencil with
(ndof, ndof) coupling blocks, so the matvec is nine shifted elementwise
block-products on an (nx+1, ny+1, ndof) grid layout, no gather anywhere. This
replaces the reference's CSR matvec (natural_frequency.py:157-158). On the
GPU it runs as a Pallas kernel (stencil_kernel.py): XLA's fusion of the plain
form reached only 15-20% of the HBM bound on the H100.

The stencil is *assembled from the element matrices with 16 static
slice-adds* (one per corner pair), so the whole build is differentiable and
XLA-fusable; the element matrices are kept alongside for the factorization
path (grid_block_tridiag) and ``to_dense``.

Node layout matches fem.model.make_grid: node(i, j) = i*(ny+1) + j, element
e = i + nx*j with corners [(i,j), (i+1,j), (i+1,j+1), (i,j+1)].
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.custom_derivatives import SymbolicZero

# corner -> (di, dj) within the element
_CORNERS = ((0, 0), (1, 0), (1, 1), (0, 1))


def stencil_from_elements(emats, nx, ny, ndof):
    """Element matrices -> nodal stencil W (nx+1, ny+1, 3, 3, ndof, ndof).

    W[i, j, 1+di, 1+dj] is the coupling block from node (i+di, j+dj) onto
    node (i, j). emats is (nx*ny, 4*ndof, 4*ndof) in e = i + nx*j order.
    """
    d4 = 4 * ndof
    Ke = emats.reshape(ny, nx, d4, d4).transpose(1, 0, 2, 3)  # (nx, ny, ., .)
    W = jnp.zeros((nx + 1, ny + 1, 3, 3, ndof, ndof), dtype=emats.dtype)
    for a, (ai, aj) in enumerate(_CORNERS):
        for b, (bi, bj) in enumerate(_CORNERS):
            blk = Ke[:, :, ndof * a: ndof * (a + 1),
                     ndof * b: ndof * (b + 1)]
            W = W.at[ai: ai + nx, aj: aj + ny,
                     1 + bi - ai, 1 + bj - aj].add(blk)
    return W


def use_kernel(backend, W, x):
    """Whether ``stencil_matvec`` runs the Pallas kernel: on the GPU
    backend, for operands of one dtype. On the H100 the kernel ran each
    matvec 1.6-3.5x faster than the XLA fusion and cut the 263k and 1M
    gradient wall times by 18% and 27% (PERF.md). Everywhere else the plain
    XLA form runs."""
    return backend == "gpu" and W.dtype == x.dtype


@partial(jax.jit, static_argnums=(2, 3, 4))
def stencil_matvec(W, x, nx, ny, ndof):
    """y = A x with the 9-point block stencil; x is (n,) or (n, k).

    jit-wrapped (inlined by XLA when called inside an enclosing jit) so the
    body is traced once per (shape, dtype) signature instead of at every
    V-cycle trace site. Differentiable in W and x on either path.
    """
    if use_kernel(jax.default_backend(), W, x):
        return stencil_matvec_kernel(W, x, nx, ny, ndof)
    return stencil_matvec_xla(W, x, nx, ny, ndof)


@partial(jax.custom_jvp, nondiff_argnums=(2, 3, 4, 5))
def stencil_matvec_kernel(W, x, nx, ny, ndof, interpret=False):
    """``stencil_matvec`` on the Pallas kernel (ops/stencil_kernel.py).

    The kernel has no derivative rules of its own; the operator is
    bilinear in (W, x), so the tangent is two plain-XLA stencil matvecs,
    which JAX can also transpose for reverse mode.
    """
    from .stencil_kernel import stencil_matvec_pallas

    return stencil_matvec_pallas(W, x, nx, ny, ndof, interpret=interpret)


@partial(stencil_matvec_kernel.defjvp, symbolic_zeros=True)
def _stencil_matvec_kernel_jvp(nx, ny, ndof, interpret, primals, tangents):
    W, x = primals
    dW, dx = tangents
    y = stencil_matvec_kernel(W, x, nx, ny, ndof, interpret)
    dy = jnp.zeros_like(y)
    if not isinstance(dW, SymbolicZero):
        dy = dy + stencil_matvec_xla(dW, x, nx, ny, ndof)
    if not isinstance(dx, SymbolicZero):
        dy = dy + stencil_matvec_xla(W, dx, nx, ny, ndof)
    return y, dy


@partial(jax.jit, static_argnums=(2, 3, 4))
def stencil_matvec_xla(W, x, nx, ny, ndof):
    """Plain-XLA ``stencil_matvec``: nine shifted slices of the padded x
    times the (ndof, ndof) blocks, unrolled into explicit broadcasted
    multiply-adds."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    k = x.shape[1]
    xg = x.reshape(nx + 1, ny + 1, ndof, k)
    xp = jnp.pad(xg, ((1, 1), (1, 1), (0, 0), (0, 0)))
    shifts = []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            shifts.append((W[:, :, 1 + di, 1 + dj],
                           xp[1 + di: 2 + di + nx, 1 + dj: 2 + dj + ny]))
    rows = []
    for a in range(ndof):
        acc = None
        for Ws, xs in shifts:
            for bdof in range(ndof):
                t = Ws[:, :, a, bdof, None] * xs[:, :, bdof, :]
                acc = t if acc is None else acc + t
        rows.append(acc)
    y = jnp.stack(rows, axis=2)
    out = y.reshape((nx + 1) * (ny + 1) * ndof, k)
    if squeeze:
        out = out[:, 0]
    return out


@jax.tree_util.register_pytree_node_class
class GridStencilOperator:
    """FE operator on a regular grid: stencil matvec + element-matrix view.

    Drop-in replacement for ElementOperator on grid problems; ``mats``/
    ``dofs`` are retained so the block-tridiagonal factor builders and
    ``to_dense`` keep working unchanged.
    """

    def __init__(self, mats, dofs, n, W, grid_shape, ndof=2, extra_diag=None):
        self.mats = mats  # (nelems, d, d) element matrices
        self.dofs = dofs  # (nelems, d) global DOF map
        self.n = n
        self.W = W  # (nx+1, ny+1, 3, 3, ndof, ndof), extra_diag folded in
        self.grid_shape = tuple(grid_shape)
        self.ndof = ndof
        # kept separately so factor builders working from the element
        # matrices can re-apply it (e.g. unit diagonal on Dirichlet DOFs)
        self.extra_diag = extra_diag

    @classmethod
    def from_element_operator(cls, op, grid_shape, ndof=2, extra_diag=None):
        nx, ny = grid_shape
        W = stencil_from_elements(op.mats, nx, ny, ndof)
        if extra_diag is not None:
            dg = extra_diag.reshape(nx + 1, ny + 1, ndof)
            for d in range(ndof):
                W = W.at[:, :, 1, 1, d, d].add(dg[:, :, d])
        return cls(op.mats, op.dofs, op.n, W, grid_shape, ndof,
                   extra_diag=extra_diag)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.W.dtype

    def mv(self, x):
        nx, ny = self.grid_shape
        return stencil_matvec(self.W, x, nx, ny, self.ndof)

    def __call__(self, x):
        return self.mv(x)

    def to_dense(self):
        out = jnp.zeros((self.n, self.n), dtype=self.mats.dtype)
        out = out.at[self.dofs[:, :, None],
                     self.dofs[:, None, :]].add(self.mats)
        if self.extra_diag is not None:
            out = out + jnp.diag(self.extra_diag)
        return out

    def tree_flatten(self):
        return (self.mats, self.dofs, self.W, self.extra_diag), (
            self.n, self.grid_shape, self.ndof)

    @classmethod
    def tree_unflatten(cls, aux, children):
        mats, dofs, W, extra_diag = children
        n, grid_shape, ndof = aux
        return cls(mats, dofs, n, W, grid_shape, ndof, extra_diag=extra_diag)
