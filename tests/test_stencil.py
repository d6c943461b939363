"""The 9-point block stencil matvec against the assembled dense operator,
in f64 and in f32, over grid shapes (even and odd), DOFs per node and
right-hand-side widths."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from eigd_tpu.ops.operators import ElementOperator
from eigd_tpu.ops.stencil import (GridStencilOperator, stencil_matvec,
                                  stencil_matvec_kernel, stencil_matvec_xla,
                                  use_kernel)
from eigd_tpu.ops.stencil_kernel import stencil_matvec_pallas


def grid_operator(nx, ny, ndof, seed=0):
    """GridStencilOperator from random symmetric element matrices on an
    nx x ny grid (node(i, j) = i*(ny+1) + j, element e = i + nx*j)."""
    rng = np.random.default_rng(seed)
    d = 4 * ndof
    mats = rng.standard_normal((nx * ny, d, d))
    mats = mats + mats.transpose(0, 2, 1)
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    i, j = i.reshape(-1), j.reshape(-1)  # e = i + nx*j
    corners = [(i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)]
    nodes = np.stack([a * (ny + 1) + b for a, b in corners], axis=1)
    dofs = (ndof * nodes[:, :, None] + np.arange(ndof)).reshape(nx * ny, d)
    n = (nx + 1) * (ny + 1) * ndof
    op = ElementOperator(jnp.asarray(mats), jnp.asarray(dofs), n)
    return GridStencilOperator.from_element_operator(op, (nx, ny), ndof)


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-13),
                                        ("float32", 1e-5)])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("ndof", [1, 2])
@pytest.mark.parametrize("nx,ny", [(16, 8), (33, 17)])
def test_stencil_matvec_matches_dense(nx, ny, ndof, k, dtype, rtol):
    op = grid_operator(nx, ny, ndof)
    dense = np.asarray(op.to_dense())
    rng = np.random.default_rng(1)
    x = rng.standard_normal((op.n, k))
    y = stencil_matvec(op.W.astype(dtype), jnp.asarray(x, dtype=dtype),
                       nx, ny, ndof)
    assert y.shape == (op.n, k) and y.dtype == jnp.dtype(dtype)
    ref = dense @ x
    # each output sums 9 * ndof products of |W| * |x|
    scale = 9 * ndof * np.abs(dense).max() * np.abs(x).max()
    assert np.abs(np.asarray(y, np.float64) - ref).max() <= rtol * scale
    if k == 1:
        y1 = op.mv(jnp.asarray(x[:, 0]))
        assert y1.shape == (op.n,)
        np.testing.assert_allclose(np.asarray(y1), ref[:, 0], rtol=0,
                                   atol=1e-13 * scale)


# ---------------------------------------------------------------------------
# The Pallas kernel (interpret mode here; compiled only on the GPU)
# ---------------------------------------------------------------------------


def _random_stencil(nx, ny, ndof, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    W = jnp.asarray(rng.standard_normal((nx + 1, ny + 1, 3, 3, ndof, ndof)),
                    dtype)
    x = jnp.asarray(rng.standard_normal(((nx + 1) * (ny + 1) * ndof, k)),
                    dtype)
    return W, x


@pytest.mark.parametrize("nx,ny,ndof,k,block", [
    (16, 8, 2, 8, 64), (33, 17, 1, 3, 64), (16, 8, 2, 1, 16),
    (7, 5, 2, 16, 64), (16, 8, 2, 6, 32), (33, 17, 2, 16, 128)])
@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-14),
                                        ("float32", 1e-6)])
def test_pallas_kernel_matches_xla(nx, ny, ndof, k, block, dtype, rtol):
    """Halo masks at every grid edge, a partial last block, and channel
    counts that are not powers of two (masked lanes)."""
    W, x = _random_stencil(nx, ny, ndof, k, dtype)
    ref = np.asarray(stencil_matvec_xla(W, x, nx, ny, ndof))
    got = np.asarray(stencil_matvec_pallas(W, x, nx, ny, ndof, block=block,
                                           interpret=True))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def test_pallas_kernel_vector_input():
    W, x = _random_stencil(16, 8, 2, 1, "float64")
    got = stencil_matvec_pallas(W, x[:, 0], 16, 8, 2, interpret=True)
    assert got.shape == (x.shape[0],)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(stencil_matvec_xla(W, x, 16, 8, 2))[:, 0],
        rtol=0, atol=1e-13)


def test_kernel_derivatives_match_xla():
    """The kernel's custom JVP (two plain-XLA matvecs) gives the same
    forward- and reverse-mode derivatives in W and x as the XLA form."""
    nx, ny, ndof = 8, 4, 2
    W, x = _random_stencil(nx, ny, ndof, 3, "float64")
    dW, dx = _random_stencil(nx, ny, ndof, 3, "float64", seed=1)
    c = jnp.asarray(np.random.default_rng(2).standard_normal(x.shape))

    def kern(W, x):
        return stencil_matvec_kernel(W, x, nx, ny, ndof, True)

    def xla(W, x):
        return stencil_matvec_xla(W, x, nx, ny, ndof)

    pairs = [(jax.jvp(kern, (W, x), (dW, dx)), jax.jvp(xla, (W, x),
                                                        (dW, dx))),
             # x held fixed: a symbolic-zero tangent for x
             (jax.jvp(lambda W: kern(W, x), (W,), (dW,)),
              jax.jvp(lambda W: xla(W, x), (W,), (dW,)))]
    for (yk, tk), (yx, tx) in pairs:
        np.testing.assert_allclose(np.asarray(tk), np.asarray(tx),
                                   rtol=0, atol=1e-12)
    gk = jax.grad(lambda W, x: jnp.sum(c * kern(W, x)), (0, 1))(W, x)
    gx = jax.grad(lambda W, x: jnp.sum(c * xla(W, x)), (0, 1))(W, x)
    for a, b in zip(gk, gx):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-12)


def test_kernel_choice():
    W64 = jnp.zeros((3, 3, 3, 3, 2, 2))
    x64 = jnp.zeros((18, 4))
    assert use_kernel("gpu", W64, x64)
    assert not use_kernel("cpu", W64, x64)
    assert not use_kernel("gpu", W64, x64.astype(jnp.float32))
    assert not use_kernel("gpu", W64.astype(jnp.float32), x64)
    # on this CPU backend the dispatcher runs the XLA form
    W, x = _random_stencil(8, 4, 2, 3, "float64")
    np.testing.assert_array_equal(
        np.asarray(stencil_matvec(W, x, 8, 4, 2)),
        np.asarray(stencil_matvec_xla(W, x, 8, 4, 2)))
