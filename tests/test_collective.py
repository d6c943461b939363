"""Basis contractions over the DOF dimension against NumPy f64: the native
f64 ``pdot`` / ``tdot`` products, serial and under ``shard_map`` on the
virtual 8-device CPU mesh, plus the chunked f32 sweep product and qr_tall."""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from eigd_tpu.ops.collective import chunked_dot_f32, pdot, qr_tall, tdot
from eigd_tpu.parallel import make_mesh

NDEV = 8


def _rel(got, ref):
    return np.linalg.norm(np.asarray(got) - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("m,n,k", [(8, 5000, 3), (16, 304, 8),
                                   (1, 8192, 1)])
def test_pdot_matches_f64(m, n, k):
    rng = np.random.default_rng(0)
    # mixed row magnitudes: an f32-accurate product would show here
    X = rng.standard_normal((m, n)) * 10.0 ** rng.uniform(-6, 6, (m, 1))
    w = rng.standard_normal((n, k))
    got = jax.jit(partial(pdot, axis=None))(jnp.asarray(X), jnp.asarray(w))
    assert got.dtype == jnp.float64
    assert _rel(got, X @ w) < 1e-13


def test_pdot_cancellation():
    # hi parts cancel and the small remainder carries the answer: a product
    # at f32 accuracy would be O(1) wrong here
    n = 4096
    rng = np.random.default_rng(1)
    a = rng.standard_normal(n)
    X = np.stack([a, -a + 1e-9 * rng.standard_normal(n)])
    w = np.ones((n, 1))
    got = np.asarray(pdot(jnp.asarray(X), jnp.asarray(w), None))
    ref = X @ w
    assert abs(got.sum() - ref.sum()) < 1e-10


@pytest.mark.parametrize("rows,n,k", [(32, 300, 8), (4, 64, 4)])
def test_tdot_matches_f64(rows, n, k):
    rng = np.random.default_rng(2)
    R = rng.standard_normal((rows, n)) * 10.0 ** rng.uniform(-4, 4, (rows, 1))
    h = rng.standard_normal((rows, k))
    got = jax.jit(tdot)(jnp.asarray(R), jnp.asarray(h))
    assert got.shape == (n, k) and got.dtype == jnp.float64
    assert _rel(got, R.T @ h) < 1e-13


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= NDEV, jax.devices()
    return make_mesh(NDEV, axis="grid")


def test_pdot_sharded_matches_f64(mesh):
    """DOF-sharded (m, n) @ (n, k): local GEMM + psum over the mesh axis."""
    rng = np.random.default_rng(3)
    m, n, k = 24, 8 * 640, 8
    X = rng.standard_normal((m, n))
    w = rng.standard_normal((n, k))

    @partial(shard_map, mesh=mesh, in_specs=(P(None, "grid"), P("grid")),
             out_specs=P())
    def f(Xl, wl):
        return pdot(Xl, wl, "grid")

    got = jax.jit(f)(jnp.asarray(X), jnp.asarray(w))
    assert _rel(got, X @ w) < 1e-13


def test_tdot_sharded_matches_f64(mesh):
    """rows^T @ h with the rows block sharded over DOFs: the result stays
    DOF-sharded, no collective."""
    rng = np.random.default_rng(4)
    rows, n, k = 16, 8 * 512, 6
    R = rng.standard_normal((rows, n))
    h = rng.standard_normal((rows, k))

    @partial(shard_map, mesh=mesh, in_specs=(P(None, "grid"), P()),
             out_specs=P("grid"))
    def f(Rl, hl):
        return tdot(Rl, hl)

    got = jax.jit(f)(jnp.asarray(R), jnp.asarray(h))
    assert _rel(got, R.T @ h) < 1e-13


def test_chunked_dot_f32_accuracy():
    # f32 inputs, f64 chunk accumulation: floor ~ (chunk/128)*eps32
    rng = np.random.default_rng(4)
    n = 1 << 16
    X = jnp.asarray(rng.standard_normal((4, n)))
    w = jnp.asarray(rng.standard_normal((n, 3)))
    ref = np.asarray(X) @ np.asarray(w)
    got = np.asarray(chunked_dot_f32(X, w))
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 5e-6


def test_qr_tall_serial():
    rng = np.random.default_rng(5)
    R = jnp.asarray(rng.standard_normal((200, 5)))
    Q, r = qr_tall(R, None)
    assert np.allclose(np.asarray(Q) @ np.asarray(r), np.asarray(R),
                       atol=1e-12)
