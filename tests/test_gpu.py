"""Card-marked tests: run on an NVIDIA GPU with
``EIGD_TEST_DEVICE=gpu pytest -m gpu tests/``; they skip elsewhere."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.gpu


def test_f32_matmul_is_not_tf32():
    """jax_default_matmul_precision="highest" (eigd_tpu.config) keeps f32
    products in full f32: ~1e-7 relative against f64, where TF32 reads
    ~1e-3."""
    import eigd_tpu  # noqa: F401

    rng = np.random.default_rng(0)
    A = rng.standard_normal((1024, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 16)).astype(np.float32)
    got = np.asarray(jax.jit(jnp.matmul)(A, b), np.float64)
    ref = A.astype(np.float64) @ b.astype(np.float64)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5


def test_f64_eigh_residual_m176():
    """cuSOLVER f64 eigh of an (m, m) reduced Lanczos matrix at m=176 with a
    clustered spectrum: residual and orthogonality at working precision.
    The printed numbers decide whether the Jacobi polish
    (ops/jacobi.eigh_accurate) is still needed on the card."""
    m = 176
    rng = np.random.default_rng(1)
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    w = np.concatenate([1.0 + 1e-9 * np.arange(6),
                        np.logspace(0.5, 6, m - 6)])
    H = (Q * w) @ Q.T
    H = 0.5 * (H + H.T)
    theta, Y = jax.jit(jnp.linalg.eigh)(jnp.asarray(H))
    theta, Y = np.asarray(theta), np.asarray(Y)
    res = np.linalg.norm(H @ Y - Y * theta) / np.linalg.norm(H)
    orth = np.abs(Y.T @ Y - np.eye(m)).max()
    print(f"cuSOLVER f64 eigh m={m}: residual {res:.2e}, "
          f"orthogonality {orth:.2e}")
    assert res < 1e-13 and orth < 1e-12


def test_natural_frequency_small_matches_scipy():
    """The natural-frequency pipeline on the card at 16x8: eigenvalues
    against SciPy's dense f64 eigh on the same assembled K and M, and a
    finite gradient."""
    import scipy.linalg

    from eigd_tpu.fem import assembly as fem
    from eigd_tpu.models.natural_frequency import make_model

    topo = make_model(nx=16, ny=8, Lx=2.0, Ly=1.0, N=4, m=64, rfact=2.0,
                      factor_kind="mg", sigma=-1.0,
                      factor_options={"min_coarse": 64})
    x0 = jnp.asarray(topo.x)

    def objective(x):
        lam, Q, _, _ = topo._solve_fn(x)
        return jnp.sum(jnp.sqrt(lam)) + jnp.sum(Q[:8] ** 2)

    v, g = jax.jit(jax.value_and_grad(objective))(x0)
    assert np.all(np.isfinite(np.asarray(g)))
    lam = np.asarray(topo._solve_jit(x0)[0])
    rhoE = fem.element_density(topo.fltr.apply(x0), topo.conn)
    K, M = topo._assemble(rhoE)
    ref = scipy.linalg.eigh(np.asarray(K.to_dense()),
                           np.asarray(M.to_dense()), eigvals_only=True)
    np.testing.assert_allclose(lam, ref[3:3 + len(lam)], rtol=1e-9)


def test_stencil_kernel_under_shard_map():
    """The dispatching stencil_matvec (the Pallas kernel on the card) inside
    shard_map, as the line-sharded multigrid runs it: value and the
    gradient in W against the plain-XLA form."""
    from functools import partial

    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from eigd_tpu.ops.stencil import stencil_matvec, stencil_matvec_xla

    nx, ny, ndof = 32, 16, 2
    rng = np.random.default_rng(3)
    W = jnp.asarray(rng.standard_normal((nx + 1, ny + 1, 3, 3, ndof, ndof)))
    x = jnp.asarray(rng.standard_normal(((nx + 1) * (ny + 1) * ndof, 6)))
    mesh = Mesh(np.array(jax.devices()[:1]), ("grid",))

    @partial(shard_map, mesh=mesh, in_specs=(P("grid"), P("grid")),
             out_specs=P("grid"))
    def mv(W, x):
        return stencil_matvec(W, x, nx, ny, ndof)

    def loss(f, W):
        return jnp.sum(jnp.sin(f(W, x)))

    ref = stencil_matvec_xla(W, x, nx, ny, ndof)
    np.testing.assert_allclose(np.asarray(jax.jit(mv)(W, x)),
                               np.asarray(ref), rtol=0, atol=1e-12)
    g = jax.jit(jax.grad(lambda W: loss(mv, W)))(W)
    gref = jax.grad(lambda W: loss(
        lambda W, x: stencil_matvec_xla(W, x, nx, ny, ndof), W))(W)
    np.testing.assert_allclose(np.asarray(g), np.asarray(gref), rtol=0,
                               atol=1e-11)
