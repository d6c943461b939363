"""Multigrid factor tests: transfer adjointness, exact Galerkin coarse
stencils, solve accuracy vs dense, and the eigensolve end to end."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eigd_tpu.fem import assembly as fem
from eigd_tpu.fem.model import make_grid
from eigd_tpu.fem.quad import plane_stress_tables
from eigd_tpu.ops.multigrid import (GridMGFactor, galerkin_coarse_stencil,
                                    prolong, restrict, stencil_to_dense)
from eigd_tpu.ops.stencil import stencil_from_elements


@pytest.fixture(scope="module")
def grid_problem():
    nx, ny = 16, 8
    mesh = make_grid(nx, ny, 2.0, 1.0)
    conn = jnp.asarray(mesh.conn)
    X = jnp.asarray(mesh.X)
    Be, He, detJ = plane_stress_tables(X, conn)
    dofs = fem.element_dof_map(conn)
    C0 = fem.plane_stress_C0()
    rng = np.random.default_rng(0)
    rhoE = jnp.asarray(rng.uniform(0.3, 1.0, mesh.nelems))
    K = fem.stiffness_matrix(rhoE, Be, detJ, dofs, 2 * mesh.nnodes, C0)
    M = fem.mass_matrix(rhoE, He, detJ, dofs, 2 * mesh.nnodes)
    sigma = -10.0
    shifted = jnp.asarray(K.mats - sigma * M.mats)
    W = stencil_from_elements(shifted, nx, ny, 2)
    from eigd_tpu.ops.operators import ElementOperator

    dense = np.asarray(ElementOperator(shifted, K.dofs, K.n).to_dense())
    return nx, ny, mesh, K, M, W, dense


class TestTransfers:
    def test_prolong_restrict_adjoint(self):
        nxc, nyc, ndof = 6, 4, 2
        nf = (2 * nxc + 1) * (2 * nyc + 1) * ndof
        nc = (nxc + 1) * (nyc + 1) * ndof
        rng = np.random.default_rng(1)
        xc = jnp.asarray(rng.standard_normal(nc))
        yf = jnp.asarray(rng.standard_normal(nf))
        lhs = float(prolong(xc, nxc, nyc, ndof) @ yf)
        rhs = float(xc @ restrict(yf, nxc, nyc, ndof))
        assert abs(lhs - rhs) < 1e-12 * abs(lhs)

    def test_prolong_exact_on_bilinear_fields(self):
        # interpolation reproduces a linear field exactly
        nxc, nyc, ndof = 4, 3, 1
        Ic, Jc = np.meshgrid(np.arange(nxc + 1), np.arange(nyc + 1),
                             indexing="ij")
        lin = 2.0 * Ic + 0.5 * Jc + 1.0
        out = np.asarray(prolong(jnp.asarray(lin.reshape(-1)), nxc, nyc,
                                 ndof)).reshape(2 * nxc + 1, 2 * nyc + 1)
        If, Jf = np.meshgrid(np.arange(2 * nxc + 1), np.arange(2 * nyc + 1),
                             indexing="ij")
        expect = 2.0 * (If / 2) + 0.5 * (Jf / 2) + 1.0
        assert np.allclose(out, expect, atol=1e-14)


class TestGalerkin:
    def test_coarse_stencil_matches_dense_rap(self, grid_problem):
        nx, ny, mesh, K, M, W, dense = grid_problem
        ndof = 2
        nxc, nyc = nx // 2, ny // 2
        nc = (nxc + 1) * (nyc + 1) * ndof
        # dense P from prolong columns
        P = np.asarray(prolong(jnp.eye(nc), nxc, nyc, ndof))
        rap = P.T @ dense @ P
        Wc = galerkin_coarse_stencil(jnp.asarray(W), nx, ny, ndof)
        Ac = np.asarray(stencil_to_dense(Wc, nxc, nyc, ndof))
        assert np.allclose(Ac, rap, atol=1e-11 * np.abs(rap).max())

    def test_stencil_to_dense_roundtrip(self, grid_problem):
        nx, ny, mesh, K, M, W, dense = grid_problem
        A = np.asarray(stencil_to_dense(W, nx, ny, 2))
        assert np.allclose(A, dense, atol=1e-12 * np.abs(dense).max())


class TestFactorSolve:
    def test_mv_matches_dense_solve(self, grid_problem):
        nx, ny, mesh, K, M, W, dense = grid_problem
        fac = GridMGFactor.build(W, (nx, ny), 2, min_coarse=64)
        assert len(fac.Ws) >= 2  # hierarchy actually coarsens
        rng = np.random.default_rng(3)
        b = jnp.asarray(rng.standard_normal((dense.shape[0], 3)))
        x = np.asarray(fac.mv(b))
        xd = np.linalg.solve(dense, np.asarray(b))
        assert np.allclose(x, xd, rtol=0, atol=1e-10 * np.abs(xd).max())

    @pytest.mark.parametrize("variant", ["barrier", "f64"])
    def test_vcycle_variants_match_plain(self, grid_problem, variant):
        """The V-cycle implementation variants ("barrier" pins every
        smoother matvec behind optimization_barrier, "f64" runs all levels
        in f64) are the same math: solves agree with the plain variant to
        the solver tolerance, and the one-V-cycle preconditioner output
        agrees to f32 roundoff (fusion changes rounding, never the math)."""
        nx, ny, mesh, K, M, W, dense = grid_problem
        fac0 = GridMGFactor.build(W, (nx, ny), 2, min_coarse=64)
        facv = GridMGFactor.build(W, (nx, ny), 2, min_coarse=64,
                                  vcycle=variant)
        rng = np.random.default_rng(11)
        b = jnp.asarray(rng.standard_normal((dense.shape[0], 2)))
        x0 = np.asarray(jax.jit(fac0.mv)(b))
        xv = np.asarray(jax.jit(facv.mv)(b))
        scale = np.abs(x0).max()
        assert np.allclose(xv, x0, rtol=0, atol=1e-9 * scale)

        z0 = np.asarray(jax.jit(fac0._vcycle, static_argnums=0)(
            0, b.astype(jnp.float32)))
        bv = b if variant == "f64" else b.astype(jnp.float32)
        zv = np.asarray(jax.jit(facv._vcycle, static_argnums=0)(0, bv))
        assert np.allclose(zv, z0, rtol=0, atol=1e-4 * np.abs(z0).max())

    @pytest.mark.parametrize("variant", ["pallas", "auto"])
    def test_removed_vcycle_variants_raise(self, grid_problem, variant):
        nx, ny, mesh, K, M, W, dense = grid_problem
        with pytest.raises(ValueError, match="vcycle"):
            GridMGFactor.build(W, (nx, ny), 2, min_coarse=64,
                               vcycle=variant)

    def test_default_vcycle_is_plain(self, grid_problem):
        nx, ny, mesh, K, M, W, dense = grid_problem
        fac = GridMGFactor.build(W, (nx, ny), 2, min_coarse=64)
        assert fac.vcycle == "plain"

    def test_approx_mv_quality(self, grid_problem):
        nx, ny, mesh, K, M, W, dense = grid_problem
        fac = GridMGFactor.build(W, (nx, ny), 2, min_coarse=64)
        rng = np.random.default_rng(4)
        b = np.asarray(rng.standard_normal(dense.shape[0]))
        x = np.asarray(fac.approx_mv(jnp.asarray(b)))
        r = b - dense @ x
        assert np.linalg.norm(r) < 1e-3 * np.linalg.norm(b)

    def test_lanczos_with_mg_factor(self, grid_problem):
        import scipy.linalg

        nx, ny, mesh, K, M, W, dense = grid_problem
        from eigd_tpu.ops.lanczos import (b_orthonormalize_rows,
                                          lanczos_solve)
        from eigd_tpu.ops.operators import ElementOperator

        sigma = -10.0
        fac = GridMGFactor.build(W, (nx, ny), 2, min_coarse=64)
        A = ElementOperator(K.mats, K.dofs, K.n)
        B = ElementOperator(M.mats, M.dofs, M.n)
        # deflate the exactly-degenerate rigid triple (as the model does)
        X = jnp.asarray(mesh.X)
        n = K.n
        tx = jnp.zeros(n).at[0::2].set(1.0)
        ty = jnp.zeros(n).at[1::2].set(1.0)
        rot = jnp.zeros(n).at[0::2].set(-X[:, 1]).at[1::2].set(X[:, 0])
        deflate = b_orthonormalize_rows(jnp.stack([tx, ty, rot]), B.mv)
        Kd = np.asarray(A.to_dense())
        Md = np.asarray(B.to_dense())
        lam_d = scipy.linalg.eigh(Kd, Md, eigvals_only=True)
        # jit the whole composition: this is the graph shape that once hit
        # an XLA:CPU fusion bug (V-cycle corrupted next to the PCG
        # while_loop inside the Lanczos fori_loop) — keep it covered.
        res = jax.jit(lambda: lanczos_solve(A, B, fac, sigma, 6, 60,
                                            deflate=deflate))()
        # dense spectrum includes the 3 rigid ~0 modes; flexible start at 3.
        # tolerance: the 6th mode's Lanczos residual converges slowest; the
        # factor itself solves to ~1e-13 (test_mv_matches_dense_solve).
        np.testing.assert_allclose(np.asarray(res.lam), lam_d[3:9],
                                   rtol=5e-9)
