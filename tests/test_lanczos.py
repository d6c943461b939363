"""Forward eigensolver tests: Lanczos vs dense eigh oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eigd_tpu import (
    BasicLanczos,
    DenseOperator,
    make_shift_factor,
)
from eigd_tpu.ops.lanczos import lanczos_solve
from eigd_tpu.ops.autodiff import eigh_gen_oracle


def make_spd_pencil(n, seed=0, mass_scale=1.0):
    """SPD pencil with an FE-like spectrum: well-separated low eigenvalues,
    clustered high end."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.concatenate([np.arange(1.0, 11.0) ** 2, np.linspace(200.0, 500.0, n - 10)])
    A = Q @ np.diag(w) @ Q.T
    Bm = rng.standard_normal((n, n)) * 0.05
    Bm = mass_scale * (Bm @ Bm.T + np.eye(n))
    # Keep the pencil spectrum controlled: A in the B metric
    L = np.linalg.cholesky(Bm)
    A = L @ A @ L.T
    return jnp.asarray(0.5 * (A + A.T)), jnp.asarray(Bm)


class TestLanczosNormalMode:
    def test_eigenvalues_match_dense(self):
        n, N = 120, 6
        A, B = make_spd_pencil(n)
        sigma = 0.0
        factor = make_shift_factor(A, B, sigma)
        res = lanczos_solve(DenseOperator(A), DenseOperator(B), factor,
                            sigma, N, m=60)
        import scipy.linalg

        lam_ref = scipy.linalg.eigh(np.asarray(A), np.asarray(B),
                                    eigvals_only=True)[:N]
        np.testing.assert_allclose(np.asarray(res.lam), lam_ref, rtol=1e-10)

    def test_eigenvectors_satisfy_pencil(self):
        n, N = 100, 5
        A, B = make_spd_pencil(n, seed=1)
        factor = make_shift_factor(A, B, 0.0)
        res = lanczos_solve(DenseOperator(A), DenseOperator(B), factor,
                            0.0, N, m=50)
        resid = A @ res.Phi - (B @ res.Phi) * res.lam[None, :]
        rel = jnp.linalg.norm(resid, axis=0) / res.lam
        assert float(rel.max()) < 1e-8

    def test_b_orthonormality(self):
        n, N = 80, 6
        A, B = make_spd_pencil(n, seed=2)
        factor = make_shift_factor(A, B, 0.0)
        res = lanczos_solve(DenseOperator(A), DenseOperator(B), factor,
                            0.0, N, m=50)
        gram = res.Phi.T @ (B @ res.Phi)
        np.testing.assert_allclose(np.asarray(gram), np.eye(N), atol=1e-10)

    def test_eig_res_reports_convergence(self):
        n, N = 80, 4
        A, B = make_spd_pencil(n, seed=3)
        factor = make_shift_factor(A, B, 0.0)
        res = lanczos_solve(DenseOperator(A), DenseOperator(B), factor,
                            0.0, N, m=50)
        assert float(res.eig_res.max()) < 1e-10

    def test_jit_compiles(self):
        n, N = 60, 4
        A, B = make_spd_pencil(n, seed=4)

        @jax.jit
        def run(A, B):
            factor = make_shift_factor(A, B, 0.0)
            res = lanczos_solve(DenseOperator(A), DenseOperator(B), factor,
                                0.0, N, m=40)
            return res.lam

        lam = run(A, B)
        lam2 = run(A + 0.0, B)
        np.testing.assert_allclose(np.asarray(lam), np.asarray(lam2))

    def test_nonzero_sigma(self):
        n, N = 100, 6
        A, B = make_spd_pencil(n, seed=5)
        import scipy.linalg

        lam_ref = scipy.linalg.eigh(np.asarray(A), np.asarray(B),
                                    eigvals_only=True)
        sigma = 0.9 * lam_ref[0]
        factor = make_shift_factor(A, B, sigma)
        res = lanczos_solve(DenseOperator(A), DenseOperator(B), factor,
                            sigma, N, m=60)
        np.testing.assert_allclose(np.asarray(res.lam), lam_ref[:N],
                                   rtol=1e-10)


class TestLanczosBucklingMode:
    def test_buckling_eigenvalues(self):
        """(G, K) pencil sorted by -1/lam, buckling spectral transform."""
        n, N = 90, 4
        rng = np.random.default_rng(7)
        K = rng.standard_normal((n, n))
        K = K @ K.T + n * np.eye(n)
        G = rng.standard_normal((n, n))
        G = -(G @ G.T) - 0.5 * np.eye(n)  # negative definite stress stiffness
        K_j, G_j = jnp.asarray(K), jnp.asarray(G)

        # Pencil eigenproblem G phi = mu K phi with mu < 0; the buckling load
        # factors are lam = -1/mu and the solver returns them sorted by
        # argsort(mu) (the reference's argsort(-1/lam), :1437).
        import scipy.linalg

        mu_ref = scipy.linalg.eigh(G, K, eigvals_only=True)
        order = np.argsort(mu_ref)
        lam_want = (-1.0 / mu_ref[order])[:N]

        # Shift just below the first critical load so shift-invert targets it.
        sigma = 0.9 * lam_want[0]
        factor = make_shift_factor(G_j, K_j, sigma, mode="buckling",
                                   kind="cholesky")
        res = lanczos_solve(DenseOperator(G_j), DenseOperator(K_j), factor,
                            sigma, N, m=60, mode="buckling")
        np.testing.assert_allclose(np.asarray(res.lam), lam_want, rtol=1e-8)

        # Eigenvectors satisfy K phi + lam G phi = 0
        resid = K @ np.asarray(res.Phi) + np.asarray(G_j) @ np.asarray(
            res.Phi) * np.asarray(res.lam)[None, :]
        rel = np.linalg.norm(resid, axis=0)
        assert rel.max() < 1e-6


class TestBasicLanczosClass:
    def test_solve_api(self):
        n, N = 80, 5
        A, B = make_spd_pencil(n, seed=8)
        factor = make_shift_factor(A, B, 0.0)
        solver = BasicLanczos(N=N, m=50)
        lam, Phi = solver.solve(A, B, factor, 0.0)
        assert lam.shape == (N,)
        assert Phi.shape == (n, N)
        assert not solver.fail

    def test_ntarget_expands_on_repeated(self):
        # Matrix with an exactly repeated eigenvalue straddling N
        n = 50
        rng = np.random.default_rng(9)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        w = np.arange(1.0, n + 1.0)
        w[2] = w[3]  # repeated pair at positions 2, 3
        A = jnp.asarray(Q @ np.diag(w) @ Q.T)
        B = jnp.eye(n)
        factor = make_shift_factor(A, B, 0.0)
        solver = BasicLanczos(Ntarget=3, m=40)
        lam, Phi = solver.solve(A, B, factor, 0.0)
        # N must have grown past the repeated pair
        assert solver.N == 4

    def test_oracle_matches(self):
        n, N = 70, 5
        A, B = make_spd_pencil(n, seed=10)
        lam_o, phi_o = eigh_gen_oracle(A, B, N)
        factor = make_shift_factor(A, B, 0.0)
        res = lanczos_solve(DenseOperator(A), DenseOperator(B), factor,
                            0.0, N, m=50)
        np.testing.assert_allclose(np.asarray(res.lam), np.asarray(lam_o),
                                   rtol=1e-10)


class TestThickRestartIRAM:
    def test_restarted_matches_dense(self):
        """Memory-bounded solve: m = 22 basis vectors with restarts must
        reach the same eigenpairs as the dense oracle."""
        from eigd_tpu.ops.restart import IRAM

        n, N = 150, 5
        A, B = make_spd_pencil(n, seed=11)
        factor = make_shift_factor(A, B, 0.0)
        solver = IRAM(N=N, m=22, ncycle=6)
        lam, Phi = solver.solve(A, B, factor, 0.0)
        import scipy.linalg

        lam_ref = scipy.linalg.eigh(np.asarray(A), np.asarray(B),
                                    eigvals_only=True)[:N]
        np.testing.assert_allclose(np.asarray(lam), lam_ref, rtol=1e-9)
        assert float(solver.eig_res.max()) < 1e-7

    def test_restarted_adjoint_residual(self):
        from eigd_tpu.ops.restart import IRAM

        n, N = 120, 4
        A, B = make_spd_pencil(n, seed=12)
        factor = make_shift_factor(A, B, 0.0)
        solver = IRAM(N=N, m=20, ncycle=6)
        solver.solve(A, B, factor, 0.0)
        rng = np.random.default_rng(13)
        Phib = jnp.asarray(rng.standard_normal((n, N)))
        psi, data = solver.solve_adjoint(Phib, method="sibk", rtol=1e-12)
        res, ortho = solver.eval_adjoint_residual_norm(Phib, psi,
                                                       b_ortho=True)
        scale = float(jnp.sqrt(jnp.max(jnp.sum(Phib**2, axis=0))))
        assert float(jnp.max(res)) / scale < 1e-8

    def test_dl_rejected(self):
        from eigd_tpu.ops.restart import IRAM

        n, N = 60, 3
        A, B = make_spd_pencil(n, seed=14)
        factor = make_shift_factor(A, B, 0.0)
        solver = IRAM(N=N, m=20, ncycle=3)
        solver.solve(A, B, factor, 0.0)
        with pytest.raises(ValueError):
            solver.solve_adjoint(jnp.zeros((n, N)), method="dl")

    def test_adaptive_cycle_count(self):
        """The restart loop must exit on measured convergence, not run the
        full static cycle budget (VERDICT r1 §6; reference ARPACK's
        iterate-until-converged loop, arpack.py:438-442)."""
        from eigd_tpu.ops.restart import IRAM

        n, N = 120, 4
        A, B = make_spd_pencil(n, seed=21)
        factor = make_shift_factor(A, B, 0.0)
        solver = IRAM(N=N, m=30, ncycle=40)
        lam, _ = solver.solve(A, B, factor, 0.0)
        k = min(2 * N, 30 - 2)
        budget = 30 + 39 * (30 - k)
        assert solver.niter < budget, (solver.niter, budget)
        assert float(solver.eig_res.max()) < 1e-9
        import scipy.linalg

        lam_ref = scipy.linalg.eigh(np.asarray(A), np.asarray(B),
                                    eigvals_only=True)[:N]
        np.testing.assert_allclose(np.asarray(lam), lam_ref, rtol=1e-9)

    def test_buckling_restart_retention(self):
        """Buckling-mode thick restart: retention must follow the -1/lam
        buckling sort; the restarted solve reaches the same buckling load
        factors as the dense oracle."""
        from eigd_tpu.ops.restart import thick_restart_solve

        n, N = 90, 3
        rng = np.random.default_rng(22)
        K = rng.standard_normal((n, n))
        K = K @ K.T + n * np.eye(n)
        G = rng.standard_normal((n, n))
        G = -(G @ G.T) - 0.5 * np.eye(n)
        K_j, G_j = jnp.asarray(K), jnp.asarray(G)
        import scipy.linalg

        mu_ref = scipy.linalg.eigh(G, K, eigvals_only=True)
        lam_want = (-1.0 / mu_ref[np.argsort(mu_ref)])[:N]
        sigma = 0.9 * lam_want[0]
        factor = make_shift_factor(G_j, K_j, sigma, mode="buckling")
        res = thick_restart_solve(DenseOperator(G_j), DenseOperator(K_j),
                                  factor, sigma, N, m=24, ncycle=12,
                                  mode="buckling", tol=1e-13)
        np.testing.assert_allclose(np.asarray(res.lam), lam_want, rtol=1e-8)

    def test_breakdown_guard_invariant_subspace(self):
        """Krylov space that spans an invariant subspace after < m steps:
        the b = 0 breakdown must freeze instead of producing NaNs."""
        from eigd_tpu.ops.restart import thick_restart_solve

        n, N = 40, 3
        # A with only 5 distinct eigenvalues: Krylov breaks down at step ~5
        rng = np.random.default_rng(23)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        w = np.repeat(np.array([1.0, 2.0, 3.0, 4.0, 5.0]), 8)
        A = jnp.asarray(Q @ np.diag(w) @ Q.T)
        B = jnp.eye(n)
        factor = make_shift_factor(A, B, 0.0)
        res = thick_restart_solve(DenseOperator(A), DenseOperator(B),
                                  factor, 0.0, N, m=16, ncycle=4,
                                  mode="normal", tol=1e-12)
        lam = np.asarray(res.lam)
        assert np.all(np.isfinite(lam))
        # every returned pair must be a converged eigenpair of the
        # degenerate spectrum {1..5} (restart re-seeding may legitimately
        # return several copies of the multiplicity-8 eigenvalue 1)
        assert float(np.max(np.asarray(res.eig_res))) < 1e-9
        dist = np.min(np.abs(lam[:, None]
                             - np.array([1.0, 2.0, 3.0, 4.0, 5.0])[None, :]),
                      axis=1)
        assert dist.max() < 1e-8, lam


class TestCayley:
    def test_cayley_mode_matches_dense(self):
        """Cayley spectral transform (ARPACK mode 5, reference
        arpack.py:404-416): same eigenpairs as the normal map."""
        import scipy.linalg

        from eigd_tpu.ops.factor import make_shift_factor
        from eigd_tpu.ops.lanczos import BasicLanczos

        n, N = 50, 5
        rng = np.random.default_rng(3)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        w = np.linspace(1.0, 80.0, n)
        A = jnp.asarray(Q @ np.diag(w) @ Q.T)
        Bm = rng.standard_normal((n, n)) * 0.1
        B = jnp.asarray(np.eye(n) + Bm @ Bm.T)
        sigma = 0.5
        factor = make_shift_factor(A, B, sigma)
        solver = BasicLanczos(N=N, m=40, mode="cayley")
        lam, Phi = solver.solve(A, B, factor, sigma)
        lam_ref = scipy.linalg.eigh(np.asarray(A), np.asarray(B),
                                    eigvals_only=True)[:N]
        np.testing.assert_allclose(np.asarray(lam), lam_ref, rtol=1e-9)
        # adjoint dispatch must refuse cayley
        with pytest.raises(ValueError):
            solver.solve_adjoint(jnp.zeros((n, N)))


class TestNonConvergence:
    def test_warns_on_non_convergence(self):
        """A starved iteration budget must be *surfaced*, not ignored
        (reference fail flag + eig_res, :1639-1645; VERDICT A3)."""
        import warnings as _w

        from eigd_tpu.ops.factor import make_shift_factor
        from eigd_tpu.ops.lanczos import BasicLanczos

        n, N = 60, 8
        rng = np.random.default_rng(4)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        w = np.linspace(1.0, 2.0, n)  # clustered spectrum: slow convergence
        A = jnp.asarray(Q @ np.diag(w) @ Q.T)
        B = jnp.eye(n)
        factor = make_shift_factor(A, B, 0.0)
        solver = BasicLanczos(N=N, m=10, tol=1e-14)
        with pytest.warns(UserWarning, match="did not converge"):
            solver.solve(A, B, factor, 0.0)
        assert solver.fail
        assert np.any(solver.eig_res > 1e-14)


class TestBlockLanczos:
    def test_block_matches_dense(self):
        """Block shift-invert Lanczos (p vectors per factor apply) matches
        the dense oracle and the single-vector path."""
        import scipy.linalg

        from eigd_tpu.ops.factor import make_shift_factor
        from eigd_tpu.ops.lanczos import block_lanczos_solve

        n, N, p = 60, 5, 4
        rng = np.random.default_rng(7)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        w = np.concatenate([np.linspace(1.0, 6.0, 8),
                            np.linspace(20.0, 90.0, n - 8)])
        A = jnp.asarray(Q @ np.diag(w) @ Q.T)
        B = jnp.eye(n)
        factor = make_shift_factor(A, B, 0.0)
        res = block_lanczos_solve(A, B, factor, 0.0, N, 40, p)
        lam_ref = scipy.linalg.eigh(np.asarray(A), eigvals_only=True)[:N]
        np.testing.assert_allclose(np.asarray(res.lam), lam_ref, rtol=1e-10)
        assert float(jnp.max(res.eig_res)) < 1e-8

    def test_block_adaptive_exit(self):
        from eigd_tpu.ops.factor import make_shift_factor
        from eigd_tpu.ops.lanczos import block_lanczos_solve

        n, N, p = 80, 4, 4
        rng = np.random.default_rng(8)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        w = np.concatenate([np.arange(1.0, 9.0), np.linspace(60, 200, n - 8)])
        A = jnp.asarray(Q @ np.diag(w) @ Q.T)
        B = jnp.eye(n)
        factor = make_shift_factor(A, B, 0.0)
        res = block_lanczos_solve(A, B, factor, 0.0, N, 72, p, tol=1e-10)
        assert int(res.niter) < 72  # exited early
        assert float(jnp.max(res.eig_res)) < 1e-8


class TestRitzPolish:
    """polish_ritz_block: shift-invert subspace-iteration refinement of the
    selected Ritz block (the f32-sweep basis-noise correction; see the docstring
    in ops/lanczos.py). On an exact-f64 backend it must be a numerical
    no-op on converged pairs — and it must strictly reduce the true pencil
    residual of artificially perturbed eigenvectors."""

    def _pencil(self, n=80, seed=11):
        rng = np.random.default_rng(seed)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        w = np.concatenate([np.arange(1.0, 9.0),
                            np.linspace(50.0, 300.0, n - 8)])
        A = jnp.asarray(Q @ np.diag(w) @ Q.T)
        M = rng.standard_normal((n, n)) * 0.1
        B = jnp.asarray(np.eye(n) + M @ M.T)
        return A, B

    def test_polish_is_noop_on_converged_pairs(self):
        from eigd_tpu.ops.factor import make_shift_factor
        from eigd_tpu.ops.lanczos import block_lanczos_solve

        A, B = self._pencil()
        factor = make_shift_factor(A, B, 0.0)
        r0 = block_lanczos_solve(A, B, factor, 0.0, 4, 48, 4)
        r1 = block_lanczos_solve(A, B, factor, 0.0, 4, 48, 4, polish=1)
        np.testing.assert_allclose(np.asarray(r1.lam), np.asarray(r0.lam),
                                   rtol=1e-11)
        # subspace alignment (columns may flip sign)
        mac = np.abs(np.asarray(r0.Phi).T @ np.asarray(B) @ np.asarray(r1.Phi))
        np.testing.assert_allclose(np.diag(mac), 1.0, atol=1e-9)

    def test_polish_reduces_injected_noise(self):
        from eigd_tpu.ops.factor import make_shift_factor
        from eigd_tpu.ops.lanczos import polish_ritz_block
        import scipy.linalg

        A, B = self._pencil()
        lam_ref, Phi_ref = scipy.linalg.eigh(np.asarray(A), np.asarray(B))
        N = 4
        rng = np.random.default_rng(3)
        # Noise restricted to the high end of the spectrum — the basis noise
        # model (f32-sweep and measurement error lands in directions far
        # from the shift, where the shift-invert gain is tiny).
        hi = Phi_ref[:, 20:]
        noise = 1e-4 * (hi @ rng.standard_normal((hi.shape[1], N)))
        Phi0 = jnp.asarray(Phi_ref[:, :N] + noise)
        factor = make_shift_factor(A, B, 0.0)

        def rel_res(lam, Phi):
            R = np.asarray(A @ Phi) - np.asarray(B @ Phi) * np.asarray(lam)
            return (np.linalg.norm(R, axis=0)
                    / np.linalg.norm(np.asarray(A @ Phi), axis=0))

        rn0 = rel_res(lam_ref[:N], Phi0)
        lam, Phi, _ = polish_ritz_block(A, B, factor,
                                        jnp.asarray(lam_ref[:N]),
                                     Phi0, 0.0, "normal")
        rn1 = rel_res(lam, Phi)
        lam2, Phi2, res2 = polish_ritz_block(A, B, factor,
                                             jnp.asarray(lam_ref[:N]), Phi0,
                                             0.0, "normal", nsteps=2)
        # the returned eig_res is the MEASURED pencil residual
        R2 = np.asarray(A @ Phi2) - np.asarray(B @ Phi2) * np.asarray(lam2)
        np.testing.assert_allclose(np.asarray(res2),
                                   np.linalg.norm(R2, axis=0),
                                   rtol=1e-6, atol=1e-14)
        rn2 = rel_res(lam2, Phi2)
        # per-step damping = the shift-invert gain ratio
        # max(lam_sel - sigma)/min(lam_noise - sigma) ~ 4/50 here; steps
        # compound
        assert np.all(rn1 < 0.1 * rn0), (rn1, rn0)
        assert np.all(rn2 < 0.1 * rn1), (rn2, rn1)
        # Rayleigh quotients are quadratically accurate in the residual
        np.testing.assert_allclose(np.asarray(lam), lam_ref[:N], rtol=1e-7)
        np.testing.assert_allclose(np.asarray(lam2), lam_ref[:N], rtol=1e-10)

    def test_polish_buckling_ordering(self):
        from eigd_tpu.ops.factor import make_shift_factor
        from eigd_tpu.ops.lanczos import block_lanczos_solve

        # buckling-mode pencil (A, B) = (G, K): BLF lam = -1/mu
        n = 60
        rng = np.random.default_rng(5)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        mu = -1.0 / np.linspace(1.0, 30.0, n)  # BLFs 1..30
        K = np.eye(n)
        G = Q @ np.diag(mu) @ Q.T
        sigma = 0.9
        factor = make_shift_factor(jnp.asarray(G), jnp.asarray(K), sigma,
                                   mode="buckling")
        r0 = block_lanczos_solve(jnp.asarray(G), jnp.asarray(K), factor,
                                 sigma, 4, 40, 4, mode="buckling")
        r1 = block_lanczos_solve(jnp.asarray(G), jnp.asarray(K), factor,
                                 sigma, 4, 40, 4, mode="buckling", polish=1)
        np.testing.assert_allclose(np.asarray(r1.lam), np.asarray(r0.lam),
                                   rtol=1e-10)
        np.testing.assert_allclose(np.asarray(r1.lam),
                                   np.linspace(1.0, 30.0, n)[:4], rtol=1e-9)


class TestApproxSweep:
    """sweep='approx': the forward block-Lanczos sweep driven by
    factor.approx_mv (preconditioner-quality f32 solves), with accuracy
    recovered by the Ritz polish — the forward analog of the adjoint's
    mixed ladder (see block_lanczos_solve docstring). Eigenvalues must
    match the exact-sweep path; the end-to-end gradient is exact for the
    approx-swept objective (the custom VJP differentiates whatever the
    forward computed), so FD agrees once h is large enough that the
    solver's ~1e-6 objective-noise floor doesn't swamp the quotient."""

    def test_matches_exact_sweep_and_fd(self):
        from eigd_tpu.models.natural_frequency import make_model

        # smallest config that still exercises the approx sweep + polish
        # recovery (block degree m/p = 12 >= 2N+2 spare): suite-hygiene
        # shrink from 16x8/m=64 (171 s -> ~60 s on the 1-core CI host)
        kw = dict(nx=12, ny=6, N=3, m=48, Lx=2.0, Ly=1.0, rfact=2.0,
                  factor_kind="mg", lanczos_block=4, lanczos_ortho="local",
                  factor_options={"min_coarse": 64})
        topo_e = make_model(lanczos_tol=1e-11, lanczos_polish=1, **kw)
        topo_a = make_model(lanczos_tol=1e-6, lanczos_polish=2,
                            lanczos_sweep="approx", **kw)
        x0 = jnp.asarray(topo_e.x)
        lam_e = np.asarray(topo_e._solve_fn(x0)[0])
        lam_a = np.asarray(topo_a._solve_fn(x0)[0])
        np.testing.assert_allclose(lam_a, lam_e, rtol=1e-9)

        def f(x):
            lam, Q, rho, rhoE = topo_a._solve_fn(x)
            return jnp.sum(jnp.sqrt(lam)) + jnp.sum(Q[:6, :] ** 2)

        g = jax.grad(f)(x0)
        p = jnp.asarray(np.random.default_rng(3).uniform(size=x0.shape))
        h = 1e-2  # must dominate the approx-sweep objective-noise floor
        fd = (f(x0 + h * p) - f(x0 - h * p)) / (2 * h)
        rel = abs(float(p @ g) - float(fd)) / abs(float(fd))
        assert rel < 5e-4, rel


class TestPrecondLadder:
    def test_sibk_precond_ladder_gradient(self):
        """adjoint_options ladder='precond': the mixed sibk ladder advances
        on ONE raw V-cycle per step (factor.precond_mv) instead of an f32
        PCG solve; outer rounds restart on true f64 residuals, so the
        gradient stays exact — only steps-per-round changes."""
        from eigd_tpu.models.natural_frequency import make_model

        from eigd_tpu.fem import assembly as fem
        from eigd_tpu.models.natural_frequency import make_model
        from eigd_tpu.ops import adjoint as adj
        from eigd_tpu.ops.autodiff import _forward_ops

        topo = make_model(nx=12, ny=6, N=3, m=48, Lx=2.0, Ly=1.0, rfact=2.0,
                          factor_kind="mg", lanczos_block=4,
                          lanczos_ortho="local",
                          factor_options={"min_coarse": 64},
                          lanczos_tol=1e-11, lanczos_polish=1)
        rhoE = fem.element_density(topo.fltr.apply(jnp.asarray(topo.x)),
                                   topo.conn)
        A, B = topo._assemble(rhoE)
        lam, Phi, (res, factor) = _forward_ops(rhoE, topo.problem, A, B,
                                               topo.cfg)
        Phib = jnp.asarray(
            np.random.default_rng(0).standard_normal(Phi.shape))
        psi0 = adj.laa(Phib, B, factor, res, b_ortho=True, approx=True)
        psis = {}
        for ladder in ("approx", "precond"):
            psi, _, info = adj.sibk(Phib, A, B, lam, Phi, psi=psi0,
                                    sigma=topo.cfg.sigma, factor=factor,
                                    rtol=1e-12, maxiter=60, nrestart=8,
                                    mixed=True, ladder=ladder)
            assert np.all(np.asarray(info["res"]) < 1e-9), (ladder,
                                                            info["res"])
            psis[ladder] = np.asarray(psi)
        rel = (np.abs(psis["precond"] - psis["approx"]).max()
               / np.abs(psis["approx"]).max())
        assert rel < 1e-8, rel


class TestStagedValueAndGrad:
    def test_matches_fused_path(self):
        """staged_value_and_grad (two-program execution, the 1M-DOF
        fused-program workaround) is bit-compatible with
        jit(value_and_grad) of the same objective."""
        import jax

        from eigd_tpu.fem import assembly as fem
        from eigd_tpu.models.natural_frequency import make_model
        from eigd_tpu.ops.autodiff import staged_value_and_grad

        topo = make_model(nx=16, ny=8, N=4, m=64, factor_kind="mg",
                          lanczos_block=4, lanczos_ortho="local",
                          lanczos_polish=1)
        x0 = jnp.asarray(topo.x)

        def pre(x):
            rho = topo.fltr.apply(x)
            return fem.element_density(rho, topo.conn)

        def tail(lam, Phi):
            eta = jnp.exp(-2.0 * (lam - lam[0]))
            return (jnp.sum(jnp.sqrt(lam))
                    + jnp.sum(eta[None, :] * Phi[:8, :] ** 2))

        def objective(x):
            lam, Q, rho, rhoE = topo._solve_fn(x)
            return tail(lam, Q)

        v_f, g_f = jax.jit(jax.value_and_grad(objective))(x0)
        staged = staged_value_and_grad(pre, tail, topo.problem, topo.cfg)
        v_s, g_s = staged(x0)
        assert abs(float(v_s) - float(v_f)) < 1e-12 * abs(float(v_f))
        np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_f),
                                   rtol=1e-9, atol=1e-14)


class TestChunkedForward:
    """chunk_forward dispatches the block Lanczos sweep a few steps per
    program (short device executions); must reproduce the fused sweep."""

    def _problem(self):
        from eigd_tpu import DenseOperator
        from eigd_tpu.ops.autodiff import EigProblem

        n = 120
        rng = np.random.default_rng(5)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        w = np.concatenate([np.arange(1.0, 9.0),
                            np.linspace(60.0, 200.0, n - 8)])
        A0 = jnp.asarray(Q @ np.diag(w) @ Q.T)
        B0 = jnp.eye(n)

        def assemble(theta):
            return (DenseOperator(A0 + jnp.diag(theta)),
                    DenseOperator(B0 + 0.01 * jnp.diag(theta)))

        return EigProblem(assemble=assemble), n

    @pytest.mark.parametrize("polish,spare,tol", [
        (0, 0, None), (2, 2, None), (1, 0, 1e-12)])
    def test_matches_fused_solve(self, polish, spare, tol):
        from eigd_tpu.ops.autodiff import EighGenConfig, staged_eigh_gen_vjp

        problem, n = self._problem()
        cfg = EighGenConfig(N=4, m=48, sigma=0.0, block=4, polish=polish,
                            polish_spare=spare, lanczos_tol=tol)
        theta = jnp.asarray(0.1 * np.random.default_rng(2).uniform(size=n))
        fwd_f, _ = staged_eigh_gen_vjp(problem, cfg, split_factor=True)
        fwd_c, _ = staged_eigh_gen_vjp(problem, cfg, chunk_forward=3)
        res_f = fwd_f(theta)
        res_c = fwd_c(theta)
        if tol is None:
            # full sweep: identical math, bit-level parity expected
            np.testing.assert_array_equal(np.asarray(res_f.lam),
                                          np.asarray(res_c.lam))
            np.testing.assert_array_equal(np.asarray(res_f.Phi),
                                          np.asarray(res_c.Phi))
        else:
            # adaptive exit: the host check runs at chunk boundaries (every
            # 3 blocks) vs the fused check's every block — exit steps may
            # differ; converged QUANTITIES must agree
            np.testing.assert_allclose(np.asarray(res_f.lam),
                                       np.asarray(res_c.lam), rtol=1e-9)
            Pf = np.asarray(res_f.Phi)
            Pc = np.asarray(res_c.Phi)
            mac = np.abs(np.sum(Pf * Pc, axis=0)) / (
                np.linalg.norm(Pf, axis=0) * np.linalg.norm(Pc, axis=0))
            np.testing.assert_allclose(mac, np.ones(4), atol=1e-6)

    def test_chunked_gradient_matches(self):
        """End-to-end chunked fwd + chunked bwd gradient vs the fused
        staged pair."""
        from eigd_tpu.ops.autodiff import EighGenConfig, staged_eigh_gen_vjp

        problem, n = self._problem()
        cfg = EighGenConfig(N=4, m=48, sigma=0.0, block=4, polish=1,
                            adjoint_method="sibk", adjoint_rtol=1e-11,
                            nrestart=3)
        theta = jnp.asarray(0.1 * np.random.default_rng(3).uniform(size=n))
        rng = np.random.default_rng(4)
        lam_bar = jnp.asarray(rng.standard_normal(4))
        Phi_bar = jnp.asarray(rng.standard_normal((n, 4)))
        fwd_f, bwd_f = staged_eigh_gen_vjp(problem, cfg, split_factor=True)
        fwd_c, bwd_c = staged_eigh_gen_vjp(problem, cfg, chunk_forward=2,
                                           chunk_adjoint=True)
        g_f = bwd_f(theta, fwd_f(theta), lam_bar, Phi_bar)
        g_c = bwd_c(theta, fwd_c(theta), lam_bar, Phi_bar)
        scale = float(jnp.max(jnp.abs(g_f)))
        np.testing.assert_allclose(np.asarray(g_c), np.asarray(g_f),
                                   atol=1e-10 * scale)


class TestMeasuredResidual:
    """VERDICT r2 item 7: under ortho='local' + sweep='approx' the block
    coupling bound measures convergence to the INEXACTLY applied operator
    and can understate the true pencil residual by orders; measure_res=True
    records the true residual in eig_res_measured."""

    def _setup(self, n=96, seed=0):
        from eigd_tpu.ops.factor import make_shift_factor

        rng = np.random.default_rng(seed)
        Qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
        w = np.concatenate([np.linspace(1.0, 6.0, 8),
                            np.linspace(40.0, 200.0, n - 8)])
        A = jnp.asarray(Qm @ np.diag(w) @ Qm.T)
        B = jnp.eye(n)
        sigma = -1.0
        exact = make_shift_factor(A, B, sigma, mode="normal",
                                  kind="cholesky")
        E = rng.standard_normal((n, n)) * 1e-4
        E = jnp.asarray(0.5 * (E + E.T))

        class InexactFactor:
            """Exact .mv; .approx_mv = a LINEAR inexact apply (exact + fixed
            symmetric perturbation), modelling a preconditioner-quality
            solve the sweep converges cleanly against."""

            def mv(self, x):
                return exact.mv(x)

            def approx_mv(self, x):
                return exact.mv(x) + E @ x

        return A, B, sigma, InexactFactor()

    def test_bound_understates_measurement_catches(self):
        from eigd_tpu.ops.lanczos import block_lanczos_solve

        A, B, sigma, factor = self._setup()
        res = block_lanczos_solve(A, B, factor, sigma, N=4, m=64, p=4,
                                  ortho="local", sweep="approx",
                                  polish=0, measure_res=True)
        bound = np.asarray(res.eig_res)
        measured = np.asarray(res.eig_res_measured)
        # the sweep converges against the inexact operator: tiny bound
        assert bound.max() < 1e-6, bound
        # but the true pencil residual floors at the apply inexactness
        assert measured.max() > 50 * bound.max(), (bound, measured)
        # and the measurement is the real thing
        direct = np.linalg.norm(
            np.asarray(A) @ np.asarray(res.Phi)
            - np.asarray(B) @ np.asarray(res.Phi)
            * np.asarray(res.lam)[None, :], axis=0)
        np.testing.assert_allclose(measured, direct, rtol=1e-10)

    def test_polish_records_measured(self):
        from eigd_tpu.ops.lanczos import block_lanczos_solve

        A, B, sigma, factor = self._setup()
        res = block_lanczos_solve(A, B, factor, sigma, N=4, m=64, p=4,
                                  ortho="local", sweep="approx",
                                  polish=1)
        assert res.eig_res_measured is not None
        np.testing.assert_array_equal(np.asarray(res.eig_res_measured),
                                      np.asarray(res.eig_res))
