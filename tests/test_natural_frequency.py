"""End-to-end natural-frequency model tests (reference acceptance: FD
verification of the full filter -> assembly -> eigensolve -> KS chain,
natural_frequency.py test_ks_func)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eigd_tpu.models.natural_frequency import make_model, MinFreqOpt


@pytest.fixture(scope="module")
def topo():
    return make_model(nx=16, ny=8, Lx=2.0, Ly=1.0, N=6, rfact=2.0)


class TestTopologyAnalysis:
    def test_rigid_modes_discarded(self, topo):
        topo.initialize()
        lam = np.asarray(topo.lam)
        # flexible modes must be well above the (discarded) rigid modes
        assert lam[0] > 1e-2
        assert np.all(np.diff(lam) > -1e-12)

    def test_frequencies(self, topo):
        topo.initialize()
        omega = np.asarray(topo.get_frequencies())
        np.testing.assert_allclose(omega, np.sqrt(np.asarray(topo.lam)))

    def test_frequency_gradient_fd(self, topo):
        """Gradient of a frequency sum through the full chain vs FD."""
        topo.initialize()
        topo.initialize_adjoint()
        omegab = jnp.ones(topo.N)
        topo.add_frequency_derivatives(omegab)
        topo.finalize_adjoint()

        rng = np.random.default_rng(0)
        pert = jnp.asarray(rng.uniform(size=np.asarray(topo.x).shape))
        ans = float(pert @ topo.xb)

        x0 = jnp.asarray(topo.x)
        h = 1e-6

        def total(x):
            topo.x = x
            topo.initialize()
            return float(jnp.sum(topo.get_frequencies()))

        fp = total(x0 + h * pert)
        fm = total(x0 - h * pert)
        topo.x = x0
        fd = (fp - fm) / (2 * h)
        rel = abs(ans - fd) / abs(fd)
        assert rel < 5e-7, (ans, fd, rel)

    def test_area_gradient_fd(self, topo):
        topo.x = jnp.asarray(topo.x)
        topo.initialize()
        g = topo.eval_area_gradient()
        rng = np.random.default_rng(1)
        pert = jnp.asarray(rng.uniform(size=np.asarray(topo.x).shape))
        h = 1e-6
        x0 = topo.x

        def area(x):
            topo.x = x
            topo.initialize()
            return float(topo.eval_area())

        fd = (area(x0 + h * pert) - area(x0 - h * pert)) / (2 * h)
        topo.x = x0
        rel = abs(float(pert @ g) - fd) / abs(fd)
        assert rel < 1e-7


class TestMinFreqOpt:
    def test_ks_func_fd(self):
        np.random.seed(0)
        topo = make_model(nx=16, ny=8, Lx=2.0, Ly=1.0, N=6, rfact=2.0)
        opt = MinFreqOpt(topo)
        data = opt.test_ks_func(dh_fd=1e-6)
        assert data["fd_err"] < 1e-6, data


class TestBlockTridiagPath:
    def test_matches_dense_path_and_fd(self):
        """Scalable factor path (matrix-free + block-tridiag Cholesky) must
        reproduce the dense-factor results and pass the FD check."""
        topo_d = make_model(nx=12, ny=6, Lx=2.0, Ly=1.0, N=4, rfact=2.0)
        topo_b = make_model(nx=12, ny=6, Lx=2.0, Ly=1.0, N=4, rfact=2.0,
                            factor_kind="blocktridiag")
        topo_d.initialize()
        topo_b.initialize()
        np.testing.assert_allclose(np.asarray(topo_b.lam),
                                   np.asarray(topo_d.lam), rtol=1e-9)

        topo_b.initialize_adjoint()
        topo_b.add_frequency_derivatives(jnp.ones(topo_b.N))
        topo_b.finalize_adjoint()
        rng = np.random.default_rng(5)
        x0 = jnp.asarray(topo_b.x)
        pert = jnp.asarray(rng.uniform(size=np.asarray(x0).shape))
        h = 1e-6

        def total(x):
            topo_b.x = x
            topo_b.initialize()
            return float(jnp.sum(topo_b.get_frequencies()))

        fd = (total(x0 + h * pert) - total(x0 - h * pert)) / (2 * h)
        topo_b.x = x0
        rel = abs(float(pert @ topo_b.xb) - fd) / abs(fd)
        assert rel < 5e-7, rel


class TestBlockDegreeWarning:
    """The block-q convergence warning (VERDICT r4 item 7): the blessed
    bench configuration (block 16, q=11, polish=3 — oracle-verified at
    jvp_rel 1.5e-9 on the H100) must construct warning-free, while a genuinely
    marginal configuration must still warn."""

    def test_blessed_config_is_warning_clean(self):
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("error")
            make_model(nx=16, ny=8, Lx=2.0, Ly=1.0, N=6, rfact=2.0,
                       m=176, lanczos_block=16, lanczos_polish=3,
                       lanczos_sweep="approx")

    def test_marginal_config_warns(self):
        with pytest.warns(UserWarning, match="block steps"):
            make_model(nx=16, ny=8, Lx=2.0, Ly=1.0, N=6, rfact=2.0,
                       m=80, lanczos_block=16, lanczos_polish=0)
