"""Multi-device tests on the virtual 8-device CPU mesh (the stand-in for
multi-card testing, SURVEY.md §4): halo-exchange matvec, Schwarz-PCG factor,
and serial-vs-sharded gradient parity through the full eigensolve+adjoint."""

from functools import partial

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from eigd_tpu.fem import assembly as fem
from eigd_tpu.fem.model import make_grid
from eigd_tpu.fem.quad import plane_stress_tables
from eigd_tpu.ops.operators import ElementOperator
from eigd_tpu.parallel import make_mesh
from eigd_tpu.parallel.grid import (element_gather_index, local_dof_map,
                                    make_partition, pad_line_mask)
from eigd_tpu.parallel.sharded import (
    GridHaloOperator,
    SchwarzPCGFactor,
    make_sharded_objective,
    pad_elements,
    sharded_element_matvec,
)

NDEV = 8


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= NDEV, jax.devices()
    return make_mesh(NDEV, axis="grid")


def _grid_setup(nx, ny, seed=0):
    """Common host setup: grid, tables, element matrices, partition maps."""
    grid = make_grid(nx, ny, 2.0, 1.0)
    conn = jnp.asarray(grid.conn)
    X = jnp.asarray(grid.X)
    C0 = fem.plane_stress_C0()
    dofs = fem.element_dof_map(conn)
    Be, He, detJ = plane_stress_tables(X, conn)
    rng = np.random.default_rng(seed)
    rhoE = jnp.asarray(rng.uniform(0.4, 1.0, size=conn.shape[0]))
    K = fem.stiffness_matrix(rhoE, Be, detJ, dofs, 2 * grid.nnodes, C0)
    M = fem.mass_matrix(rhoE, He, detJ, dofs, 2 * grid.nnodes)

    part = make_partition(nx, ny, NDEV, ndof=2)
    gidx = element_gather_index(part)
    gsafe = np.maximum(gidx, 0)
    real = (gidx >= 0).astype(np.float64)
    dofs_l = jnp.asarray(local_dof_map(part))
    mats_cm = {
        "K": jnp.asarray(np.asarray(K.mats)[gsafe]
                         * real[:, None, None]),
        "M": jnp.asarray(np.asarray(M.mats)[gsafe]
                         * real[:, None, None]),
    }
    return grid, K, M, part, mats_cm, dofs_l


def _to_padded(x, part):
    """Global (n,) vector -> padded concatenated-shards layout."""
    x = np.asarray(x)
    out = np.zeros(part.n_padded, dtype=x.dtype)
    b = part.line_dofs
    for line in range(part.nlines):
        d, lo = divmod(line, part.L)
        out[d * part.n_local + lo * b: d * part.n_local + (lo + 1) * b] = \
            x[line * b: (line + 1) * b]
    return jnp.asarray(out)


def _from_padded(y, part):
    y = np.asarray(y)
    out = np.zeros(part.n, dtype=y.dtype)
    b = part.line_dofs
    for line in range(part.nlines):
        d, lo = divmod(line, part.L)
        out[line * b: (line + 1) * b] = \
            y[d * part.n_local + lo * b: d * part.n_local + (lo + 1) * b]
    return out


class TestShardedOps:
    def test_sharded_matvec_matches_serial(self, mesh):
        rng = np.random.default_rng(0)
        nelems, n, d = 20, 30, 4
        mats = rng.standard_normal((nelems, d, d))
        mats = mats + mats.transpose(0, 2, 1)
        dofs = rng.integers(0, n, size=(nelems, d)).astype(np.int32)
        mats_p, dofs_p = pad_elements([jnp.asarray(mats),
                                       jnp.asarray(dofs)], NDEV)
        mv = sharded_element_matvec(mesh, "grid", mats_p, dofs_p, n)
        x = jnp.asarray(rng.standard_normal(n))
        ref = ElementOperator(jnp.asarray(mats), jnp.asarray(dofs), n).mv(x)
        np.testing.assert_allclose(np.asarray(mv(x)), np.asarray(ref),
                                   atol=1e-12)

    def test_halo_matvec_matches_serial(self, mesh):
        nx, ny = 13, 5  # deliberately not divisible by NDEV
        grid, K, M, part, mats_cm, dofs_l = _grid_setup(nx, ny)
        x = np.random.default_rng(1).standard_normal(part.n)
        xp = _to_padded(x, part)

        @partial(shard_map, mesh=mesh, in_specs=(P("grid"), P("grid")),
                 out_specs=P("grid"))
        def apply(mats_l, x_l):
            op = GridHaloOperator(mats_l, dofs_l, part, "grid")
            return op.mv(x_l)

        y = _from_padded(apply(mats_cm["K"], xp), part)
        ref = np.asarray(K.mv(jnp.asarray(x)))
        np.testing.assert_allclose(y, ref, atol=1e-10)

        # blocked rhs
        Xb = np.random.default_rng(2).standard_normal((part.n, 3))
        Xp = jnp.stack([_to_padded(Xb[:, j], part) for j in range(3)], axis=1)

        @partial(shard_map, mesh=mesh, in_specs=(P("grid"), P("grid")),
                 out_specs=P("grid"))
        def apply_blk(mats_l, x_l):
            op = GridHaloOperator(mats_l, dofs_l, part, "grid")
            return op.mv(x_l)

        Yp = np.asarray(apply_blk(mats_cm["K"], Xp))
        for j in range(3):
            np.testing.assert_allclose(
                _from_padded(Yp[:, j], part),
                np.asarray(K.mv(jnp.asarray(Xb[:, j]))), atol=1e-10)

    def test_schwarz_pcg_factor(self, mesh):
        """(K - sigma*M)^{-1} via sharded Schwarz-PCG matches a dense solve."""
        nx, ny = 11, 4
        grid, K, M, part, mats_cm, dofs_l = _grid_setup(nx, ny, seed=3)
        sigma = -10.0
        shifted_cm = mats_cm["K"] - sigma * mats_cm["M"]
        b = np.random.default_rng(4).standard_normal(part.n)
        bp = _to_padded(b, part)

        @partial(shard_map, mesh=mesh, in_specs=(P("grid"), P("grid")),
                 out_specs=P("grid"))
        def solve(mats_l, b_l):
            f = SchwarzPCGFactor.build(mats_l, dofs_l, part, "grid",
                                       maxiter=200, tol=1e-13)
            return f.mv(b_l)

        x = _from_padded(solve(shifted_cm, bp), part)
        dense = np.asarray(K.to_dense() - sigma * M.to_dense())
        ref = np.linalg.solve(dense, b)
        np.testing.assert_allclose(x, ref, rtol=1e-8, atol=1e-10)


def _serial_objective(nx, ny, N, m, sigma, qweight, fltr, grid):
    """Serial twin of make_sharded_objective's objective: ElementOperator
    assembly + dense Cholesky factor + the same physical-DOF Q aggregate."""
    from eigd_tpu.ops.autodiff import EigProblem, EighGenConfig, eigh_gen

    conn = jnp.asarray(grid.conn)
    X = jnp.asarray(grid.X)
    C0 = fem.plane_stress_C0()
    dofs = fem.element_dof_map(conn)
    Be, He, detJ = plane_stress_tables(X, conn)
    nvars = 2 * grid.nnodes
    line_dofs = 2 * (ny + 1)

    def assemble(rhoE):
        K = fem.stiffness_matrix(rhoE, Be, detJ, dofs, nvars, C0)
        M = fem.mass_matrix(rhoE, He, detJ, dofs, nvars)
        return K, M

    def factor_fn(A, B, sig, mode):
        from eigd_tpu.ops.blockfactor import (BlockTridiagFactor,
                                              grid_block_tridiag)

        shifted = A.mats - sig * B.mats
        D, E = grid_block_tridiag(shifted, nx, ny, ndof=2)
        return BlockTridiagFactor.from_blocks(D, E)

    def nullspace_fn(rhoE):
        n = nvars
        tx = jnp.zeros(n).at[0::2].set(1.0)
        ty = jnp.zeros(n).at[1::2].set(1.0)
        rot = jnp.zeros(n).at[0::2].set(-X[:, 1]).at[1::2].set(X[:, 0])
        return jnp.stack([tx, ty, rot])

    problem = EigProblem(assemble=assemble, factor=factor_fn,
                         nullspace=nullspace_fn)
    cfg = EighGenConfig(N=N, m=m, sigma=sigma, adjoint_method="sibk",
                        adjoint_maxiter=40, nrestart=2)

    line = jnp.arange(nvars) // line_dofs
    within = jnp.arange(nvars) % line_dofs
    w = jnp.sin(0.37 * line + 0.11 * within)

    def objective(x):
        rho = fltr.apply(x)
        rhoE = fem.element_density(rho, conn)
        lam, Q = eigh_gen(rhoE, problem, cfg)
        qagg = jnp.sum((w[:, None] * Q) ** 2)
        return -jnp.sum(jnp.sqrt(lam)) + qweight * qagg

    return objective


class TestGradientParityFast:
    """Default-suite (non-slow) parity tier: every sharded family's gradient
    is exercised on every `pytest tests/` run (VERDICT r2 item 4 — as
    shipped in r2, a sharded-adjoint regression would have passed CI).
    Sizes are the smallest that keep the solvers honest; the larger
    originals below stay slow-gated. Wall cost on the 1-core host is
    XLA-compile-dominated (~4-7 min cold, ~2-4 min with the persistent
    compile cache warm), not size-dominated — shrinking further buys
    nothing."""

    def test_nf_serial_vs_sharded_gradient_small(self, mesh):
        # Serial parity on the VALUE (a value-only serial compile is ~half
        # the serial value_and_grad program this test used to build — the
        # fast parity tier is XLA-compile-dominated, VERDICT r4 item 6);
        # the sharded GRADIENT is verified by central differences against
        # the same compiled sharded objective.
        nx, ny, N = 10, 4, 2
        obj_sh, fltr, mesh2, part = make_sharded_objective(
            NDEV, nx, ny, N=N, m=32, cg_maxiter=200, mesh=mesh,
            adjoint_maxiter=30)
        grid = make_grid(nx, ny, 2.0, 1.0)
        obj_se = _serial_objective(nx, ny, N, 32, -10.0, 1e-3, fltr, grid)

        x0 = 0.8 * jnp.ones(fltr.num_design_vars) + 0.1 * jnp.sin(
            jnp.arange(fltr.num_design_vars, dtype=jnp.float64))
        vag = jax.jit(jax.value_and_grad(obj_sh))
        with mesh:
            v_sh, g_sh = vag(x0)
        v_se = obj_se(x0)
        assert abs(float(v_sh) - float(v_se)) / abs(float(v_se)) < 1e-6
        pert = jnp.asarray(np.random.default_rng(7).uniform(size=x0.shape))
        h = 1e-6
        with mesh:  # FD through the SAME compiled program (no new compile)
            vp, _ = vag(x0 + h * pert)
            vm, _ = vag(x0 - h * pert)
        fd = (float(vp) - float(vm)) / (2 * h)
        ans = float(pert @ g_sh)
        assert abs(ans - fd) / abs(fd) < 1e-6, (ans, fd)

    def test_thermal_sharded_gradient_small(self, mesh):
        from eigd_tpu.parallel.sharded import make_sharded_thermal_objective

        nx, ny, N = 8, 4, 2
        obj_sh, fltr, mesh2, part = make_sharded_thermal_objective(
            NDEV, nx, ny, N=N, m=24, mesh=mesh, cg_maxiter=300,
            adjoint_maxiter=30)
        x0 = 0.8 * jnp.ones(fltr.num_design_vars) + 0.1 * jnp.sin(
            jnp.arange(fltr.num_design_vars, dtype=jnp.float64))
        vag = jax.jit(jax.value_and_grad(obj_sh))
        with mesh:
            v_sh, g_sh = vag(x0)
        pert = jnp.asarray(np.random.default_rng(7).uniform(size=x0.shape))
        h = 1e-6
        with mesh:  # FD through the SAME compiled program (no new compile)
            vp, _ = vag(x0 + h * pert)
            vm, _ = vag(x0 - h * pert)
        fd = (float(vp) - float(vm)) / (2 * h)
        ans = float(pert @ g_sh)
        assert abs(ans - fd) / abs(fd) < 1e-6, (ans, fd)

    def test_buckling_sharded_gradient_small(self, mesh):
        from eigd_tpu.parallel.sharded import make_sharded_buckling_objective

        nx, ny, N = 8, 4, 1
        obj_sh, fltr, mesh2, part = make_sharded_buckling_objective(
            NDEV, nx, ny, N=N, m=20, mesh=mesh, sigma=0.008,
            adjoint_maxiter=25, ks_rho=160.0, load_frac=0.3)
        x0 = 0.6 * jnp.ones(fltr.num_design_vars) + 0.05 * jnp.sin(
            jnp.arange(fltr.num_design_vars, dtype=jnp.float64))
        # NOTE: the buckling sharded objective caches jitted internals on
        # first trace; reusing one jitted value_and_grad wrapper for the FD
        # evals trips an UnexpectedTracerError, so this family keeps the
        # original two-program pattern.
        with mesh:
            v_sh, g_sh = jax.value_and_grad(obj_sh)(x0)
        pert = jnp.asarray(np.random.default_rng(7).uniform(size=x0.shape))
        h = 1e-6
        with mesh:
            vp = obj_sh(x0 + h * pert)
            vm = obj_sh(x0 - h * pert)
        fd = (float(vp) - float(vm)) / (2 * h)
        ans = float(pert @ g_sh)
        assert abs(ans - fd) / abs(fd) < 1e-6, (ans, fd)

    def test_crm_serial_vs_sharded_gradient_small(self, mesh):
        from eigd_tpu.parallel.sharded import make_sharded_crm_objective

        obj_sh, crm_sh, mesh2, part = make_sharded_crm_objective(
            NDEV, nspan=6, nchord=3, nheight=1, N=2, m=32, mesh=mesh)
        t0 = jnp.asarray(crm_sh.x)
        # (like the buckling family, this objective caches jitted internals
        # on first trace — a reused jitted wrapper trips
        # UnexpectedTracerError, so FD goes through the eager objective)
        with mesh:
            v_sh, g_sh = jax.value_and_grad(obj_sh)(t0)

        from eigd_tpu.models.crm import CRM

        # serial parity on the VALUE only: the serial adjoint
        # (finalize_adjoint) compile was ~half this test's wall and the
        # serial gradient is already covered by test_crm.py; the sharded
        # gradient is verified by FD through the compiled program.
        crm = CRM(nspan=6, nchord=3, nheight=1, N=2, m=32)
        crm.initialize()
        v_se = float(crm.get_modal_compliance())
        assert abs(float(v_sh) - v_se) / abs(v_se) < 1e-6

        pert = jnp.asarray(np.random.default_rng(7).uniform(size=t0.shape))
        h = 1e-6
        with mesh:
            vp = obj_sh(t0 + h * pert)
            vm = obj_sh(t0 - h * pert)
        fd = (float(vp) - float(vm)) / (2 * h)
        ans = float(pert @ g_sh)
        assert abs(ans - fd) / abs(fd) < 1e-5, (ans, fd)


class TestGradientParity:
    @pytest.mark.slow
    def test_serial_vs_sharded_gradient(self, mesh):
        """The full objective gradient (filter -> assembly -> eigensolve ->
        adjoint -> aggregate) agrees between the serial path (ElementOperator
        + block-tridiag Cholesky) and the 8-device sharded path (halo matvec
        + Schwarz-PCG + psum'd Lanczos/SIBK)."""
        nx, ny, N = 14, 6, 2
        obj_sh, fltr, mesh2, part = make_sharded_objective(
            NDEV, nx, ny, N=N, m=40, cg_maxiter=300, mesh=mesh,
            adjoint_maxiter=40)
        grid = make_grid(nx, ny, 2.0, 1.0)
        obj_se = _serial_objective(nx, ny, N, 40, -10.0, 1e-3, fltr, grid)

        x0 = 0.8 * jnp.ones(fltr.num_design_vars) + 0.1 * jnp.sin(
            jnp.arange(fltr.num_design_vars, dtype=jnp.float64))

        with mesh:
            v_sh, g_sh = jax.value_and_grad(obj_sh)(x0)
        v_se, g_se = jax.value_and_grad(obj_se)(x0)

        # Cross-path agreement is limited by the sharded CG factor tolerance
        # (1e-13 on the solves -> ~1e-8 on eigenvector aggregates).
        assert abs(float(v_sh) - float(v_se)) / abs(float(v_se)) < 1e-6
        scale = float(jnp.max(jnp.abs(g_se)))
        np.testing.assert_allclose(np.asarray(g_sh) / scale,
                                   np.asarray(g_se) / scale, atol=1e-6)

        # The sharded gradient is exactly consistent with the sharded
        # forward: central finite difference along a random direction.
        pert = jnp.asarray(np.random.default_rng(7).uniform(
            size=x0.shape))
        h = 1e-6
        with mesh:
            vp = obj_sh(x0 + h * pert)
            vm = obj_sh(x0 - h * pert)
        fd = (float(vp) - float(vm)) / (2 * h)
        ans = float(pert @ g_sh)
        assert abs(ans - fd) / abs(fd) < 1e-7, (ans, fd)

    @pytest.mark.slow
    def test_sharded_mg_factor_gradient(self, mesh):
        """The line-sharded multigrid factor (VERDICT r1 §3): objective +
        gradient with factor='mg' and the V-cycle-preconditioned pcpg
        adjoint agree with the serial path and with finite differences."""
        nx, ny, N = 16, 8, 2
        obj_sh, fltr, mesh2, part = make_sharded_objective(
            NDEV, nx, ny, N=N, m=40, mesh=mesh, factor="mg",
            adjoint_method="pcpg", adjoint_maxiter=200)
        assert part.L % 4 == 0
        grid = make_grid(nx, ny, 2.0, 1.0)
        obj_se = _serial_objective(nx, ny, N, 40, -10.0, 1e-3, fltr, grid)

        x0 = 0.8 * jnp.ones(fltr.num_design_vars) + 0.1 * jnp.sin(
            jnp.arange(fltr.num_design_vars, dtype=jnp.float64))
        with mesh:
            v_sh, g_sh = jax.value_and_grad(obj_sh)(x0)
        v_se, g_se = jax.value_and_grad(obj_se)(x0)
        assert abs(float(v_sh) - float(v_se)) / abs(float(v_se)) < 1e-6
        scale = float(jnp.max(jnp.abs(g_se)))
        np.testing.assert_allclose(np.asarray(g_sh) / scale,
                                   np.asarray(g_se) / scale, atol=1e-6)

        pert = jnp.asarray(np.random.default_rng(7).uniform(size=x0.shape))
        h = 1e-6
        with mesh:
            vp = obj_sh(x0 + h * pert)
            vm = obj_sh(x0 - h * pert)
        fd = (float(vp) - float(vm)) / (2 * h)
        ans = float(pert @ g_sh)
        assert abs(ans - fd) / abs(fd) < 1e-6, (ans, fd)

    @pytest.mark.slow
    def test_sharded_polish_gradient(self, mesh):
        """Ritz-block polish under shard_map (psum'd dd-GEMMs + sharded
        factor apply): gradient still matches FD."""
        nx, ny, N = 16, 8, 2
        obj_sh, fltr, mesh2, part = make_sharded_objective(
            NDEV, nx, ny, N=N, m=40, mesh=mesh, polish=1)
        x0 = 0.8 * jnp.ones(fltr.num_design_vars) + 0.1 * jnp.sin(
            jnp.arange(fltr.num_design_vars, dtype=jnp.float64))
        with mesh:
            v_sh, g_sh = jax.value_and_grad(obj_sh)(x0)
        pert = jnp.asarray(np.random.default_rng(7).uniform(size=x0.shape))
        h = 1e-6
        with mesh:
            vp = obj_sh(x0 + h * pert)
            vm = obj_sh(x0 - h * pert)
        fd = (float(vp) - float(vm)) / (2 * h)
        ans = float(pert @ g_sh)
        assert abs(ans - fd) / abs(fd) < 1e-6, (ans, fd)

    @pytest.mark.slow
    def test_sharded_thermal_gradient(self, mesh):
        """Sharded scalar-field (ndof=1) thermal objective (VERDICT r1 §4):
        serial-vs-sharded value/gradient parity + FD consistency."""
        from eigd_tpu.parallel.sharded import make_sharded_thermal_objective
        from eigd_tpu.fem.quad import thermal_tables
        from eigd_tpu.ops.autodiff import EigProblem, EighGenConfig, eigh_gen

        nx, ny, N = 12, 6, 3
        obj_sh, fltr, mesh2, part = make_sharded_thermal_objective(
            NDEV, nx, ny, N=N, m=36, mesh=mesh, cg_maxiter=400,
            adjoint_maxiter=40)
        grid = make_grid(nx, ny, 1.0, 1.0)

        # serial twin
        conn = jnp.asarray(grid.conn)
        X = jnp.asarray(grid.X)
        Be, He, detJ = thermal_tables(X, conn)
        nnodes = grid.nnodes
        kappa, beta, p = 1.0, 1e-6, 3.0

        def assemble(rhoE):
            K = fem.thermal_stiffness_matrix(rhoE, Be, detJ, conn, nnodes,
                                             kappa=kappa, beta=beta, p=p)
            M = fem.thermal_mass_matrix(rhoE, He, detJ, conn, nnodes,
                                        beta=beta)
            return K, M

        problem = EigProblem(assemble=assemble)
        cfg = EighGenConfig(N=N, m=36, sigma=-0.1, adjoint_method="sibk",
                            adjoint_maxiter=40)
        line_dofs = ny + 1
        line = jnp.arange(nnodes) // line_dofs
        within = jnp.arange(nnodes) % line_dofs
        w = jnp.sin(0.37 * line + 0.11 * within)

        def obj_se(x):
            rho = fltr.apply(x)
            rhoE = fem.element_density(rho, conn)
            lam, Q = eigh_gen(rhoE, problem, cfg)
            f_q = w @ Q
            comp = jnp.sum((f_q[1:] ** 2) / lam[1:])
            qagg = jnp.sum((w[:, None] * Q[:, 1:]) ** 2)
            return comp + jnp.sum(jnp.sqrt(lam[1:])) + 1e-3 * qagg

        x0 = 0.8 * jnp.ones(fltr.num_design_vars) + 0.1 * jnp.sin(
            jnp.arange(fltr.num_design_vars, dtype=jnp.float64))
        with mesh:
            v_sh, g_sh = jax.value_and_grad(obj_sh)(x0)
        v_se, g_se = jax.value_and_grad(obj_se)(x0)
        assert abs(float(v_sh) - float(v_se)) / abs(float(v_se)) < 1e-6
        scale = float(jnp.max(jnp.abs(g_se)))
        np.testing.assert_allclose(np.asarray(g_sh) / scale,
                                   np.asarray(g_se) / scale, atol=1e-6)

        pert = jnp.asarray(np.random.default_rng(7).uniform(size=x0.shape))
        h = 1e-6
        with mesh:
            vp = obj_sh(x0 + h * pert)
            vm = obj_sh(x0 - h * pert)
        fd = (float(vp) - float(vm)) / (2 * h)
        ans = float(pert @ g_sh)
        assert abs(ans - fd) / abs(fd) < 1e-6, (ans, fd)

    @pytest.mark.slow
    def test_sharded_buckling_gradient(self, mesh):
        """Sharded masked-Dirichlet buckling pencil (VERDICT r1 §4): static
        preload + stress stiffness + buckling-mode eigensolve/adjoint agree
        with a dense serial twin and with finite differences."""
        from eigd_tpu.parallel.sharded import make_sharded_buckling_objective
        from eigd_tpu.fem.quad import stress_stiffness_tables
        from eigd_tpu.ops.autodiff import EigProblem, EighGenConfig, eigh_gen
        from eigd_tpu.ops.operators import DenseOperator, ElementOperator

        nx, ny, N = 12, 6, 2
        # sigma just below the first buckling load factor (~0.0094 for this
        # density/load; the shift must keep K + sigma*G positive definite)
        sigma, ks_rho, p, q, load_frac = 0.008, 160.0, 3.0, 5.0, 0.2
        obj_sh, fltr, mesh2, part = make_sharded_buckling_objective(
            NDEV, nx, ny, N=N, m=30, mesh=mesh, sigma=sigma,
            adjoint_maxiter=30, ks_rho=ks_rho, load_frac=load_frac)
        grid = make_grid(nx, ny, 2.0, 1.0)

        # dense serial twin: same masked full-space pencil, vanilla AD for
        # the static solve, dense cholesky shift factor
        conn = jnp.asarray(grid.conn)
        X = jnp.asarray(grid.X)
        C0 = fem.plane_stress_C0()
        dofs = fem.element_dof_map(conn)
        Be, Te, detJ = stress_stiffness_tables(X, conn)
        nvars = 2 * grid.nnodes
        b = 2 * (ny + 1)
        free = np.ones(nvars)
        free[:b] = 0.0
        fm = jnp.asarray(free)
        fixed = 1.0 - fm
        forces = np.zeros(nvars)
        jmid = range(int(ny * (0.5 - load_frac / 2)),
                     int(ny * (0.5 + load_frac / 2)) + 1)
        for j in jmid:
            forces[nx * b + 2 * j] = -1.0 / len(list(jmid))
        f = jnp.asarray(forces) * fm

        me = fm[dofs]

        def khat(rhoE):
            K = fem.stiffness_matrix(rhoE, Be, detJ, dofs, nvars, C0,
                                     p=p, q=q)
            Km = K.mats * me[:, :, None] * me[:, None, :]
            return ElementOperator(Km, dofs, nvars).to_dense() + jnp.diag(
                fixed)

        def ghat(rhoE, u):
            G = fem.stress_stiffness_matrix(rhoE, u * fm, Be, Te, detJ,
                                            dofs, conn, nvars, C0,
                                            p=p, q=q, rho0=1e-9)
            Gm = G.mats * me[:, :, None] * me[:, None, :]
            return ElementOperator(Gm, dofs, nvars).to_dense()

        def v0_fn(th):
            import jax as _jax
            key = _jax.random.PRNGKey(12345)
            v = _jax.random.uniform(key, (nvars,), dtype=jnp.float64,
                                    minval=-1.0, maxval=1.0)
            # start in the free subspace: the masked fixed subspace carries
            # theta = 1 Ritz values whose buckling map divides by zero
            return v * fm

        problem = EigProblem(
            assemble=lambda th: (DenseOperator(ghat(*th)),
                                 DenseOperator(khat(th[0]))),
            v0=v0_fn)
        cfg = EighGenConfig(N=N, m=30, sigma=sigma, mode="buckling",
                            adjoint_method="sibk", adjoint_maxiter=30)
        line = jnp.arange(nvars) // b
        within = jnp.arange(nvars) % b
        w = jnp.sin(0.37 * line + 0.11 * within)

        def obj_se(x):
            rho = fltr.apply(x)
            rhoE = fem.element_density(rho, conn)
            u = jnp.linalg.solve(khat(rhoE), f)
            lam, Q = eigh_gen((rhoE, u), problem, cfg)
            mu = 1.0 / lam
            c = jnp.max(mu)
            ks = c + jnp.log(jnp.sum(jnp.exp(ks_rho * (mu - c)))) / ks_rho
            qagg = jnp.sum((w[:, None] * Q) ** 2)
            return ks + 1e-3 * qagg + 0.1 * (f @ u)

        x0 = 0.6 * jnp.ones(fltr.num_design_vars) + 0.05 * jnp.sin(
            jnp.arange(fltr.num_design_vars, dtype=jnp.float64))
        with mesh:
            v_sh, g_sh = jax.value_and_grad(obj_sh)(x0)
        v_se, g_se = jax.value_and_grad(obj_se)(x0)
        assert abs(float(v_sh) - float(v_se)) / abs(float(v_se)) < 1e-6
        scale = float(jnp.max(jnp.abs(g_se)))
        np.testing.assert_allclose(np.asarray(g_sh) / scale,
                                   np.asarray(g_se) / scale, atol=1e-6)

        pert = jnp.asarray(np.random.default_rng(7).uniform(size=x0.shape))
        h = 1e-6
        with mesh:
            vp = obj_sh(x0 + h * pert)
            vm = obj_sh(x0 - h * pert)
        fd = (float(vp) - float(vm)) / (2 * h)
        ans = float(pert @ g_sh)
        assert abs(ans - fd) / abs(fd) < 1e-6, (ans, fd)

    @pytest.mark.slow
    @pytest.mark.skipif(not os.environ.get("EIGD_RUN_SLOW"),
                        reason="1M-DOF compile on 1 CPU core; "
                               "set EIGD_RUN_SLOW=1")
    def test_sharded_1m_flagship_composes(self, mesh):
        """VERDICT r3 item 9: the NORTH-STAR configuration — 1024x512
        (1,051,650 DOF), N=6, block-8 Lanczos with the flagship m, Ritz
        polish, line-sharded multigrid factor, V-cycle-preconditioned
        adjoint — composes under shard_map on the virtual 8-device mesh:
        the full value_and_grad program lowers and COMPILES (memory
        layout, halo exchanges, replicated coarse tail all materialize).
        Set EIGD_RUN_1M_EXEC=1 to additionally execute one objective
        evaluation (~tens of minutes on 1 CPU core)."""
        nx, ny, N = 1024, 512, 6
        obj_sh, fltr, mesh2, part = make_sharded_objective(
            NDEV, nx, ny, N=N, m=176, mesh=mesh, factor="mg",
            adjoint_method="pcpg", adjoint_maxiter=60,
            lanczos_block=8, polish=1, sigma=-1.0)
        assert part.n >= 1_050_000
        x0 = 0.9 * jnp.ones(fltr.num_design_vars)
        with mesh:
            compiled = jax.jit(
                jax.value_and_grad(obj_sh)).lower(x0).compile()
        assert compiled is not None
        if os.environ.get("EIGD_RUN_1M_EXEC"):
            with mesh:
                v = obj_sh(x0)
            assert np.isfinite(float(v))

    @pytest.mark.slow
    @pytest.mark.skipif(not os.environ.get("EIGD_RUN_SLOW"),
                        reason="~35 min on 1 CPU core; set EIGD_RUN_SLOW=1")
    def test_sharded_gradient_parity_50k_dof(self, mesh):
        """Parity at a size where sharding matters (>= 50k DOF)."""
        nx, ny, N = 250, 99, 2  # 2*(251*100) = 50,200 DOF
        obj_sh, fltr, mesh2, part = make_sharded_objective(
            NDEV, nx, ny, N=N, m=40, cg_maxiter=400, mesh=mesh,
            adjoint_maxiter=40)
        assert part.n >= 50_000
        grid = make_grid(nx, ny, 2.0, 1.0)
        obj_se = _serial_objective(nx, ny, N, 40, -10.0, 1e-3, fltr, grid)

        x0 = 0.9 * jnp.ones(fltr.num_design_vars)
        with mesh:
            v_sh, g_sh = jax.value_and_grad(obj_sh)(x0)
        v_se, g_se = jax.value_and_grad(obj_se)(x0)
        assert abs(float(v_sh) - float(v_se)) / abs(float(v_se)) < 1e-6
        scale = float(jnp.max(jnp.abs(g_se)))
        np.testing.assert_allclose(np.asarray(g_sh) / scale,
                                   np.asarray(g_se) / scale,
                                   atol=1e-6)


class TestGraftEntry:
    @pytest.mark.slow
    def test_dryrun_multichip(self):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)

    def test_entry_compiles(self):
        import __graft_entry__ as ge

        fn, args = ge.entry()
        lam, Q = jax.jit(fn)(*args)
        assert np.all(np.isfinite(np.asarray(lam)))


class TestShardedCRM:
    @pytest.mark.slow
    def test_serial_vs_sharded_crm_gradient(self, mesh):
        """Station-sharded wingbox (VERDICT r1 §5 follow-through): the
        sharded modal-compliance value and thickness gradient match the
        serial CRM's three-phase adjoint."""
        from eigd_tpu.parallel.sharded import make_sharded_crm_objective

        obj_sh, crm_sh, mesh2, part = make_sharded_crm_objective(
            NDEV, nspan=8, nchord=4, nheight=2, N=4, m=48, mesh=mesh)
        t0 = jnp.asarray(crm_sh.x)
        with mesh:
            v_sh, g_sh = jax.value_and_grad(obj_sh)(t0)

        from eigd_tpu.models.crm import CRM

        crm = CRM(nspan=8, nchord=4, nheight=2, N=4, m=48)
        crm.initialize()
        v_se = float(crm.get_modal_compliance())
        crm.initialize_adjoint()
        crm.add_modal_compliance_derivative(1.0)
        crm.finalize_adjoint()
        g_se = np.asarray(crm.xb)

        assert abs(float(v_sh) - v_se) / abs(v_se) < 1e-6
        scale = float(np.max(np.abs(g_se)))
        np.testing.assert_allclose(np.asarray(g_sh) / scale, g_se / scale,
                                   atol=1e-6)
