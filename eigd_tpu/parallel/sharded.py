"""DOF-dimension sharding of the eigensolve/adjoint pipeline (shard_map).

This is the on-device rebuild of the distributed role MPI plays for the
reference (only through TACS, crm.py:11,71), designed per SURVEY.md §5.7-5.8:

* long vectors (Lanczos basis, adjoint blocks, displacement fields) are
  sharded over the grid's node lines — device d owns lines [d*L, (d+1)*L);
* the element-operator matvec exchanges ONE halo line with the right
  neighbour (two ``ppermute``s of line_dofs words) — O(surface) comms,
  never an O(n) or O(n^2) all-reduce;
* every solver inner product is a psum-reduced tall-skinny GEMM (the
  ``axis`` parameter threaded through ops.lanczos / ops.adjoint);
* the shift-invert factor is CG on the sharded shifted operator,
  preconditioned by a one-level additive Schwarz method: each device block-
  tridiagonal-Cholesky-factors its own lines and solves locally (zero
  communication per preconditioner apply);
* the (m, m) reduced Rayleigh-Ritz problem and all (N, N) correction algebra
  stay replicated.

Everything here executes inside ONE ``shard_map`` region per train step, so
XLA sees local arrays and the explicit collectives above — nothing is
resharded mid-solve.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.collective import psum
from .grid import (GridPartition, element_gather_index, local_dof_map,
                   make_partition, pad_line_mask)


def pad_elements(arrays, n_shards, axis=0):
    """Pad the element axis to a multiple of n_shards (zero padding; padded
    elements have zero matrices so they contribute nothing)."""
    out = []
    for a in arrays:
        n = a.shape[axis]
        pad = (-n) % n_shards
        if pad:
            widths = [(0, 0)] * a.ndim
            widths[axis] = (0, pad)
            a = jnp.pad(a, widths)
        out.append(a)
    return out


def sharded_element_matvec(mesh, axis, mats, dofs, nvars):
    """Element-sharded matvec closure for *unstructured* problems:
    x (replicated) -> A x (replicated).

    mats (nelems, d, d) and dofs (nelems, d) are sharded over `axis`; the
    local scatter-adds are reduced with one psum of the O(n) result (the
    general fallback when no grid structure exists; the grid path below
    reduces this to O(line) halo exchanges).
    """

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P()),
             out_specs=P())
    def mv(mats_l, dofs_l, x):
        xe = x[dofs_l]
        ye = jnp.einsum("eij,ej->ei", mats_l, xe)
        y = jax.ops.segment_sum(ye.reshape(-1), dofs_l.reshape(-1),
                                num_segments=nvars)
        return jax.lax.psum(y, axis)

    return lambda x: mv(mats, dofs, x)


# ---------------------------------------------------------------------------
# Halo-exchange grid operator (runs INSIDE shard_map)
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
class GridHaloOperator:
    """Matrix-free FE operator on a line-partitioned grid, device-local view.

    mats : (elems_local, d, d) per-element matrices of THIS device's element
        columns (padded columns have zero matrices).
    dofs : (elems_local, d) local *extended* DOF indices (see
        grid.local_dof_map) — identical on every device.
    part : the GridPartition (static).
    axis : shard_map axis name (static).

    mv(x_local) computes the local shard of the global matvec with one halo
    receive (first line of the right neighbour) and one boundary send-back.
    """

    def __init__(self, mats, dofs, part: GridPartition, axis: str):
        self.mats = mats
        self.dofs = dofs
        self.part = part
        self.axis = axis

    @property
    def shape(self):
        n = self.part.n_local
        return (n, n)

    @property
    def dtype(self):
        return self.mats.dtype

    def _perm_fwd(self):
        # receive from the right neighbour: d+1 -> d
        return [(d + 1, d) for d in range(self.part.ndev - 1)]

    def _perm_bwd(self):
        # send boundary contributions to the right neighbour: d -> d+1
        return [(d, d + 1) for d in range(self.part.ndev - 1)]

    def mv(self, x):
        part = self.part
        b = part.line_dofs
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        k = x.shape[1]

        if part.ndev > 1:
            halo = jax.lax.ppermute(x[:b], self.axis, self._perm_fwd())
        else:
            halo = jnp.zeros((b, k), dtype=x.dtype)
        x_ext = jnp.concatenate([x, halo], axis=0)  # (L+1 lines)

        xe = x_ext[self.dofs]  # (ne_l, d, k)
        ye = jnp.einsum("eij,ejk->eik", self.mats, xe)
        y_ext = jax.ops.segment_sum(
            ye.reshape(-1, k), self.dofs.reshape(-1),
            num_segments=(part.L + 1) * b)

        if part.ndev > 1:
            recv = jax.lax.ppermute(y_ext[part.L * b:], self.axis,
                                    self._perm_bwd())
        else:
            recv = jnp.zeros((b, k), dtype=x.dtype)
        y = y_ext[: part.L * b].at[:b].add(recv)
        if squeeze:
            y = y[:, 0]
        return y

    def __call__(self, x):
        return self.mv(x)

    def tree_flatten(self):
        return (self.mats, self.dofs), (self.part, self.axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        mats, dofs = children
        return cls(mats, dofs, *aux)


def local_line_blocks(mats, dofs, part: GridPartition):
    """Per-device block-tridiagonal blocks of the local lines.

    Scatter the element matrices into (L, b, b) diagonal blocks D and
    (L-1, b, b) sub-diagonal blocks E = A[line c+1, line c], dropping the
    coupling to the halo line (one-level additive Schwarz). Zero diagonal
    entries (padded lines / padded columns) are replaced by 1 so the local
    Cholesky exists.
    """
    L, b = part.L, part.line_dofs
    dtype = mats.dtype
    li = dofs // b  # (ne, d) line of each element dof (0..L)
    wi = dofs % b

    same = (li[:, :, None] == li[:, None, :])
    lower = (li[:, :, None] == li[:, None, :] + 1)

    # diagonal blocks (dump halo-line couplings into a trash slot L)
    d_idx = jnp.where(same, jnp.minimum(li[:, :, None], L - 1), L)
    d_idx = jnp.where(same & (li[:, :, None] >= L), L, d_idx)
    D = jnp.zeros((L + 1, b, b), dtype=dtype)
    D = D.at[d_idx, wi[:, :, None], wi[:, None, :]].add(
        jnp.where(same & (li[:, :, None] < L), mats, 0.0))
    D = D[:L]

    # sub-diagonal blocks E[c] = A[c+1, c]; the c = L-1 coupling goes to the
    # halo line and is dropped (trash slot L-1 is sliced away only if L > 1).
    e_idx = jnp.where(lower, li[:, None, :], L)  # index by the lower line
    e_idx = jnp.where(lower & (li[:, :, None] >= L), L, e_idx)
    E = jnp.zeros((L + 1, b, b), dtype=dtype)
    E = E.at[e_idx, wi[:, :, None], wi[:, None, :]].add(
        jnp.where(lower & (li[:, :, None] < L), mats, 0.0))
    E = E[: L - 1] if L > 1 else jnp.zeros((0, b, b), dtype=dtype)

    # Make padded / empty DOFs SPD with unit diagonal.
    diag = jnp.diagonal(D, axis1=1, axis2=2)
    fix = (diag == 0.0).astype(dtype)
    D = D + jax.vmap(jnp.diag)(fix)
    return D, E


@jax.tree_util.register_pytree_node_class
class SchwarzPCGFactor:
    """Shift-invert factor for the sharded path: CG on the (SPD) sharded
    shifted operator, preconditioned by the device-local block-tridiagonal
    Cholesky (one-level additive Schwarz; zero comms per preconditioner
    apply, one halo exchange + two scalar psums per CG iteration).
    """

    def __init__(self, op: GridHaloOperator, btf, maxiter=100, tol=1e-13,
                 axis=None):
        self.op = op
        self.btf = btf
        self.maxiter = maxiter
        self.tol = tol
        self.axis = axis

    @classmethod
    def build(cls, shifted_mats, dofs, part, axis, maxiter=100, tol=1e-13):
        from ..ops.blockfactor import BlockTridiagFactor

        op = GridHaloOperator(shifted_mats, dofs, part, axis)
        D, E = local_line_blocks(shifted_mats, dofs, part)
        btf = BlockTridiagFactor.from_blocks(D, E)
        return cls(op, btf, maxiter=maxiter, tol=tol, axis=axis)

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return self.op.dtype

    def _apply(self, x):
        # padded DOFs: the element matrices are zero there, but the local
        # preconditioner has unit diagonal, so PCG keeps them at exactly 0
        # as long as the rhs is 0 there (guaranteed: every rhs comes from a
        # B/A matvec).
        return self.op.mv(x)

    def mv(self, bvec):
        x, _ = self.mv_info(bvec)
        return x

    def mv_info(self, bvec):
        """Like ``mv`` but also returns convergence info: niter, per-column
        final squared residuals and the squared tolerance, so callers can
        detect a silent ``maxiter`` truncation (VERDICT r1 §9: one-level
        Schwarz conditioning grows with device count; an unconverged apply
        must be visible, the reference's SpLuOperator.count analog)."""
        squeeze = bvec.ndim == 1
        if squeeze:
            bvec = bvec[:, None]
        axis = self.axis

        b2 = psum(jnp.sum(bvec * bvec, axis=0), axis)
        tol2 = (self.tol**2) * jnp.maximum(b2, 1e-300)

        def cond(carry):
            k, x, r, p, rz = carry
            r2 = psum(jnp.sum(r * r, axis=0), axis)
            return (k < self.maxiter) & jnp.any(r2 > tol2)

        def body(carry):
            k, x, r, p, rz = carry
            ap = self._apply(p)
            pap = psum(jnp.sum(p * ap, axis=0), axis)
            r2 = psum(jnp.sum(r * r, axis=0), axis)
            active = r2 > tol2
            alpha = jnp.where(active & (pap != 0.0),
                              rz / jnp.where(pap == 0.0, 1.0, pap), 0.0)
            x = x + alpha[None, :] * p
            r = r - alpha[None, :] * ap
            z = self.btf.mv(r)
            rz_new = psum(jnp.sum(r * z, axis=0), axis)
            beta = jnp.where(rz != 0.0,
                             rz_new / jnp.where(rz == 0.0, 1.0, rz), 0.0)
            p = jnp.where(active[None, :], z + beta[None, :] * p, p)
            return k + 1, x, r, p, rz_new

        x0 = 0.0 * bvec
        z0 = self.btf.mv(bvec)
        rz0 = psum(jnp.sum(bvec * z0, axis=0), axis)
        carry = (jnp.asarray(0), x0, bvec, z0, rz0)
        k_end, x, r, _, _ = jax.lax.while_loop(cond, body, carry)
        res2 = psum(jnp.sum(r * r, axis=0), axis)
        if squeeze:
            x = x[:, 0]
        return x, {"niter": k_end, "res2": res2, "tol2": tol2}

    def __call__(self, x):
        return self.mv(x)

    def tree_flatten(self):
        return (self.op, self.btf), (self.maxiter, self.tol, self.axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        op, btf = children
        return cls(*children, *aux)


def _sharded_mg_factor(shifted_mats, part, axis, shard_levels, rtol=1e-11):
    """Local element matrices of the shifted operator -> line-sharded
    multigrid factor. The element block is (L columns x ny rows) in
    column-major slot order; stencil_from_elements wants e = i + nx*j."""
    from ..ops.stencil import stencil_from_elements
    from .mgshard import ShardedGridMGFactor

    ndof = part.ndof
    ny = part.ny
    d4 = shifted_mats.shape[1]
    em = shifted_mats.reshape(part.L, ny, d4, d4).transpose(
        1, 0, 2, 3).reshape(ny * part.L, d4, d4)
    Wl = stencil_from_elements(em, part.L, ny, ndof)  # (L+1, ny+1, ...)
    W_local = Wl[: part.L]
    if part.ndev > 1:
        # the halo-line row (couplings ONTO the right neighbour's first
        # line from this device's elements) ships right once
        recv = jax.lax.ppermute(Wl[part.L:], axis,
                                [(d, d + 1) for d in range(part.ndev - 1)])
        W_local = W_local.at[:1].add(recv)
    return ShardedGridMGFactor.build(W_local, part, axis,
                                     shard_levels=shard_levels, rtol=rtol)


# ---------------------------------------------------------------------------
# Sharded natural-frequency objective + train step (flagship dryrun path)
# ---------------------------------------------------------------------------


def make_sharded_objective(n_devices, nx, ny, Lx=2.0, Ly=1.0, N=2, m=24,
                           sigma=-10.0, adjoint_maxiter=16, nrestart=2,
                           cg_maxiter=60, axis="grid", mesh=None,
                           qweight=1e-3, factor="schwarz",
                           adjoint_method="sibk", shard_levels=2,
                           lanczos_block=1, polish=0):
    """Build (objective(x), fltr, mesh) for the free-free plane-stress
    natural-frequency problem with the solve sharded over node lines.

    Like the serial model, the known rigid-body triple is *deflated* out of
    the Krylov iteration (robust under exact degeneracy, where a single-
    vector Krylov space contains only one copy of a repeated eigenvalue);
    the rigid modes are built per device from the physical grid coordinates.

    factor="schwarz": CG on the sharded operator with the device-local
    block-tridiagonal Cholesky preconditioner (one-level additive Schwarz).
    factor="mg": the line-sharded geometric multigrid factor
    (parallel.mgshard.ShardedGridMGFactor) — the only 1M-DOF-capable
    factor, now multi-device (VERDICT r1 §3); pair it with
    adjoint_method="pcpg" for the V-cycle-preconditioned adjoint.
    """
    from ..fem import assembly as fem
    from ..fem.filter import NodeFilter
    from ..fem.model import make_grid
    from ..fem.quad import plane_stress_tables
    from ..ops.autodiff import EigProblem, EighGenConfig, eigh_gen

    if mesh is None:
        mesh = Mesh(np.array(jax.devices()[:n_devices]), (axis,))

    grid = make_grid(nx, ny, Lx, Ly)
    fltr = NodeFilter(grid.conn, grid.X, r0=2.0 * (Ly / ny))
    conn = jnp.asarray(grid.conn)
    X = jnp.asarray(grid.X)
    C0 = fem.plane_stress_C0()
    Be, He, detJ = plane_stress_tables(X, conn)  # (nq, nelems, ...)

    part = make_partition(nx, ny, n_devices, ndof=2,
                          multiple=(1 << shard_levels) if factor == "mg"
                          else 1)
    gidx = element_gather_index(part)  # (elems_padded,)
    dofs_l = jnp.asarray(local_dof_map(part))  # identical on every device
    real = jnp.asarray((gidx >= 0).astype(np.float64))
    gsafe = jnp.asarray(np.maximum(gidx, 0))
    masks = jnp.asarray(pad_line_mask(part))  # (ndev, n_local)

    def scatter_cm(arr, axis_e):
        """Gather an element-indexed array into padded column-major order."""
        moved = jnp.moveaxis(arr, axis_e, 0)
        out = moved[gsafe] * real.reshape((-1,) + (1,) * (moved.ndim - 1))
        return out

    # Padded column-major element tables (sharded over the mesh axis).
    Be_cm = scatter_cm(Be, 1)  # (elems_padded, nq, 3, 8)
    He_cm = scatter_cm(He, 1)
    dJ_cm = scatter_cm(detJ, 1)  # (elems_padded, nq)

    nq = Be.shape[0]

    def assemble(theta):
        rhoE_l = theta["rhoE"]
        Be_l = jnp.moveaxis(theta["Be"], 0, 1)  # back to (nq, ne_l, 3, 8)
        He_l = jnp.moveaxis(theta["He"], 0, 1)
        dJ_l = jnp.moveaxis(theta["dJ"], 0, 1)
        K = fem.stiffness_matrix(rhoE_l, Be_l, dJ_l, dofs_l,
                                 (part.L + 1) * part.line_dofs, C0)
        M = fem.mass_matrix(rhoE_l, He_l, dJ_l, dofs_l,
                            (part.L + 1) * part.line_dofs)
        # rewrap the element blocks as halo operators on the local shard
        K = GridHaloOperator(K.mats, dofs_l, part, axis)
        M = GridHaloOperator(M.mats, dofs_l, part, axis)
        return K, M

    def factor_fn(A, B, sig, mode):
        assert mode == "normal"
        shifted = A.mats - sig * B.mats
        if factor == "mg":
            return _sharded_mg_factor(shifted, part, axis, shard_levels)
        return SchwarzPCGFactor.build(shifted, dofs_l, part, axis,
                                      maxiter=cg_maxiter)

    def v0_fn(theta):
        key = jax.random.PRNGKey(12345)
        v = jax.random.uniform(key, (part.n_local,), dtype=jnp.float64,
                               minval=-1.0, maxval=1.0)
        d = jax.lax.axis_index(axis)
        return v * masks[d]

    def _local_coords():
        d = jax.lax.axis_index(axis)
        idx = jnp.arange(part.n_local)
        line = d * part.L + idx // part.line_dofs
        wn = idx % part.line_dofs
        node = wn // 2
        comp = wn % 2
        xc = line.astype(jnp.float64) * (Lx / nx)
        yc = node.astype(jnp.float64) * (Ly / ny)
        return xc, yc, comp, masks[d]

    def nullspace_fn(theta):
        """Rigid-body modes of the free-free structure on the local shard."""
        xc, yc, comp, mask = _local_coords()
        tx = jnp.where(comp == 0, 1.0, 0.0) * mask
        ty = jnp.where(comp == 1, 1.0, 0.0) * mask
        rot = jnp.where(comp == 0, -yc, xc) * mask
        return jnp.stack([tx, ty, rot])

    problem = EigProblem(assemble=assemble, factor=factor_fn, v0=v0_fn,
                         nullspace=nullspace_fn)
    cfg = EighGenConfig(N=N, m=m, sigma=sigma, adjoint_method=adjoint_method,
                        adjoint_maxiter=adjoint_maxiter, nrestart=nrestart,
                        axis=axis, block=lanczos_block, polish=polish,
                        adjoint_mixed=(adjoint_method == "pcpg"
                                       and factor == "mg"))

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(axis)),
             out_specs=P())
    def solve_local(rhoE_l, Be_l, He_l, dJ_l):
        theta = {"rhoE": rhoE_l, "Be": Be_l, "He": He_l, "dJ": dJ_l}
        lam, Q = eigh_gen(theta, problem, cfg)
        # KS-style aggregate over the flexible modes; the Q term is a
        # psum-reduced weighted (sign-invariant) norm whose weight is a
        # function of the *physical* DOF only, so the objective value is
        # independent of the device count (parity-testable vs serial).
        d = jax.lax.axis_index(axis)
        line = d * part.L + jnp.arange(part.n_local) // part.line_dofs
        within = jnp.arange(part.n_local) % part.line_dofs
        w = masks[d] * jnp.sin(0.37 * line + 0.11 * within)
        qagg = psum(jnp.sum((w[:, None] * Q) ** 2), axis)
        return -jnp.sum(jnp.sqrt(lam)) + qweight * qagg

    def objective(x):
        rho = fltr.apply(x)
        rhoE = fem.element_density(rho, conn)
        rhoE_cm = rhoE[gsafe] * real
        return solve_local(rhoE_cm, Be_cm, He_cm, dJ_cm)

    return objective, fltr, mesh, part


def sharded_train_step(n_devices, nx, ny, **kwargs):
    """One jitted objective+gradient+update step on the sharded solve."""
    objective, fltr, mesh, _ = make_sharded_objective(n_devices, nx, ny,
                                                      **kwargs)

    @jax.jit
    def step(x):
        val, g = jax.value_and_grad(objective)(x)
        return x - 0.05 * g, val

    x0 = 0.95 * jnp.ones(fltr.num_design_vars)
    with mesh:
        x1, val = step(x0)
    x1.block_until_ready()
    return x1, val


# ---------------------------------------------------------------------------
# Sharded thermal objective (ndof = 1; VERDICT r1 §4)
# ---------------------------------------------------------------------------


def make_sharded_thermal_objective(n_devices, nx, ny, Lx=1.0, Ly=1.0, N=4,
                                   m=48, sigma=-0.1, adjoint_maxiter=24,
                                   nrestart=2, cg_maxiter=300, axis="grid",
                                   mesh=None, qweight=1e-3,
                                   factor="schwarz", shard_levels=2,
                                   kappa=1.0, beta=1e-6, p=3.0, polish=0):
    """Sharded scalar heat-conduction eigenproblem objective.

    Same line partition and halo machinery as the plane-stress path with
    ndof = 1 (reference thermal.py:14-994 roles). The pure-Neumann pencil's
    near-zero constant mode is mode 0 and every aggregate skips it
    (reference :428-442); it is solved, not deflated, exactly like the
    serial ThermalTopologyAnalysis.
    """
    from ..fem import assembly as fem
    from ..fem.filter import NodeFilter
    from ..fem.model import make_grid
    from ..fem.quad import thermal_tables
    from ..ops.autodiff import EigProblem, EighGenConfig, eigh_gen

    if mesh is None:
        mesh = Mesh(np.array(jax.devices()[:n_devices]), (axis,))

    grid = make_grid(nx, ny, Lx, Ly)
    fltr = NodeFilter(grid.conn, grid.X, r0=2.0 * (Ly / ny))
    conn = jnp.asarray(grid.conn)
    X = jnp.asarray(grid.X)
    Be, He, detJ = thermal_tables(X, conn)  # (nq, nelems, ...)

    part = make_partition(nx, ny, n_devices, ndof=1,
                          multiple=(1 << shard_levels) if factor == "mg"
                          else 1)
    gidx = element_gather_index(part)
    dofs_l = jnp.asarray(local_dof_map(part))
    real = jnp.asarray((gidx >= 0).astype(np.float64))
    gsafe = jnp.asarray(np.maximum(gidx, 0))
    masks = jnp.asarray(pad_line_mask(part))

    def scatter_cm(arr, axis_e):
        moved = jnp.moveaxis(arr, axis_e, 0)
        return moved[gsafe] * real.reshape((-1,) + (1,) * (moved.ndim - 1))

    Be_cm = scatter_cm(Be, 1)   # (elems_padded, nq, 2, 4)
    He_cm = scatter_cm(He, 1)   # (elems_padded, nq, 4)
    dJ_cm = scatter_cm(detJ, 1)

    def assemble(theta):
        rhoE_l = theta["rhoE"]
        Be_l = jnp.moveaxis(theta["Be"], 0, 1)
        He_l = jnp.moveaxis(theta["He"], 0, 1)
        dJ_l = jnp.moveaxis(theta["dJ"], 0, 1)
        kcoef = kappa * ((1.0 - beta) * rhoE_l**p + beta)
        BtB = jnp.einsum("qeij,qeil->qejl", Be_l, Be_l)
        Ke = jnp.einsum("e,qe,qejl->ejl", kcoef, dJ_l, BtB)
        ccoef = (1.0 - beta) * rhoE_l + beta
        HtH = jnp.einsum("qei,qej->qeij", He_l, He_l)
        Me = jnp.einsum("e,qe,qeij->eij", ccoef, dJ_l, HtH)
        K = GridHaloOperator(Ke, dofs_l, part, axis)
        M = GridHaloOperator(Me, dofs_l, part, axis)
        return K, M

    def factor_fn(A, B, sig, mode):
        assert mode == "normal"
        shifted = A.mats - sig * B.mats
        if factor == "mg":
            return _sharded_mg_factor(shifted, part, axis, shard_levels)
        return SchwarzPCGFactor.build(shifted, dofs_l, part, axis,
                                      maxiter=cg_maxiter)

    def v0_fn(theta):
        key = jax.random.PRNGKey(12345)
        v = jax.random.uniform(key, (part.n_local,), dtype=jnp.float64,
                               minval=-1.0, maxval=1.0)
        d = jax.lax.axis_index(axis)
        return v * masks[d]

    problem = EigProblem(assemble=assemble, factor=factor_fn, v0=v0_fn)
    cfg = EighGenConfig(N=N, m=m, sigma=sigma, adjoint_method="sibk",
                        adjoint_maxiter=adjoint_maxiter, nrestart=nrestart,
                        axis=axis, polish=polish)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(axis)),
             out_specs=P())
    def solve_local(rhoE_l, Be_l, He_l, dJ_l):
        theta = {"rhoE": rhoE_l, "Be": Be_l, "He": He_l, "dJ": dJ_l}
        lam, Q = eigh_gen(theta, problem, cfg)
        # modal-compliance-style aggregate SKIPPING mode 0 (the near-zero
        # constant mode of the pure-Neumann pencil, reference :428-442),
        # with a device-count-independent physical weight
        d = jax.lax.axis_index(axis)
        line = d * part.L + jnp.arange(part.n_local) // part.line_dofs
        within = jnp.arange(part.n_local) % part.line_dofs
        w = masks[d] * jnp.sin(0.37 * line + 0.11 * within)
        f_q = psum(w @ Q, axis)                       # (N,) phi_i . f
        comp = jnp.sum((f_q[1:] ** 2) / lam[1:])
        qagg = psum(jnp.sum((w[:, None] * Q[:, 1:]) ** 2), axis)
        return comp + jnp.sum(jnp.sqrt(lam[1:])) + qweight * qagg

    def objective(x):
        rho = fltr.apply(x)
        rhoE = fem.element_density(rho, conn)
        rhoE_cm = rhoE[gsafe] * real
        return solve_local(rhoE_cm, Be_cm, He_cm, dJ_cm)

    return objective, fltr, mesh, part


# ---------------------------------------------------------------------------
# Sharded buckling objective (masked Dirichlet pencil; VERDICT r1 §4)
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
class DiagHaloOperator:
    """GridHaloOperator plus a local diagonal term (unit diagonal on masked
    Dirichlet DOFs — the sharded mirror of GridStencilOperator.extra_diag in
    the serial masked buckling path, models/buckling.py:162-184)."""

    def __init__(self, op: GridHaloOperator, diag):
        self.op = op
        self.diag = diag

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def mats(self):
        return self.op.mats

    def mv(self, x):
        y = self.op.mv(x)
        if x.ndim == 2:
            return y + self.diag[:, None] * x
        return y + self.diag * x

    def __call__(self, x):
        return self.mv(x)

    def tree_flatten(self):
        return (self.op, self.diag), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def make_sharded_buckling_objective(n_devices, nx, ny, Lx=2.0, Ly=1.0, N=3,
                                    m=40, sigma=3.0, adjoint_maxiter=24,
                                    nrestart=2, cg_maxiter=400, axis="grid",
                                    mesh=None, qweight=1e-3, ks_rho=160.0,
                                    load_frac=0.2, p=3.0, q=5.0, polish=0):
    """Sharded linearized-buckling objective: Dirichlet DOFs masked (zeroed
    rows/cols + unit diagonal), static preload solve K u = f through the
    sharded Schwarz-PCG factor under the custom-VJP ``solve_spd`` (the path
    adjoint, reference buckling.py:974-979), stress stiffness G(rho, u)
    assembled from halo-exchanged displacements, and the buckling pencil
    G phi = mu K phi solved in "buckling" mode with factor (K + sigma G)^-1.

    Objective = KS(1/BLF) + qweight * eigenvector aggregate (sign-invariant,
    device-count-independent weights) + compliance.
    """
    from ..fem import assembly as fem
    from ..fem.filter import NodeFilter
    from ..fem.model import make_grid
    from ..fem.quad import stress_stiffness_tables
    from ..ops.autodiff import (EigProblem, EighGenConfig, eigh_gen,
                                solve_spd)

    if mesh is None:
        mesh = Mesh(np.array(jax.devices()[:n_devices]), (axis,))

    grid = make_grid(nx, ny, Lx, Ly)
    fltr = NodeFilter(grid.conn, grid.X, r0=2.0 * (Ly / ny))
    conn = jnp.asarray(grid.conn)
    X = jnp.asarray(grid.X)
    C0 = fem.plane_stress_C0()
    Be, Te, detJ = stress_stiffness_tables(X, conn)

    part = make_partition(nx, ny, n_devices, ndof=2)
    gidx = element_gather_index(part)
    dofs_l = jnp.asarray(local_dof_map(part))
    real = jnp.asarray((gidx >= 0).astype(np.float64))
    gsafe = jnp.asarray(np.maximum(gidx, 0))
    masks = jnp.asarray(pad_line_mask(part))

    def scatter_cm(arr, axis_e):
        moved = jnp.moveaxis(arr, axis_e, 0)
        return moved[gsafe] * real.reshape((-1,) + (1,) * (moved.ndim - 1))

    Be_cm = scatter_cm(Be, 1)
    Te_cm = scatter_cm(Te, 1)
    dJ_cm = scatter_cm(detJ, 1)

    # -- Dirichlet mask + load, line-partitioned (host side) -----------------
    b = part.line_dofs
    free_full = np.ones(part.ndev * part.n_local)
    free_full[:b] = 0.0  # clamp the left edge (line 0)
    free_sh = jnp.asarray(free_full.reshape(part.ndev, part.n_local)
                          * np.asarray(masks))

    forces = np.zeros(part.ndev * part.n_local)
    jmid = range(int(ny * (0.5 - load_frac / 2)),
                 int(ny * (0.5 + load_frac / 2)) + 1)
    # right-edge nodes live on global line nx at row j
    for j in jmid:
        forces[nx * b + 2 * j] = -1.0 / len(list(jmid))
    forces_sh = jnp.asarray(forces.reshape(part.ndev, part.n_local))

    perm_fwd = [(d + 1, d) for d in range(part.ndev - 1)]

    def _halo_right(u):
        if part.ndev == 1:
            return jnp.zeros((b,), dtype=u.dtype)
        return jax.lax.ppermute(u[:b], axis, perm_fwd)

    def _mask_mats(mats, fm_l):
        fm_ext = jnp.concatenate([fm_l, _halo_right(fm_l)])
        me = fm_ext[dofs_l]
        return mats * me[:, :, None] * me[:, None, :]

    def _K_mats(theta, fm_l):
        Be_l = jnp.moveaxis(theta["Be"], 0, 1)
        dJ_l = jnp.moveaxis(theta["dJ"], 0, 1)
        K = fem.stiffness_matrix(theta["rhoE"], Be_l, dJ_l, dofs_l,
                                 (part.L + 1) * b, C0, p=p, q=q)
        return _mask_mats(K.mats, fm_l)

    def _G_mats(theta, u_l, fm_l):
        Be_l = jnp.moveaxis(theta["Be"], 0, 1)
        Te_l = jnp.moveaxis(theta["Te"], 0, 1)
        dJ_l = jnp.moveaxis(theta["dJ"], 0, 1)
        u_ext = jnp.concatenate([u_l * fm_l, _halo_right(u_l * fm_l)])
        from ..fem.assembly import stiffness_interp

        c = stiffness_interp(theta["rhoE"], p=p, q=q, rho0=1e-9)
        ue = u_ext[dofs_l]
        s = jnp.einsum("e,ik,qekl,el->qei", c, C0, Be_l, ue)
        G0 = jnp.einsum("qe,qei,qeijl->ejl", dJ_l, s, Te_l)
        Ge = jnp.zeros((dofs_l.shape[0], 8, 8), dtype=G0.dtype)
        Ge = Ge.at[:, 0::2, 0::2].add(G0)
        Ge = Ge.at[:, 1::2, 1::2].add(G0)
        return _mask_mats(Ge, fm_l)

    def solve_local_fn(rhoE_l, Be_l, Te_l, dJ_l):
        d = jax.lax.axis_index(axis)
        fm_l = free_sh[d]
        fixed_l = masks[d] * (1.0 - fm_l)
        theta = {"rhoE": rhoE_l, "Be": Be_l, "Te": Te_l, "dJ": dJ_l}

        def build_K_op(th):
            Km = _K_mats(th, fm_l)
            return DiagHaloOperator(GridHaloOperator(Km, dofs_l, part, axis),
                                    fixed_l)

        def build_K_factor(th):
            Km = _K_mats(th, fm_l)
            return SchwarzPCGFactor.build(Km, dofs_l, part, axis,
                                          maxiter=cg_maxiter)

        fm_load = forces_sh[d] * fm_l
        u = solve_spd(theta, fm_load, build_K_op, build_K_factor)
        compliance = psum(fm_load @ u, axis)

        def assemble(th2):
            th, u_ = th2
            Km = _K_mats(th, fm_l)
            Gm = _G_mats(th, u_, fm_l)
            K = DiagHaloOperator(GridHaloOperator(Km, dofs_l, part, axis),
                                 fixed_l)
            G = DiagHaloOperator(GridHaloOperator(Gm, dofs_l, part, axis),
                                 0.0 * fixed_l)
            return G, K

        def factor_fn(A, B, sig, mode):
            assert mode == "buckling"
            mats = B.mats + sig * A.mats
            return SchwarzPCGFactor.build(mats, dofs_l, part, axis,
                                          maxiter=cg_maxiter)

        def v0_fn(th2):
            key = jax.random.PRNGKey(12345)
            v = jax.random.uniform(key, (part.n_local,), dtype=jnp.float64,
                                   minval=-1.0, maxval=1.0)
            return v * fm_l

        problem = EigProblem(assemble=assemble, factor=factor_fn, v0=v0_fn)
        cfg = EighGenConfig(N=N, m=m, sigma=sigma, mode="buckling",
                            adjoint_method="sibk",
                            adjoint_maxiter=adjoint_maxiter,
                            nrestart=nrestart, axis=axis, polish=polish)
        lam, Q = eigh_gen((theta, u), problem, cfg)
        import os as _os
        if _os.environ.get("EIGD_DEBUG_BUCKLING"):
            jax.debug.print("u2={u2} comp={c} lam={lam}",
                            u2=psum(u @ u, axis), c=compliance, lam=lam)

        # KS of 1/BLF (reference :641-700) + sign-invariant Q aggregate
        mu = 1.0 / lam
        c = jnp.max(mu)
        ks = c + jnp.log(jnp.sum(jnp.exp(ks_rho * (mu - c)))) / ks_rho
        line = d * part.L + jnp.arange(part.n_local) // b
        within = jnp.arange(part.n_local) % b
        w = masks[d] * jnp.sin(0.37 * line + 0.11 * within)
        qagg = psum(jnp.sum((w[:, None] * Q) ** 2), axis)
        return ks + qweight * qagg + 0.1 * compliance

    solve_local = partial(shard_map, mesh=mesh,
                          in_specs=(P(axis), P(axis), P(axis), P(axis)),
                          out_specs=P())(solve_local_fn)

    def objective(x):
        rho = fltr.apply(x)
        rhoE = fem.element_density(rho, conn)
        rhoE_cm = rhoE[gsafe] * real
        return solve_local(rhoE_cm, Be_cm, Te_cm, dJ_cm)

    return objective, fltr, mesh, part


# ---------------------------------------------------------------------------
# Sharded CRM wingbox objective (station-partitioned; VERDICT r1 §5)
# ---------------------------------------------------------------------------


def make_sharded_crm_objective(n_devices, nspan=8, nchord=4, nheight=2,
                               N=4, m=40, adjoint_maxiter=24, nrestart=2,
                               cg_maxiter=300, axis="grid", mesh=None,
                               crm_kwargs=None):
    """Station-sharded wingbox modal-compliance objective.

    The CRM's padded DOF layout is already station-major (node DOF index =
    station * b + 6 * rank, models/crm.py), and every shell element couples
    only adjacent span stations — exactly the "node line" structure the
    grid sharding layer partitions (grid.GridPartition with line_dofs = b).
    Device d owns stations [d*L, (d+1)*L) and the elements whose lowest
    station falls in that range; a matvec needs one halo station from the
    right neighbour (two ppermutes per apply). The shift-invert factor is
    the same one-level Schwarz-PCG used by the plane-stress objectives,
    with the device-local station block-tridiagonal Cholesky as the
    preconditioner. This is the on-device role of the MPI-parallel TACS
    assembly + solve in the reference (crm.py:11,62-144).

    Returns (objective(tcomp) -> modal compliance, crm, mesh, part); the
    objective matches the serial ``CRM.get_modal_compliance`` with the tip
    load, so serial-vs-sharded value and gradient parity is testable.
    """
    from ..fem.shell import shell_element_matrices
    from ..models.crm import CRM
    from ..ops.autodiff import EigProblem, EighGenConfig, eigh_gen

    if mesh is None:
        mesh = Mesh(np.array(jax.devices()[:n_devices]), (axis,))

    crm = CRM(nspan=nspan, nchord=nchord, nheight=nheight, N=N, m=m,
              **(crm_kwargs or {}))
    nb, b = crm.nb, crm.b
    part = make_partition(nx=nb - 1, ny=crm.b_nodes - 1, ndev=n_devices,
                          ndof=6)
    assert part.line_dofs == b, (part.line_dofs, b)
    L = part.L

    # -- host-side element buckets by owning station -------------------------
    dofs_g = np.asarray(crm.dofs)  # (nelems, 24) global, station-padded
    st_e = dofs_g.min(axis=1) // b
    st_hi = dofs_g.max(axis=1) // b
    assert np.all(st_hi <= st_e + 1), "element spans >2 stations"
    dev_e = st_e // L
    counts = np.bincount(dev_e, minlength=n_devices)
    Emax = max(int(counts.max()), 1)

    Xe_all = np.asarray(crm.X)[np.asarray(crm.conn)]  # (nelems, 4, 3)
    comp_all = np.asarray(crm.comp)
    fm_g = np.asarray(crm.free_mask)

    # padded element slots carry a unit dummy quad: a degenerate (all-zero)
    # element makes shell_element_matrices produce NaN frames, and the
    # 0-mask cannot cancel a NaN (0 * nan = nan)
    Xe_cm = np.zeros((n_devices * Emax, 4, 3))
    Xe_cm[:] = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                         [1.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    comp_cm = np.zeros(n_devices * Emax, dtype=np.int32)
    dofs_cm = np.zeros((n_devices * Emax, 24), dtype=np.int32)
    me_cm = np.zeros((n_devices * Emax, 24))
    fill = np.zeros(n_devices, dtype=np.int64)
    for e in range(dofs_g.shape[0]):
        d = int(dev_e[e])
        s = d * Emax + int(fill[d])
        fill[d] += 1
        Xe_cm[s] = Xe_all[e]
        comp_cm[s] = comp_all[e]
        dofs_cm[s] = dofs_g[e] - d * L * b
        me_cm[s] = fm_g[dofs_g[e]]
    assert dofs_cm.min() >= 0 and dofs_cm.max() < (L + 1) * b

    # free mask / tip load, station-partitioned (global layout IS the
    # padded layout up to trailing pad stations)
    def _shard_vec(v):
        full = np.zeros(part.n_padded)
        full[: v.shape[0]] = v
        return jnp.asarray(full.reshape(n_devices, part.n_local))

    free_sh = _shard_vec(fm_g)
    f_sh = _shard_vec(np.asarray(crm.tip_load()))

    Xe_cm = jnp.asarray(Xe_cm)
    comp_cm = jnp.asarray(comp_cm)
    dofs_cm = jnp.asarray(dofs_cm)
    me_cm = jnp.asarray(me_cm)

    def solve_local_fn(t_l, Xe_l, me_l, dofs_l):
        d = jax.lax.axis_index(axis)
        fm_l = free_sh[d]

        def assemble(te):
            Ke, Me = shell_element_matrices(Xe_l, te, E=crm.E,
                                            nu=crm.nu, rho=crm.rho)
            Ke = Ke * me_l[:, :, None] * me_l[:, None, :]
            Me = Me * me_l[:, :, None] * me_l[:, None, :]
            return (GridHaloOperator(Ke, dofs_l, part, axis),
                    GridHaloOperator(Me, dofs_l, part, axis))

        def factor_fn(A, B, sig, mode):
            assert mode == "normal"
            # exact distributed substructuring factor: the shell matrix's
            # ~1e8 bending/membrane conditioning defeats one-level
            # Schwarz-PCG (observed: no convergence in 300 iterations)
            return StationSchurFactor.build(A.mats - sig * B.mats, dofs_l,
                                            part, axis)

        def v0_fn(te):
            key = jax.random.PRNGKey(12345)
            v = jax.random.uniform(key, (part.n_local,), dtype=jnp.float64,
                                   minval=-1.0, maxval=1.0)
            return v * fm_l

        problem = EigProblem(assemble=assemble, factor=factor_fn, v0=v0_fn)
        cfg = EighGenConfig(N=N, m=m, sigma=0.0,
                            adjoint_method=crm.adjoint_method,
                            adjoint_maxiter=adjoint_maxiter,
                            nrestart=nrestart, eig_atol=crm.eig_atol,
                            axis=axis)
        lam, Q = eigh_gen(t_l, problem, cfg)
        vals = psum(f_sh[d] @ Q, axis)  # (N,) modal load participation
        return jnp.sum(vals**2 / lam)

    solve_local = partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P())(solve_local_fn)

    def objective(tcomp):
        # per-element thickness gathered OUTSIDE the shard_map so the
        # differentiable input is itself element-sharded (a replicated
        # differentiated shard_map operand trips a GSPMD sharding-override
        # assert in the transpose); the VJP chains back through the gather
        t_cm = tcomp[comp_cm]
        return solve_local(t_cm, Xe_cm, me_cm, dofs_cm)

    return objective, crm, mesh, part


def _psum_gather(x, ndev, axis):
    """all_gather via one-hot psum: scatter this device's value into its
    slot of a (ndev, ...) buffer and all-reduce. Functionally identical to
    jax.lax.all_gather; used because all_gather outputs stored as custom-VJP
    residuals trip shard_map's replication-variance bookkeeping (observed:
    "Unexpected XLA sharding override" asserts / tracer-leak errors in the
    transpose), while psum residuals are exercised everywhere and safe."""
    d = jax.lax.axis_index(axis)
    buf = jnp.zeros((ndev,) + x.shape, dtype=x.dtype)
    buf = jax.lax.dynamic_update_index_in_dim(buf, x, d, 0)
    return jax.lax.psum(buf, axis)


def local_station_chain(mats, dofs, part: GridPartition):
    """This device's full station-chain blocks INCLUDING the right
    interface: (L+1, b, b) diagonal blocks D (D[L] = this device's element
    contributions to the neighbour's first station) and (L, b, b)
    sub-diagonal blocks E with E[i] = A[station i+1, station i].

    Unlike ``local_line_blocks`` (which drops halo couplings — one-level
    additive Schwarz), nothing is dropped: these are the exact subdomain
    matrices A_d with support on stations [dL, dL+L], so sum_d A_d = A.
    """
    L, b = part.L, part.line_dofs
    dtype = mats.dtype
    li = dofs // b  # (ne, d) station of each element dof (0..L)
    wi = dofs % b

    same = (li[:, :, None] == li[:, None, :])
    lower = (li[:, :, None] == li[:, None, :] + 1)

    D = jnp.zeros((L + 2, b, b), dtype=dtype)
    d_idx = jnp.where(same, li[:, :, None], L + 1)
    D = D.at[d_idx, wi[:, :, None], wi[:, None, :]].add(
        jnp.where(same, mats, 0.0))
    D = D[: L + 1]

    E = jnp.zeros((L + 1, b, b), dtype=dtype)
    e_idx = jnp.where(lower, li[:, None, :], L)  # index by the lower station
    E = E.at[e_idx, wi[:, :, None], wi[:, None, :]].add(
        jnp.where(lower, mats, 0.0))
    E = E[:L]
    return D, E


def _unit_diag_fix(D):
    """Unit diagonal on empty (masked / padded) DOFs so Cholesky exists."""
    diag = jnp.diagonal(D, axis1=-2, axis2=-1)
    fix = (diag == 0.0).astype(D.dtype)
    return D + jax.vmap(jnp.diag)(fix) if D.ndim == 3 else D + jnp.diag(fix)


@jax.tree_util.register_pytree_node_class
class StationSchurFactor:
    """EXACT distributed direct solve of a station-block-tridiagonal SPD
    matrix partitioned over a 1-D device mesh — substructuring (a.k.a.
    block cyclic reduction across devices):

    * build: each device Cholesky-factors its INTERIOR station chain
      (stations dL+1 .. dL+L-1 — these couple only to this device's
      elements), forms the 2b x 2b Schur complement onto its two interface
      stations (dL and (d+1)L), and one all_gather assembles the replicated
      (ndev+1)-station reduced block tridiagonal system.
    * apply: one local interior solve, one all_gather of the (2, b, k)
      interface right-hand-side shares, one replicated reduced solve, one
      local back-substitution. Exact f64 direct solve, one collective per
      apply.

    This is the distributed role SuperLU+MPI-TACS play in the reference's
    CRM (crm.py:62-144), built for a device mesh. Unlike the one-level
    Schwarz-PCG (whose conditioning fails on shell matrices with ~1e8
    bending/membrane spread), the apply is exact regardless of
    conditioning.
    """

    def __init__(self, Tint, W0, W1, E0, Elast, red, part, axis):
        self.Tint = Tint  # interior-chain factor (None when L == 1)
        self.W0 = W0  # (n_int, b) = Tint^{-1} (e_1 (x) E0)
        self.W1 = W1  # (n_int, b) = Tint^{-1} (e_last (x) Elast^T)
        self.E0 = E0  # (b, b) A[first interior, I_d]
        self.Elast = Elast  # (b, b) A[I_{d+1}, last interior]
        self.red = red  # replicated reduced interface factor
        self.part = part
        self.axis = axis

    @classmethod
    def build(cls, mats, dofs, part: GridPartition, axis: str):
        from ..ops.blockfactor import BlockTridiagFactor

        L, b = part.L, part.line_dofs
        D, E = local_station_chain(mats, dofs, part)
        if L > 1:
            Tint = BlockTridiagFactor.from_blocks(
                _unit_diag_fix(D[1:L]), E[1: L - 1])
            E0, Elast = E[0], E[L - 1]
            n_int = (L - 1) * b
            R0 = jnp.zeros((n_int, b), dtype=D.dtype).at[:b].set(E0)
            R1 = jnp.zeros((n_int, b), dtype=D.dtype).at[-b:].set(Elast.T)
            W0 = Tint.mv(R0)
            W1 = Tint.mv(R1)
            S00 = D[0] - E0.T @ W0[:b]
            S10 = -Elast @ W0[-b:]
            S11 = D[L] - Elast @ W1[-b:]
        else:
            Tint, W0, W1 = None, None, None
            E0 = Elast = E[0]
            S00, S10, S11 = D[0], E[0], D[1]

        Sg = _psum_gather(jnp.stack([S00, S10, S11]), part.ndev, axis)
        ndev = part.ndev
        Dr = jnp.zeros((ndev + 1, b, b), dtype=D.dtype)
        Dr = Dr.at[:-1].add(Sg[:, 0]).at[1:].add(Sg[:, 2])
        red = BlockTridiagFactor.from_blocks(_unit_diag_fix(Dr), Sg[:, 1])
        return cls(Tint, W0, W1, E0, Elast, red, part, axis)

    @property
    def shape(self):
        n = self.part.n_local
        return (n, n)

    @property
    def dtype(self):
        return self.E0.dtype

    def mv(self, r):
        part, axis = self.part, self.axis
        L, b, ndev = part.L, part.line_dofs, part.ndev
        squeeze = r.ndim == 1
        if squeeze:
            r = r[:, None]
        k = r.shape[1]
        rb = r.reshape(L, b, k)
        r_I = rb[0]
        if L > 1:
            r_int = rb[1:].reshape((L - 1) * b, k)
            y = self.Tint.mv(r_int)
            sh0 = r_I - self.E0.T @ y[:b]
            sh1 = -self.Elast @ y[-b:]
        else:
            y = None
            sh0, sh1 = r_I, jnp.zeros_like(r_I)
        g = _psum_gather(jnp.stack([sh0, sh1]), ndev, axis)  # (ndev, 2, b, k)
        rhs = jnp.zeros((ndev + 1, b, k), dtype=r.dtype)
        rhs = rhs.at[:-1].add(g[:, 0]).at[1:].add(g[:, 1])
        xI = self.red.mv(rhs.reshape(-1, k)).reshape(ndev + 1, b, k)
        d = jax.lax.axis_index(axis)
        xI_own = jnp.take(xI, d, axis=0)
        if L > 1:
            xI_right = jnp.take(xI, d + 1, axis=0)
            x_int = y - self.W0 @ xI_own - self.W1 @ xI_right
            x = jnp.concatenate([xI_own[None], x_int.reshape(L - 1, b, k)])
        else:
            x = xI_own[None]
        x = x.reshape(L * b, k)
        if squeeze:
            x = x[:, 0]
        return x

    def __call__(self, x):
        return self.mv(x)

    def tree_flatten(self):
        return ((self.Tint, self.W0, self.W1, self.E0, self.Elast,
                 self.red), (self.part, self.axis))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)
