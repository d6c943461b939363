"""JAX autodiff integration: the ``eigh_gen`` custom-VJP primitive.

The reference implements reverse mode by hand as a three-phase protocol
(initialize / initialize_adjoint / finalize_adjoint — SURVEY.md §1). Here the
same mathematics is registered as the VJP rule of a generalized eigensolve, so

    lam, Phi = eigh_gen(theta, problem, cfg)

composes with ``jax.grad`` end to end: seeds (lam_bar, Phi_bar) arrive from
whatever differentiable objective consumes the eigenpairs, the rule runs the
Lanczos-adjoint solve (LAA guess + SIBK, reference eigenvector_derivatives.py:
1704-1770) with the repeated-eigenvalue correction, and the matrix cotangents
are chained through the (ordinary-JAX-differentiable) assembly by a VJP of the
bilinear forms  sum_i w_i^T A(theta) phi_i — the matrix-free equivalent of the
reference's dAdx/dBdx callbacks (:33-182).
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from . import adjoint as adj
from .collective import pdot, psum
from .factor import make_shift_factor
from .lanczos import lanczos_solve
from .operators import as_operator


@dataclasses.dataclass(frozen=True)
class EighGenConfig:
    """Static configuration of the eigh_gen primitive (hashable).

    lanczos_tol : enables the adaptive early-exit Lanczos iteration (normal
        mode) with this convergence tolerance; None runs all m steps.
    axis : shard_map axis name when the DOF dimension is sharded over a
        device mesh (SURVEY.md §5.7-5.8); all solver inner products are then
        psum-reduced over it.
    """

    N: int = 6
    m: int = 60
    sigma: float = 0.0
    mode: str = "normal"
    adjoint_method: str = "sibk"
    adjoint_maxiter: int = 50
    adjoint_rtol: float = 1e-12
    nrestart: int = 2
    eig_atol: float = 1e-5
    factor_kind: str = "cholesky"
    seed: int = 12345
    lanczos_tol: float = None
    axis: str = None
    block: int = 1  # forward Lanczos block size (p vectors per factor apply)
    adjoint_mixed: bool = False  # f32 SIBK ladder + f64 restarts (GMRES-IR)
    adjoint_ladder: str = "approx"  # mixed-sibk per-step apply: "approx"
    # (f32 PCG to ~1e-5) or "precond" (ONE raw V-cycle per step — ~10x
    # cheaper, weaker per-round contraction; rounds restart on true
    # residuals either way). See adj.sibk.
    lanczos_ortho: str = "full"  # "local": 3-term recurrence + Gram-RR
    lanczos_check_every: int = 1  # adaptive-exit check cadence (each check
    # is an (m, m) reduced eigh)
    polish: int = 0  # shift-invert subspace-iteration steps applied to the
    # selected Ritz block at extraction (one accurate factor apply each);
    # damps the f32-sweep basis-noise floor in eigenVECTOR contractions —
    # see lanczos.polish_ritz_block. 1 is enough at 1M DOF; 0 skips.
    polish_spare: int = 0  # extra Ritz vectors carried through the polish
    # (block path): moves the subspace-iteration contraction boundary from
    # lam_{N+1} to lam_{N+spare+1} so errors in NEARBY directions damp too.
    lanczos_sweep: str = "exact"  # "approx": drive the forward block-Lanczos
    # sweep with factor.approx_mv (f32 preconditioner-quality solves) and
    # recover eigenpair accuracy with the Ritz polish — the forward analog
    # of the adjoint's mixed ladder. Requires polish >= 1 to be useful; the
    # factor's accurate mv is then applied only polish times instead of
    # once per block step. Block path only (block > 1).
    measure_eig_res: bool = False  # block solver, polish == 0: measure the
    # TRUE pencil residual of the selected block at extraction (two thin
    # operator applies) into LanczosResult.eig_res_measured, so downstream
    # convergence gates never rely on the coupling-bound estimate — which
    # under lanczos_ortho="local" + lanczos_sweep="approx" can understate
    # the true residual by orders. With polish >= 1 the measurement is
    # already free (polish_ritz_block) and this flag is redundant.



# ---------------------------------------------------------------------------
# Dense-matrix entry point (A, B explicit) — used by tests and small problems
# ---------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def eigh_gen_dense(A, B, cfg: EighGenConfig):
    """N smallest eigenpairs of A phi = lam B phi for dense (n, n) A, B."""
    lam, Phi, _ = _forward(A, B, cfg)
    return lam, Phi


def _forward(A, B, cfg):
    factor = make_shift_factor(A, B, cfg.sigma, mode=cfg.mode,
                               kind=cfg.factor_kind)
    res = lanczos_solve(as_operator(A), as_operator(B), factor, cfg.sigma,
                        cfg.N, cfg.m, mode=cfg.mode, seed=cfg.seed)
    return res.lam, res.Phi, (res, factor)


def _eigh_gen_dense_fwd(A, B, cfg):
    lam, Phi, (res, factor) = _forward(A, B, cfg)
    return (lam, Phi), (A, B, res, factor)


def solve_eig_adjoint(A, B, res, factor, lam_bar, Phi_bar, cfg,
                      deflate=None):
    """Shared reverse-pass core: adjoint solve + correction + weight blocks.

    ``deflate``: the (U, BU) basis deflated out of the forward Lanczos
    iteration (rigid modes); pcpg resolves those components explicitly
    (the projected operator is indefinite there, see adj.pcpg).

    Returns (W_A, W_B, Phi) such that the matrix cotangents are
      A_bar =  W_A Phi^T,  B_bar = -W_B Phi^T   (normal mode)
      A_bar =  W_A Phi^T,  B_bar = +W_B Phi^T   (buckling mode)
    """
    if cfg.adjoint_method == "dl":
        # Exact reverse-mode through the Lanczos recurrence — needs the
        # single-vector three-term chain (alpha/beta), which the block
        # solver does not produce.
        if cfg.block > 1:
            raise ValueError(
                "adjoint_method='dl' requires the single-vector Lanczos "
                "solver (block=1); the block solver has no three-term "
                "chain (same restriction as the reference's IRAM, "
                "eigenvector_derivatives.py:2040-2043).")
        psi, data = adj.dl(Phi_bar, B, factor, res, mode=cfg.mode,
                           eig_atol=cfg.eig_atol)
        W_A, W_B = adj.total_derivative_weights(
            res.lam, res.Phi, lam_bar, Phi_bar, psi, adj_corr_data=data,
            mode=cfg.mode, axis=cfg.axis)
        return W_A, W_B, res.Phi

    psi0 = adj.laa(Phi_bar, B, factor, res, b_ortho=True, mode=cfg.mode,
                   axis=cfg.axis,
                   approx=(cfg.adjoint_mixed
                           and cfg.adjoint_method in ("sibk", "pcpg")))
    if cfg.adjoint_method == "laa":
        psi, data = adj.generate_adjoint_correction(
            res.lam, res.Phi, psi0, Phib=Phi_bar, eig_atol=cfg.eig_atol,
            mode=cfg.mode, axis=cfg.axis)
    elif cfg.adjoint_method == "sibk":
        psi, data, _ = adj.sibk(
            Phi_bar, A, B, res.lam, res.Phi, mode=cfg.mode, psi=psi0,
            sigma=res.sigma, factor=factor, rtol=cfg.adjoint_rtol,
            eig_atol=cfg.eig_atol, maxiter=cfg.adjoint_maxiter,
            nrestart=cfg.nrestart, axis=cfg.axis, mixed=cfg.adjoint_mixed,
            ladder=cfg.adjoint_ladder)
    elif cfg.adjoint_method == "pcpg":
        # adjoint_mixed: precondition with ONE f32 V-cycle (mg) or one f32
        # direct-factor apply instead of the exact f64 solve — CG supplies
        # the convergence control the exact apply duplicated, cutting the
        # per-iteration cost ~15x at 1M DOF (see adj.pcpg docstring).
        precond = None
        if cfg.adjoint_mixed:
            precond = (getattr(factor, "precond_mv", None)
                       or getattr(factor, "approx_mv", None))
        psi, data, _ = adj.pcpg(
            Phi_bar, A, B, res.lam, res.Phi, mode=cfg.mode, psi=psi0,
            factor=factor, rtol=cfg.adjoint_rtol, eig_atol=cfg.eig_atol,
            maxiter=cfg.adjoint_maxiter, axis=cfg.axis, precond=precond,
            deflate=deflate)
    elif cfg.adjoint_method == "pgmres":
        psi, data, _ = adj.pgmres(
            Phi_bar, A, B, res.lam, res.Phi, mode=cfg.mode, psi=psi0,
            factor=factor, rtol=cfg.adjoint_rtol, eig_atol=cfg.eig_atol,
            maxiter=cfg.adjoint_maxiter, axis=cfg.axis)
    else:
        raise ValueError(f"Unknown adjoint method {cfg.adjoint_method!r}")

    W_A, W_B = adj.total_derivative_weights(
        res.lam, res.Phi, lam_bar, Phi_bar, psi, adj_corr_data=data,
        mode=cfg.mode, axis=cfg.axis)
    return W_A, W_B, res.Phi


def _eigh_gen_dense_bwd(cfg, saved, cotangents):
    A, B, res, factor = saved
    lam_bar, Phi_bar = cotangents
    W_A, W_B, Phi = solve_eig_adjoint(A, B, res, factor, lam_bar, Phi_bar, cfg)
    A_bar = W_A @ Phi.T
    if cfg.mode == "normal":
        B_bar = -(W_B @ Phi.T)
    else:
        B_bar = W_B @ Phi.T
    return A_bar, B_bar


eigh_gen_dense.defvjp(_eigh_gen_dense_fwd, _eigh_gen_dense_bwd)


# ---------------------------------------------------------------------------
# General parameterized entry point: theta -> assemble -> operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EigProblem:
    """Static description of a parameterized generalized eigenproblem.

    assemble(theta) must be JAX-differentiable and return a pair of Operators
    (A, B). The eigh_gen VJP chains the eigen-cotangents into theta via a VJP
    of the bilinear forms of assemble — no hand-written dA/dx needed.

    nullspace(theta), if given, returns a (k, n) row basis of a known null
    space of A (e.g. rigid-body modes); the Lanczos iteration deflates it
    instead of computing and discarding those modes.

    factor(A, B, sigma, mode), if given, overrides the default dense
    Cholesky shift-invert factor (e.g. with a BlockTridiagFactor).

    v0(theta), if given, supplies the Lanczos start vector (used by the
    sharded path to zero padded DOFs; default is a fixed-seed random vector).
    """

    assemble: Callable  # theta -> (A, B) operators
    nullspace: Callable = None  # theta -> (k, n) rows, optional
    factor: Callable = None  # (A, B, sigma, mode) -> factor, optional
    v0: Callable = None  # theta -> (n,) start vector, optional


@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def eigh_gen(theta, problem: EigProblem, cfg: EighGenConfig):
    """N smallest eigenpairs of A(theta) phi = lam B(theta) phi."""
    A, B = problem.assemble(theta)
    lam, Phi, _ = _forward_ops(theta, problem, A, B, cfg)
    return lam, Phi


def _forward_ops(theta, problem, A, B, cfg):
    if problem.factor is not None:
        factor = problem.factor(A, B, cfg.sigma, cfg.mode)
    else:
        factor = make_shift_factor(A, B, cfg.sigma, mode=cfg.mode,
                                   kind=cfg.factor_kind)
    deflate = None
    if problem.nullspace is not None:
        from .lanczos import b_orthonormalize_rows

        U0 = problem.nullspace(theta)
        deflate = b_orthonormalize_rows(U0, B.mv, axis=cfg.axis)
    v0 = problem.v0(theta) if problem.v0 is not None else None
    if cfg.block > 1:
        from .lanczos import block_lanczos_solve

        res = block_lanczos_solve(A, B, factor, cfg.sigma, cfg.N, cfg.m,
                                  cfg.block, mode=cfg.mode, seed=cfg.seed,
                                  deflate=deflate, axis=cfg.axis,
                                  tol=cfg.lanczos_tol, v0=v0,
                                  ortho=cfg.lanczos_ortho,
                                  check_every=cfg.lanczos_check_every,
                                  polish=cfg.polish,
                                  polish_spare=cfg.polish_spare,
                                  sweep=cfg.lanczos_sweep,
                                  measure_res=cfg.measure_eig_res)
    else:
        res = lanczos_solve(A, B, factor, cfg.sigma, cfg.N, cfg.m,
                            mode=cfg.mode, seed=cfg.seed, deflate=deflate,
                            axis=cfg.axis, tol=cfg.lanczos_tol, v0=v0,
                            check_every=max(cfg.lanczos_check_every, 8),
                            polish=cfg.polish)
    return res.lam, res.Phi, (res, factor)


def _eigh_gen_fwd(theta, problem, cfg):
    A, B = problem.assemble(theta)
    lam, Phi, (res, factor) = _forward_ops(theta, problem, A, B, cfg)
    # Slim the saved state: the reverse pass (laa guess + Krylov adjoint +
    # correction) reads res.V / Ys / theta / lam / Phi but never res.BV —
    # dropping it saves an (m, n) f64 buffer (1.5 GB at 1M DOF) across the
    # whole forward-to-backward live range. BV is dropped as None (an empty
    # pytree subtree), not a (0, 0) placeholder array, so the program
    # carries no zero-sized saved buffer.
    import dataclasses as _dc

    res_slim = _dc.replace(res, BV=None)
    return (lam, Phi), (theta, A, B, res_slim, factor)


def _eigh_gen_bwd(problem, cfg, saved, cotangents):
    theta, A, B, res, factor = saved
    lam_bar, Phi_bar = cotangents
    deflate = None
    if problem.nullspace is not None and cfg.adjoint_method == "pcpg":
        from .lanczos import b_orthonormalize_rows

        deflate = b_orthonormalize_rows(problem.nullspace(theta), B.mv,
                                        axis=cfg.axis)
    W_A, W_B, Phi = solve_eig_adjoint(A, B, res, factor, lam_bar, Phi_bar,
                                      cfg, deflate=deflate)

    sign_b = -1.0 if cfg.mode == "normal" else 1.0

    def bilinear(th):
        A2, B2 = problem.assemble(th)
        fA = jnp.sum(W_A * A2.mv(Phi))
        fB = jnp.sum(W_B * B2.mv(Phi))
        return fA + sign_b * fB

    theta_bar = jax.grad(bilinear)(theta)
    return (theta_bar,)


eigh_gen.defvjp(_eigh_gen_fwd, _eigh_gen_bwd)


# ---------------------------------------------------------------------------
# Forward-mode entry point: jax.jvp through the eigensolve
# ---------------------------------------------------------------------------


@partial(jax.custom_jvp, nondiff_argnums=(1, 2))
def eigh_gen_fwdmode(theta, problem: EigProblem, cfg: EighGenConfig):
    """``eigh_gen`` with a *forward-mode* (custom_jvp) derivative rule.

    This is the replacement for the reference's complex-step
    channel (BasicLanczos._eigh propagates an imaginary perturbation as an
    analytic forward-mode derivative of the eigendecomposition,
    eigenvector_derivatives.py:1387-1414): ``jax.jvp`` of any objective
    through this function yields the exact directional derivative, usable
    as a machine-precision oracle against the reverse-mode ``eigh_gen``.

    Same primal as :func:`eigh_gen`; JAX does not allow one callable to
    carry both a custom VJP and a custom JVP, hence the paired entry point.
    Supports mode="normal" and mode="buckling" (the latter mirroring the
    reference's complex-step verification of buckling derivatives,
    buckling.py:1014-1023 — see the buckling branch in
    :func:`eigh_gen_tangent` for the tangent identities).

    Tangent rule (normal mode; B-orthonormal eigenvectors):
      dlam_i = phi_i^T (dA - lam_i dB) phi_i
      dphi_i = v_i + sum_{j in solved} c_ij phi_j,  where v_i solves the
        projected singular system (A - lam_i B) v_i = -(I - B Phi Phi^T) W_i
        with W_i = (dA - lam_i dB) phi_i (the SAME linear systems as the
        adjoint — solved by the configured adjoint method), and for the
        solved modes c_ij = (phi_j^T W_i)/(lam_i - lam_j) for distinct
        pairs, c_ij = -1/2 phi_j^T dB phi_i inside numerically repeated
        clusters and on the diagonal (the degenerate-rotation suppression
        of the dense oracle, :func:`eigh_gen_directional_oracle`).
    """
    A, B = problem.assemble(theta)
    lam, Phi, _ = _forward_ops(theta, problem, A, B, cfg)
    return lam, Phi


def eigh_gen_tangent(theta, dtheta, problem, cfg, fwd=None):
    """Shared forward-mode tangent core (the :func:`eigh_gen_fwdmode` JVP
    rule body). ``fwd``, if given, is an already-computed forward solve
    ``(A, B, res, factor)`` — used by :func:`staged_jvp` to split the
    forward and tangent solves into separate programs at sizes where one
    fused executable is fragile (same motivation as
    :func:`staged_value_and_grad`).

    Returns (lam, Phi, dlam, dPhi).
    """
    if cfg.mode not in ("normal", "buckling"):
        raise NotImplementedError(
            f"eigh_gen_fwdmode: mode={cfg.mode!r} has no tangent rule "
            "(normal and buckling are supported).")
    if fwd is None:
        A, B = problem.assemble(theta)
        lam, Phi, (res, factor) = _forward_ops(theta, problem, A, B, cfg)
    else:
        A, B, res, factor = fwd
        lam, Phi = res.lam, res.Phi

    # Tangent operators via linearity of mv in the assembled matrix data:
    # jvp through assemble gives dA, dB applied to the solved eigenvectors.
    def apply_both(th):
        A2, B2 = problem.assemble(th)
        return A2.mv(Phi), B2.mv(Phi)

    (_, _), (dAP, dBP) = jax.jvp(apply_both, (theta,), (dtheta,))
    if cfg.mode == "buckling":
        # Pencil K phi + lam G phi = 0 with (A, B) = (G, K) and
        # K-orthonormal Phi (models/buckling.py; reference buckling.py:
        # 1014-1023 is the complex-step channel this replaces). Tangent
        # identities (phi^T G phi = -1/lam):
        #   W_i    = (dK + lam_i dG) phi_i = (dB + lam_i dA) phi_i
        #   dlam_i = lam_i phi_i^T W_i
        # and the eigenvector tangent solves the SAME projected system as
        # the buckling adjoint, (K + lam_i G) v_i = -proj(W_i) — the
        # dlam_i G phi_i term is along K phi_i and dies under the
        # B-projection. generate_adjoint_correction's diag(lam) buckling
        # scale gives exactly the solved-pair couplings
        # c_ij = -lam_j phi_j^T W_i / (lam_j - lam_i).
        W = dBP + dAP * lam[None, :]
        dlam = lam * psum(jnp.sum(Phi * W, axis=0), cfg.axis)
    else:
        W = dAP - dBP * lam[None, :]  # W[:, i] = (dA - lam_i dB) phi_i
        dlam = psum(jnp.sum(Phi * W, axis=0), cfg.axis)

    # Unsolved-space component: the same projected singular systems as the
    # reverse pass, with RHS built from W instead of the cotangent seed.
    # sibk/pcpg/pgmres fold the distinct solved-pair couplings
    # (phi_j^T W_i)/(lam_i - lam_j) into psi via generate_adjoint_correction
    # (its G = -Phi^T W convention gives exactly that coefficient); the
    # repeated-cluster Xi/Eta data is adjoint-specific and discarded here.
    method = cfg.adjoint_method if cfg.adjoint_method in (
        "sibk", "pcpg", "pgmres", "laa") else "sibk"
    psi0 = adj.laa(W, B, factor, res, b_ortho=True, mode=cfg.mode,
                   axis=cfg.axis,
                   approx=(cfg.adjoint_mixed and method in ("sibk", "pcpg")))
    if method == "laa":
        psi, _ = adj.generate_adjoint_correction(
            lam, Phi, psi0, Phib=W, eig_atol=cfg.eig_atol, mode=cfg.mode,
            axis=cfg.axis)
    elif method == "pcpg":
        precond = None
        if cfg.adjoint_mixed:
            precond = (getattr(factor, "precond_mv", None)
                       or getattr(factor, "approx_mv", None))
        psi, _, _ = adj.pcpg(
            W, A, B, lam, Phi, mode=cfg.mode, psi=psi0, factor=factor,
            rtol=cfg.adjoint_rtol, eig_atol=cfg.eig_atol,
            maxiter=cfg.adjoint_maxiter, axis=cfg.axis, precond=precond)
    elif method == "pgmres":
        psi, _, _ = adj.pgmres(
            W, A, B, lam, Phi, mode=cfg.mode, psi=psi0, factor=factor,
            rtol=cfg.adjoint_rtol, eig_atol=cfg.eig_atol,
            maxiter=cfg.adjoint_maxiter, axis=cfg.axis)
    else:
        psi, _, _ = adj.sibk(
            W, A, B, lam, Phi, mode=cfg.mode, psi=psi0, sigma=res.sigma,
            factor=factor, rtol=cfg.adjoint_rtol, eig_atol=cfg.eig_atol,
            maxiter=cfg.adjoint_maxiter, nrestart=cfg.nrestart,
            axis=cfg.axis, mixed=cfg.adjoint_mixed,
            ladder=cfg.adjoint_ladder)

    # Solved-subspace terms the projected solve cannot carry: inside
    # numerically repeated clusters (and on the diagonal — the
    # B-normalization tangent phi_i^T B dphi_i = -1/2 phi_i^T dB phi_i)
    # the surviving coupling is the symmetric -dB/2 part.
    dBG = pdot(Phi.T, dBP, cfg.axis)  # (N, N) = Phi^T dB Phi
    diff = lam[:, None] - lam[None, :]
    close = jnp.abs(diff) < cfg.eig_atol  # includes the diagonal
    Cd = jnp.where(close, -0.5 * dBG, 0.0)
    dPhi = psi + Phi @ Cd
    return lam, Phi, dlam, dPhi


@eigh_gen_fwdmode.defjvp
def _eigh_gen_fwdmode_jvp(problem, cfg, primals, tangents):
    (theta,) = primals
    (dtheta,) = tangents
    lam, Phi, dlam, dPhi = eigh_gen_tangent(theta, dtheta, problem, cfg)
    return (lam, Phi), (dlam, dPhi)


def staged_jvp(pre, tail, problem: EigProblem, cfg: EighGenConfig):
    """Directional derivative of ``x -> tail(eigh_gen(pre(x)))`` by FORWARD
    mode, as two compiled programs (forward eigensolve / tangent solve).

    The forward-mode twin of :func:`staged_value_and_grad`, used as the
    jvp-vs-vjp gradient-consistency oracle at flagship scale (the
    replacement for the reference's complex-step channel at full size,
    eigd/eigenvector_derivatives.py:1387-1414): both modes
    share the identical primal solve, so |jvp - g.p| isolates solver /
    derivation error with no FD step size and no objective-smoothness
    requirement.

    Returns ``fn(x, p) -> (value, dvalue)`` backed by two cached jits;
    ``fn.fwd_prog`` is the forward program (reusable across directions).
    """
    import dataclasses as _dc

    @jax.jit
    def fwd_prog(x):
        theta = pre(x)
        A, B = problem.assemble(theta)
        lam, Phi, (res, factor) = _forward_ops(theta, problem, A, B, cfg)
        return _dc.replace(res, BV=None)

    @partial(jax.jit, donate_argnums=(2,))
    def tan_prog(x, p, res):
        theta, dtheta = jax.jvp(pre, (x,), (p,))
        A, B = problem.assemble(theta)
        if problem.factor is not None:
            factor = problem.factor(A, B, cfg.sigma, cfg.mode)
        else:
            factor = make_shift_factor(A, B, cfg.sigma, mode=cfg.mode,
                                       kind=cfg.factor_kind)
        lam, Phi, dlam, dPhi = eigh_gen_tangent(
            theta, dtheta, problem, cfg, fwd=(A, B, res, factor))
        return jax.jvp(tail, (lam, Phi), (dlam, dPhi))

    def fn(x, p):
        res = fwd_prog(x)
        return tan_prog(x, p, res)

    fn.fwd_prog = fwd_prog
    fn.tan_prog = tan_prog
    return fn


def staged_value_and_grad(pre, tail, problem: EigProblem,
                          cfg: EighGenConfig):
    """value_and_grad of ``x -> tail(eigh_gen(pre(x)))`` as TWO compiled
    programs (forward solve / reverse solve) instead of one fused jit.

    Why this exists: splitting at the custom-VJP seam lowers peak device
    memory at ~1M DOF (the reverse program never holds the forward's
    temporaries), and it once sidestepped a compiler fault in the fused
    1M program. Cost: one extra host dispatch and one repeat of the cheap
    ``pre`` chain inside the reverse program. Whether the fused program is
    as good on the GPU is ROADMAP D5.

    pre  : x -> theta (differentiable parameter chain: filter, densities)
    tail : (lam, Phi) -> scalar (differentiable objective head)

    Returns ``fn(x) -> (value, grad)`` backed by two cached jits.
    Mathematically identical to ``jax.jit(jax.value_and_grad(...))`` — the
    same solver code runs, just in separate executables (parity-tested
    against the fused path in
    tests/test_lanczos.py::TestStagedValueAndGrad).

    Program-boundary design: the only bulk array crossing the seam is the
    Lanczos basis ``res.V`` (the reverse solve's Galerkin guess needs it);
    it is donated into the reverse program. The operators A/B and the
    factorization are *recomputed from theta* inside the reverse program —
    they are deterministic functions of it, the factor build is ~1 s at
    1M DOF, and rebuilding lets XLA manage their lifetime instead of
    pinning ~2 GB of materialized program outputs across the boundary.
    """
    import dataclasses as _dc

    def _rebuild(theta):
        A, B = problem.assemble(theta)
        if problem.factor is not None:
            factor = problem.factor(A, B, cfg.sigma, cfg.mode)
        else:
            factor = make_shift_factor(A, B, cfg.sigma, mode=cfg.mode,
                                       kind=cfg.factor_kind)
        return A, B, factor

    @jax.jit
    def fwd_prog(x):
        theta = pre(x)
        A, B = problem.assemble(theta)
        lam, Phi, (res, factor) = _forward_ops(theta, problem, A, B, cfg)
        # BV is never read by the reverse pass; dropped as None, never a
        # zero-sized array (see the miscompile note in _eigh_gen_fwd)
        res = _dc.replace(res, BV=None)
        return res

    # EIGD_STAGED_NO_DONATE=1 keeps res alive across the seam — a
    # diagnostic lever for the 1M-DOF miscompile hunt: if the corruption
    # is a buffer-aliasing bug (donated V reused while a fused V-cycle
    # still reads it), disabling donation fixes it where barriers cannot.
    _donate = () if os.environ.get("EIGD_STAGED_NO_DONATE") else (1,)

    @partial(jax.jit, donate_argnums=_donate)
    def bwd_prog(x, res):
        theta, pre_vjp = jax.vjp(pre, x)
        A, B, factor = _rebuild(theta)
        v, tail_vjp = jax.vjp(tail, res.lam, res.Phi)
        lam_bar, Phi_bar = tail_vjp(jnp.ones_like(v))
        deflate = None
        if problem.nullspace is not None and cfg.adjoint_method == "pcpg":
            from .lanczos import b_orthonormalize_rows

            deflate = b_orthonormalize_rows(problem.nullspace(theta), B.mv,
                                            axis=cfg.axis)
        W_A, W_B, Phi = solve_eig_adjoint(A, B, res, factor, lam_bar,
                                          Phi_bar, cfg, deflate=deflate)
        sign_b = -1.0 if cfg.mode == "normal" else 1.0

        def bilinear(th):
            A2, B2 = problem.assemble(th)
            fA = jnp.sum(W_A * A2.mv(Phi))
            fB = jnp.sum(W_B * B2.mv(Phi))
            return fA + sign_b * fB

        theta_bar = jax.grad(bilinear)(theta)
        (x_bar,) = pre_vjp(theta_bar)
        return v, x_bar

    def fn(x):
        res = fwd_prog(x)
        return bwd_prog(x, res)

    fn.fwd_prog = fwd_prog
    fn.bwd_prog = bwd_prog
    return fn


# ---------------------------------------------------------------------------
def staged_eigh_gen_vjp(problem: EigProblem, cfg: EighGenConfig,
                        split_factor=False, chunk_adjoint=False,
                        chunk_forward=None):
    """The eigh_gen custom-VJP pair as separately-compiled programs, for
    three-phase model protocols (initialize / seed / finalize_adjoint,
    reference natural_frequency.py:394-519) at sizes where one fused
    forward+reverse executable is fragile.

    Same motivation as :func:`staged_value_and_grad`: split at the
    custom-VJP seam so the forward
    program never holds adjoint temporaries and the reverse program never
    holds the forward's. Only the slim Lanczos result crosses the seam;
    operators and the factorization are rebuilt from theta inside the
    reverse program (deterministic, ~seconds) instead of pinning GBs of
    saved factor blocks across the host boundary.

    ``split_factor=True`` splits ONE level further, at the factor seam:
    assembly + factor build compile as their own program (``build_prog``)
    and the Lanczos sweep / adjoint solve receive the operators and the
    factorization as *pytree arguments*, which bounds the size of any
    one program. The factor build program is shared (one compile) between the forward and reverse
    directions.

    ``chunk_adjoint=True`` (sibk only; implies ``split_factor``) dispatches
    the reverse solve ONE OUTER ROUND AT A TIME from the host instead of as
    one program, keeping each device execution short. The round
    granularity is set by ``cfg.adjoint_maxiter`` (ladder steps per round,
    i.e. per dispatch); the host loop reproduces :func:`adjoint.sibk`'s
    round convergence/stagnation control exactly (same eps_f recalibration,
    same <40%%-contraction stagnation exit), so the result matches the fused
    path (parity-tested in tests/test_adjoint.py).

    Returns ``(fwd_prog, bwd_prog)``:
      fwd_prog(theta) -> res                (res.lam, res.Phi = eigenpairs)
      bwd_prog(theta, res, lam_bar, Phi_bar) -> theta_bar
    ``chunk_forward=k`` (block solver only; implies ``split_factor``)
    dispatches the forward Lanczos sweep ``k`` block steps per program,
    with the sweep carry staying device-resident (donated) between
    dispatches, the adaptive-exit convergence check evaluated on the host
    from the (small) coupling matrix, and each Ritz-polish step its own
    dispatch. Same short-execution motivation; same math as the fused
    sweep (one compiled chunk program serves every chunk size — t0/nsteps
    are traced).

    Mathematically identical to ``jax.vjp(eigh_gen, theta)`` with the same
    problem/cfg (parity-tested in tests/test_crm.py).
    """
    import dataclasses as _dc

    if chunk_adjoint:
        if cfg.adjoint_method != "sibk":
            raise ValueError("chunk_adjoint requires adjoint_method='sibk' "
                             f"(got {cfg.adjoint_method!r})")
        split_factor = True
    if chunk_forward:
        if cfg.block <= 1:
            raise ValueError("chunk_forward requires the block Lanczos "
                             "solver (cfg.block > 1)")
        split_factor = True

    if not split_factor:
        @jax.jit
        def fwd_prog(theta):
            A, B = problem.assemble(theta)
            lam, Phi, (res, factor) = _forward_ops(theta, problem, A, B,
                                                   cfg)
            return _dc.replace(res, BV=None)
    else:
        @jax.jit
        def build_prog(theta):
            """Assembly + shift-invert factor build, as one program. The
            operators/factor cross the host seam as pytrees (they must be
            jit ARGUMENTS downstream: closure capture would bake the
            multi-GB factor blocks into the lowered programs as
            constants)."""
            A, B = problem.assemble(theta)
            if problem.factor is not None:
                factor = problem.factor(A, B, cfg.sigma, cfg.mode)
            else:
                factor = make_shift_factor(A, B, cfg.sigma, mode=cfg.mode,
                                           kind=cfg.factor_kind)
            deflate = None
            if problem.nullspace is not None:
                from .lanczos import b_orthonormalize_rows

                deflate = b_orthonormalize_rows(problem.nullspace(theta),
                                                B.mv, axis=cfg.axis)
            v0 = problem.v0(theta) if problem.v0 is not None else None
            return A, B, factor, deflate, v0

        @jax.jit
        def solve_prog(A, B, factor, deflate, v0):
            if cfg.block > 1:
                from .lanczos import block_lanczos_solve

                res = block_lanczos_solve(
                    A, B, factor, cfg.sigma, cfg.N, cfg.m, cfg.block,
                    mode=cfg.mode, seed=cfg.seed, deflate=deflate,
                    axis=cfg.axis, tol=cfg.lanczos_tol, v0=v0,
                    ortho=cfg.lanczos_ortho,
                    check_every=cfg.lanczos_check_every, polish=cfg.polish,
                    polish_spare=cfg.polish_spare, sweep=cfg.lanczos_sweep,
                    measure_res=cfg.measure_eig_res)
            else:
                res = lanczos_solve(
                    A, B, factor, cfg.sigma, cfg.N, cfg.m, mode=cfg.mode,
                    seed=cfg.seed, deflate=deflate, axis=cfg.axis,
                    tol=cfg.lanczos_tol, v0=v0,
                    check_every=max(cfg.lanczos_check_every, 8),
                    polish=cfg.polish)
            return _dc.replace(res, BV=None)

        if not chunk_forward:
            def fwd_prog(theta):
                A, B, factor, deflate, v0 = build_prog(theta)
                return solve_prog(A, B, factor, deflate, v0)
        else:
            from .collective import tdot
            from .lanczos import (block_coupling_converged_host,
                                  block_lanczos_extract, block_lanczos_start,
                                  block_lanczos_sweep_chunk,
                                  polish_ritz_block)

            p_blk = cfg.block
            q_blk = -(-cfg.m // p_blk)
            mtot = q_blk * p_blk
            spare = min(int(cfg.polish_spare), mtot - cfg.N) \
                if cfg.polish_spare else 0

            @jax.jit
            def start_prog(A, B, factor, deflate, v0):
                return block_lanczos_start(
                    A, B, factor, cfg.sigma, cfg.N, cfg.m, p_blk,
                    mode=cfg.mode, seed=cfg.seed, v0=v0, deflate=deflate,
                    axis=cfg.axis, ortho=cfg.lanczos_ortho,
                    sweep=cfg.lanczos_sweep)

            @partial(jax.jit, donate_argnums=(3,))
            def chunk_prog(A, B, factor, carry, deflate, t0, nsteps):
                return block_lanczos_sweep_chunk(
                    A, B, factor, carry, t0, nsteps, cfg.sigma, cfg.N,
                    cfg.m, p_blk, mode=cfg.mode, deflate=deflate,
                    axis=cfg.axis, ortho=cfg.lanczos_ortho,
                    sweep=cfg.lanczos_sweep)

            @jax.jit
            def extract_prog(A, B, factor, deflate, carry, niter):
                res = block_lanczos_extract(
                    A, B, factor, cfg.sigma, cfg.N, cfg.mode, carry, niter,
                    p_blk, cfg.lanczos_tol is not None,
                    ortho=cfg.lanczos_ortho, polish=0, deflate=deflate,
                    axis=cfg.axis)
                if cfg.polish and spare > 0:
                    sel_e = res.order[:cfg.N + spare]
                    lam_e = res.lam_all[sel_e]
                    Phi_e = tdot(carry[0][:mtot], res.Y[:, sel_e])
                    return res, lam_e, Phi_e
                return res, res.lam, res.Phi

            @jax.jit
            def polish_prog(A, B, factor, deflate, lam_e, Phi_e):
                return polish_ritz_block(A, B, factor, lam_e, Phi_e,
                                         cfg.sigma, cfg.mode,
                                         deflate=deflate, axis=cfg.axis,
                                         nsteps=1)

            def fwd_prog(theta):
                A, B, factor, deflate, v0 = build_prog(theta)
                carry = start_prog(A, B, factor, deflate, v0)
                t = 0
                while t < q_blk:
                    nst = min(int(chunk_forward), q_blk - t)
                    carry = chunk_prog(A, B, factor, carry, deflate, t, nst)
                    t += nst
                    if (cfg.lanczos_tol is not None and cfg.mode == "normal"
                            and t < q_blk):
                        # host mirror of the in-jit adaptive exit: the
                        # coupling matrix Hc is (mtot+p, mtot) — tiny
                        min_blocks = -(-cfg.N // p_blk) + 1
                        if t >= min_blocks and block_coupling_converged_host(
                                jax.device_get(carry[4]), t, p_blk, cfg.N,
                                cfg.lanczos_tol):
                            break
                res, lam_e, Phi_e = extract_prog(A, B, factor, deflate,
                                                 carry,
                                                 jnp.asarray(t * p_blk))
                if cfg.polish:
                    for _ in range(int(cfg.polish)):
                        lam_e, Phi_e, eig_res_e = polish_prog(
                            A, B, factor, deflate, lam_e, Phi_e)
                    res = _dc.replace(res, lam=lam_e[:cfg.N],
                                      Phi=Phi_e[:, :cfg.N],
                                      eig_res=eig_res_e[:cfg.N])
                return _dc.replace(res, BV=None)

            fwd_prog.start_prog = start_prog
            fwd_prog.chunk_prog = chunk_prog
            fwd_prog.extract_prog = extract_prog
            fwd_prog.polish_prog = polish_prog

        fwd_prog.build_prog = build_prog
        fwd_prog.solve_prog = solve_prog

    def _adjoint_core(theta, A, B, factor, deflate, res, lam_bar, Phi_bar):
        if cfg.adjoint_method != "pcpg":
            deflate = None
        W_A, W_B, Phi = solve_eig_adjoint(A, B, res, factor, lam_bar,
                                          Phi_bar, cfg, deflate=deflate)
        sign_b = -1.0 if cfg.mode == "normal" else 1.0

        def bilinear(th):
            A2, B2 = problem.assemble(th)
            fA = jnp.sum(W_A * A2.mv(Phi))
            fB = jnp.sum(W_B * B2.mv(Phi))
            return fA + sign_b * fB

        return jax.grad(bilinear)(theta)

    if not split_factor:
        @jax.jit
        def bwd_prog(theta, res, lam_bar, Phi_bar):
            A, B = problem.assemble(theta)
            if problem.factor is not None:
                factor = problem.factor(A, B, cfg.sigma, cfg.mode)
            else:
                factor = make_shift_factor(A, B, cfg.sigma, mode=cfg.mode,
                                           kind=cfg.factor_kind)
            deflate = None
            if problem.nullspace is not None \
                    and cfg.adjoint_method == "pcpg":
                from .lanczos import b_orthonormalize_rows

                deflate = b_orthonormalize_rows(problem.nullspace(theta),
                                                B.mv, axis=cfg.axis)
            return _adjoint_core(theta, A, B, factor, deflate, res,
                                 lam_bar, Phi_bar)
    elif chunk_adjoint:
        import numpy as _np

        @jax.jit
        def guess_prog(A, B, factor, res, Phi_bar):
            psi0 = adj.laa(Phi_bar, B, factor, res, b_ortho=True,
                           mode=cfg.mode, axis=cfg.axis,
                           approx=cfg.adjoint_mixed)
            resn0 = adj.sibk_true_resnorm(Phi_bar, A, B, res.lam, res.Phi,
                                          psi0, mode=cfg.mode, axis=cfg.axis)
            rnorm0 = jnp.sqrt(jnp.max(psum(
                jnp.sum(Phi_bar * Phi_bar, axis=0), cfg.axis)))
            tol = jnp.maximum(cfg.adjoint_rtol * rnorm0, 1e-30)
            return psi0, resn0, tol

        @jax.jit
        def round_prog(A, B, factor, lam, Phi, sigma, Phib, psi, eps_f):
            psi, resids, resn, _ = adj.sibk_round(
                Phib, A, B, lam, Phi, psi, eps_f, mode=cfg.mode,
                sigma=sigma, factor=factor, rtol=cfg.adjoint_rtol,
                maxiter=cfg.adjoint_maxiter, axis=cfg.axis,
                mixed=cfg.adjoint_mixed, ladder=cfg.adjoint_ladder)
            return psi, resids, resn

        @jax.jit
        def finish_prog(theta, A, B, res, psi, lam_bar, Phi_bar):
            psi, data = adj.sibk_finish(Phi_bar, B, res.lam, res.Phi, psi,
                                        mode=cfg.mode,
                                        eig_atol=cfg.eig_atol, axis=cfg.axis)
            W_A, W_B = adj.total_derivative_weights(
                res.lam, res.Phi, lam_bar, Phi_bar, psi,
                adj_corr_data=data, mode=cfg.mode, axis=cfg.axis)
            sign_b = -1.0 if cfg.mode == "normal" else 1.0
            Phi = res.Phi

            def bilinear(th):
                A2, B2 = problem.assemble(th)
                fA = jnp.sum(W_A * A2.mv(Phi))
                fB = jnp.sum(W_B * B2.mv(Phi))
                return fA + sign_b * fB

            return jax.grad(bilinear)(theta)

        def _chunked_solve(A, B, factor, res, Phib):
            """Host mirror of adj.sibk's round while_loop: one dispatch per
            round keeps every device execution short. Used
            for the reverse solve (Phib = cotangent seed) AND the tangent
            solve (Phib = W, the forward-mode RHS — identical systems)."""
            psi, resn, tol = guess_prog(A, B, factor, res, Phib)
            resn_h = _np.asarray(jax.device_get(resn))
            tol_h = float(jax.device_get(tol))
            floor0 = 3e-6 if cfg.adjoint_mixed else 1e-14
            eps_f, contraction = floor0, 0.0
            hist, rounds, r_max = [], 0, max(1, cfg.nrestart)
            while (rounds < r_max and _np.any(resn_h > tol_h)
                   and contraction < 0.6):
                psi, resids, resn = round_prog(
                    A, B, factor, res.lam, res.Phi, res.sigma, Phib, psi,
                    jnp.asarray(eps_f, dtype=Phib.dtype))
                resn_new = _np.asarray(jax.device_get(resn))
                hist.append(_np.asarray(jax.device_get(resids)))
                contraction = float(
                    resn_new.max() / max(resn_h.max(), 1e-300))
                eps_f = min(max(0.5 * contraction, floor0), 0.5)
                resn_h = resn_new
                rounds += 1
            denom = max(float(tol_h) / cfg.adjoint_rtol, 1e-300)
            return psi, {"res": resn_h / denom, "rounds": rounds,
                         "hist": _np.asarray(hist) / denom}

        def bwd_prog(theta, res, lam_bar, Phi_bar):
            A, B, factor, deflate, v0 = build_prog(theta)
            del deflate, v0  # pcpg-only / forward-only
            psi, info = _chunked_solve(A, B, factor, res, Phi_bar)
            bwd_prog.last_info = info
            return finish_prog(theta, A, B, res, psi, lam_bar, Phi_bar)

        # ---- forward-mode (jvp) channel through the SAME chunked
        # machinery: the tangent systems are the adjoint systems with RHS
        # W_i = (dA - lam_i dB) phi_i (eigh_gen_tangent), so guess_prog /
        # round_prog are reused verbatim (cache-hit: W has Phi_bar's shape).
        # Used as the jvp-vs-vjp gradient oracle at CRM scale.
        @jax.jit
        def tangent_seed_prog(theta, dtheta, res):
            def apply_both(th):
                A2, B2 = problem.assemble(th)
                return A2.mv(res.Phi), B2.mv(res.Phi)

            (_, _), (dAP, dBP) = jax.jvp(apply_both, (theta,), (dtheta,))
            if cfg.mode == "buckling":
                W = dBP + dAP * res.lam[None, :]
                dlam = res.lam * psum(jnp.sum(res.Phi * W, axis=0), cfg.axis)
            else:
                W = dAP - dBP * res.lam[None, :]
                dlam = psum(jnp.sum(res.Phi * W, axis=0), cfg.axis)
            dBG = pdot(res.Phi.T, dBP, cfg.axis)
            return W, dlam, dBG

        @jax.jit
        def tangent_finish_prog(B, res, psi, W, dBG, lam_bar, Phi_bar):
            """dJ = lam_bar . dlam + <Phi_bar, dPhi> for the objective whose
            (lam, Phi) gradient is the given seed pair (dlam folded by the
            caller)."""
            psi, _ = adj.sibk_finish(W, B, res.lam, res.Phi, psi,
                                     mode=cfg.mode, eig_atol=cfg.eig_atol,
                                     axis=cfg.axis)
            diff = res.lam[:, None] - res.lam[None, :]
            close = jnp.abs(diff) < cfg.eig_atol
            Cd = jnp.where(close, -0.5 * dBG, 0.0)
            dPhi = psi + pdot(res.Phi, Cd, None)
            return jnp.sum(Phi_bar * dPhi)

        def jvp_prog(theta, dtheta, res, lam_bar, Phi_bar):
            """Directional derivative lam_bar . dlam + <Phi_bar, dPhi> along
            dtheta, by forward mode through the chunked protocol. The seed
            pair (lam_bar, Phi_bar) is the objective's (lam, Phi) gradient —
            the same seeds the reverse pass consumes, so |jvp - p . xb|
            isolates solver/derivation error (no FD step size)."""
            A, B, factor, deflate, v0 = build_prog(theta)
            del deflate, v0
            W, dlam, dBG = tangent_seed_prog(theta, dtheta, res)
            psi, info = _chunked_solve(A, B, factor, res, W)
            jvp_prog.last_info = info
            dphi_term = tangent_finish_prog(B, res, psi, W, dBG,
                                            lam_bar, Phi_bar)
            return float(jnp.sum(jnp.asarray(lam_bar) * dlam) + dphi_term)

        bwd_prog.guess_prog = guess_prog
        bwd_prog.round_prog = round_prog
        bwd_prog.finish_prog = finish_prog
        bwd_prog.jvp_prog = jvp_prog
        bwd_prog.last_info = None
        jvp_prog.last_info = None
    else:
        adjoint_prog = jax.jit(_adjoint_core)

        def bwd_prog(theta, res, lam_bar, Phi_bar):
            A, B, factor, deflate, v0 = build_prog(theta)
            return adjoint_prog(theta, A, B, factor, deflate, res,
                                lam_bar, Phi_bar)

        bwd_prog.adjoint_prog = adjoint_prog

    return fwd_prog, bwd_prog


# ---------------------------------------------------------------------------
# Differentiable SPD linear solve with a custom factor (static-solve path)
# ---------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def solve_spd(theta, f, build_op, build_factor):
    """u = K(theta)^{-1} f with a hand-written adjoint rule.

    The factor may contain while_loops / mixed-precision refinement that JAX
    cannot differentiate through; the VJP is the standard self-adjoint pair
    (reference buckling.py:974-979 path adjoint, generalized):
        w = K^{-1} u_bar;  theta_bar = -grad_theta( w^T K(theta) u );
        f_bar = w.
    build_op(theta) -> Operator (differentiable), build_factor(theta) ->
    factor with .mv (not differentiated).
    """
    fac = build_factor(theta)
    return fac.mv(f)


def _solve_spd_fwd(theta, f, build_op, build_factor):
    fac = build_factor(theta)
    u = fac.mv(f)
    return u, (theta, u, fac)


def _solve_spd_bwd(build_op, build_factor, saved, ubar):
    theta, u, fac = saved
    w = fac.mv(ubar)

    def bilin(th):
        op = build_op(th)
        return -jnp.sum(w * op.mv(u))

    theta_bar = jax.grad(bilin)(theta)
    return theta_bar, w


solve_spd.defvjp(_solve_spd_fwd, _solve_spd_bwd)


@partial(jax.custom_jvp, nondiff_argnums=(2, 3))
def solve_spd_fwdmode(theta, f, build_op, build_factor):
    """:func:`solve_spd` with a forward-mode (custom_jvp) rule — the static
    solve used by the buckling forward-verification chain (custom_vjp
    functions cannot be jvp'd). Tangent of u = K(theta)^{-1} f:
        du = K^{-1} (df - dK u).
    """
    fac = build_factor(theta)
    return fac.mv(f)


@solve_spd_fwdmode.defjvp
def _solve_spd_fwdmode_jvp(build_op, build_factor, primals, tangents):
    theta, f = primals
    dtheta, df = tangents
    fac = build_factor(theta)
    u = fac.mv(f)

    def opmv(th):
        return build_op(th).mv(u)

    _, dKu = jax.jvp(opmv, (theta,), (dtheta,))
    du = fac.mv(df - dKu)
    return u, du


def eigh_gen_directional_oracle(A, B, dA, dB, N, eig_atol=1e-5,
                                mode="normal"):
    """Directional-derivative oracle with the reference's complex-step
    semantics: divided differences between numerically repeated eigenvalues
    are suppressed (reference BasicLanczos._eigh, eigenvector_derivatives.py:
    1403-1408 zeroes D[i, j] for equal eigenvalues), which is the correct
    infinitesimal derivative for objectives with underlying differentiability.

    mode="buckling": (A, B) = (G, K) with the pencil K phi + lam G phi = 0,
    lam the buckling load factor, K-orthonormal Phi, modes sorted by the
    shift-invert order argsort(-1/lam) (reference :1437); the tangents are
      dlam_i = lam_i phi_i^T (dK + lam_i dG) phi_i
      c_ij   = -lam_j phi_j^T W_i / (lam_j - lam_i)   (distinct j)
    with the same degenerate-rotation suppression in K-orthonormal
    coordinates (reference buckling.py:1014-1023 complex-step channel).

    Returns (lam, Phi, dlam, dPhi) for the N selected modes.
    """
    import scipy.linalg

    import numpy as np

    A = np.asarray(A)
    B = np.asarray(B)
    dA = np.asarray(dA)
    dB = np.asarray(dB)
    n = A.shape[0]

    if mode == "buckling":
        # G phi = mu K phi; lam = -1/mu; order by mu ascending
        mu, Phi = scipy.linalg.eigh(A, B)  # K-orthonormal columns
        lam = -1.0 / mu
        dlam = np.zeros(N)
        dPhi = np.zeros((n, N))
        for i in range(N):
            Wi = (dB + lam[i] * dA) @ Phi[:, i]
            dBi = dB @ Phi[:, i]
            dlam[i] = lam[i] * (Phi[:, i] @ Wi)
            for j in range(n):
                if j == i:
                    continue
                if abs(lam[j] - lam[i]) > eig_atol:
                    dPhi[:, i] += Phi[:, j] * (
                        -lam[j] * (Phi[:, j] @ Wi) / (lam[j] - lam[i]))
                else:
                    dPhi[:, i] += Phi[:, j] * (-0.5 * (Phi[:, j] @ dBi))
            dPhi[:, i] -= 0.5 * Phi[:, i] * (Phi[:, i] @ dBi)
        return lam[:N], Phi[:, :N], dlam, dPhi

    lam, Phi = scipy.linalg.eigh(A, B)

    dlam = np.zeros(N)
    dPhi = np.zeros((n, N))
    for i in range(N):
        Wi = (dA - lam[i] * dB) @ Phi[:, i]
        dBi = dB @ Phi[:, i]
        dlam[i] = Phi[:, i] @ Wi
        for j in range(n):
            if j == i:
                continue
            if abs(lam[j] - lam[i]) > eig_atol:
                dPhi[:, i] += Phi[:, j] * (Phi[:, j] @ Wi) / (lam[i] - lam[j])
            else:
                # Degenerate pair: the antisymmetric (rotation) part of the
                # coupling is suppressed, but the symmetric part survives the
                # limit: C_ij + C_ji = -phi_j' dB phi_i, so the symmetric
                # half -dB/2 must be kept (it is what the reference's
                # B-orthonormal-coordinate suppression implicitly preserves).
                dPhi[:, i] += Phi[:, j] * (-0.5 * (Phi[:, j] @ dBi))
        dPhi[:, i] -= 0.5 * Phi[:, i] * (Phi[:, i] @ dBi)
    return lam[:N], Phi[:, :N], dlam, dPhi


# ---------------------------------------------------------------------------
# Dense differentiable oracle (tests): Cholesky-transform + jnp.linalg.eigh
# ---------------------------------------------------------------------------


def eigh_gen_oracle(A, B, N, mode="normal"):
    """Fully differentiable dense reference path (JAX's own eigh AD rules).

    Transforms the generalized problem with the Cholesky factor of B:
    A phi = lam B phi  ->  (L^-1 A L^-T) y = lam y,  phi = L^-T y.
    Only valid for simple (non-repeated) eigenvalues; used as the
    machine-precision gradient oracle in the tests, replacing the reference's
    complex-step channel (thermal.py:652-661).
    """
    from jax.scipy.linalg import solve_triangular

    if mode == "buckling":
        # G phi = mu K phi sorted by -1/mu: transform with chol(K).
        A, B = A, B
        L = jnp.linalg.cholesky(B)
        Ainv = solve_triangular(L, A, lower=True)
        C = solve_triangular(L, Ainv.T, lower=True)
        C = 0.5 * (C + C.T)
        w, y = jnp.linalg.eigh(C)  # G y = w y in transformed space, lam = 1/w?
        # mu solves G phi = mu K phi -> transformed C y = (mu)^... C = L^-1 G L^-T,
        # eigenvalues of C are mu. Sort by -1/mu like the reference (:1437).
        order = jnp.argsort(-1.0 / w)
        w = w[order][:N]
        y = y[:, order][:, :N]
        phi = solve_triangular(L, y, lower=True, trans=1)
        return w, phi
    L = jnp.linalg.cholesky(B)
    Ainv = solve_triangular(L, A, lower=True)
    C = solve_triangular(L, Ainv.T, lower=True)
    C = 0.5 * (C + C.T)
    w, y = jnp.linalg.eigh(C)
    w = w[:N]
    y = y[:, :N]
    phi = solve_triangular(L, y, lower=True, trans=1)
    return w, phi
