"""Geometric multigrid shift-invert factor for structured grids.

O(n)-memory answer to SuperLU's role (SURVEY.md §2.3, hard part #1) at the
problem sizes where any direct factor stops fitting in HBM: the
block-tridiagonal / cyclic-reduction factors store O(nx * b^2) words
(~13 GB f32 at 1M DOF, b = 1026), while this factor stores only the 9-point
block stencil of A - sigma*B at every level of a coarsening hierarchy
(~sum 4^-l * 36 * ndof^2 * n words ~ 200 MB f32 at 1M DOF).

Design:
* All level operators are ``stencil_matvec`` applications — shifted
  elementwise block products, no gathers.
* Coarse operators are the exact Galerkin products A_c = P^T A_f P for
  bilinear interpolation P, computed by *comb probing*: 16 phase combs per
  dof are pushed through P -> A_f -> P^T, and the coarse 9-point stencil is
  read off exactly (the coarse stencil reach is 1 < comb stride 4). No
  stencil-algebra special cases, exact at boundaries.
* Smoother: pointwise-Jacobi-preconditioned Chebyshev (degree nu), no inner
  products at apply time; lambda_max(D^-1 A) per level estimated once at
  build by power iteration.
* The V-cycle runs entirely in f32 (half the bytes of f64); ``mv`` solves
  to f64 accuracy by flexible PCG in f64 with the f32 V-cycle as the
  preconditioner (inner products and residuals in f64, preconditioner
  applies in f32); ``approx_mv`` is a short f32 PCG for mixed-precision
  Krylov ladders (GMRES-IR style), mirroring RefinedFactor.approx_mv.

The factor is used inside the eigh_gen custom-VJP forward/reverse solves
(never differentiated through), so while_loops and mixed precision are fine.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .stencil import stencil_matvec


# ---------------------------------------------------------------------------
# Grid transfer operators: bilinear prolongation and its exact transpose
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(1, 2, 3))
def prolong(xc, nxc, nyc, ndof):
    """Bilinear interpolation coarse -> fine; xc is (nc,) or (nc, k).

    Coarse grid (nxc+1, nyc+1) -> fine grid (2*nxc+1, 2*nyc+1); fine node
    (2I, 2J) is the coarse node (I, J), odd fine nodes average their coarse
    neighbours.
    """
    squeeze = xc.ndim == 1
    if squeeze:
        xc = xc[:, None]
    k = xc.shape[1]
    g = xc.reshape(nxc + 1, nyc + 1, ndof, k)
    nxf, nyf = 2 * nxc, 2 * nyc
    # interpolate along i: (2*nxc+1, nyc+1, ...)
    gi = jnp.zeros((nxf + 1, nyc + 1, ndof, k), dtype=xc.dtype)
    gi = gi.at[0::2].set(g)
    gi = gi.at[1::2].set(0.5 * (g[:-1] + g[1:]))
    # interpolate along j
    gf = jnp.zeros((nxf + 1, nyf + 1, ndof, k), dtype=xc.dtype)
    gf = gf.at[:, 0::2].set(gi)
    gf = gf.at[:, 1::2].set(0.5 * (gi[:, :-1] + gi[:, 1:]))
    out = gf.reshape((nxf + 1) * (nyf + 1) * ndof, k)
    if squeeze:
        out = out[:, 0]
    return out


@partial(jax.jit, static_argnums=(1, 2, 3))
def restrict(yf, nxc, nyc, ndof):
    """Exact transpose of ``prolong`` (full weighting); yf on the fine grid."""
    squeeze = yf.ndim == 1
    if squeeze:
        yf = yf[:, None]
    k = yf.shape[1]
    nxf, nyf = 2 * nxc, 2 * nyc
    g = yf.reshape(nxf + 1, nyf + 1, ndof, k)
    # transpose of interpolate-along-j: coarse_j gets y[2J] + 0.5*(odd nbrs)
    gj = g[:, 0::2] + 0.5 * (
        jnp.pad(g[:, 1::2], ((0, 0), (0, 1), (0, 0), (0, 0)))
        + jnp.pad(g[:, 1::2], ((0, 0), (1, 0), (0, 0), (0, 0))))
    # transpose of interpolate-along-i
    gc = gj[0::2] + 0.5 * (
        jnp.pad(gj[1::2], ((0, 1), (0, 0), (0, 0), (0, 0)))
        + jnp.pad(gj[1::2], ((1, 0), (0, 0), (0, 0), (0, 0))))
    out = gc.reshape((nxc + 1) * (nyc + 1) * ndof, k)
    if squeeze:
        out = out[:, 0]
    return out


# ---------------------------------------------------------------------------
# Exact Galerkin coarse stencil via comb probing
# ---------------------------------------------------------------------------


def galerkin_coarse_stencil(Wf, nxf, nyf, ndof):
    """Coarse 9-point block stencil of A_c = P^T A_f P, exactly.

    For each of 16 coarse-phase classes (p, q) and each dof b, the comb
    vector with ones at coarse nodes (I' = p mod 4, J' = q mod 4, dof b) is
    pushed through P -> A_f -> P^T. Because the coarse stencil reaches only
    +-1 coarse node and the comb stride is 4, every coarse entry of the
    result reads off exactly one stencil block:
        W_c[I, J, 1+di, 1+dj, :, b] = u_{(I+di)%4, (J+dj)%4, b}[I, J, :].
    """
    nxc, nyc = nxf // 2, nyf // 2
    dtype = Wf.dtype
    nc = (nxc + 1) * (nyc + 1) * ndof

    Ic = np.arange(nxc + 1)
    Jc = np.arange(nyc + 1)

    # all 16*ndof probe results: U[p, q, b] -> (nxc+1, nyc+1, ndof)
    probes = []
    for p in range(4):
        for q in range(4):
            for b in range(ndof):
                comb = np.zeros((nxc + 1, nyc + 1, ndof), dtype=bool)
                comb[np.ix_(Ic[Ic % 4 == p], Jc[Jc % 4 == q], [b])] = True
                probes.append(comb.reshape(-1))
    combs = jnp.asarray(np.stack(probes, axis=1), dtype=dtype)  # (nc, 16*ndof)

    u = restrict(stencil_matvec(Wf, prolong(combs, nxc, nyc, ndof),
                                nxf, nyf, ndof), nxc, nyc, ndof)
    U = u.reshape(nxc + 1, nyc + 1, ndof, 4, 4, ndof)  # [I, J, a, p, q, b]

    # Extraction as masked phase sums (einsum over one-hot phase masks)
    # instead of a general gather; these arrays are tiny (the einsum does
    # 16x the minimal work on O(n_coarse) data).
    Wc = jnp.zeros((nxc + 1, nyc + 1, 3, 3, ndof, ndof), dtype=dtype)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            MI = jnp.asarray((np.arange(4)[:, None] == (Ic + di) % 4)
                             & (Ic + di >= 0)[None, :]
                             & (Ic + di <= nxc)[None, :], dtype=dtype)
            MJ = jnp.asarray((np.arange(4)[:, None] == (Jc + dj) % 4),
                             dtype=dtype)
            blk = jnp.einsum("IJapqb,pI,qJ->IJab", U, MI, MJ)
            valid_j = jnp.asarray(((Jc + dj >= 0) & (Jc + dj <= nyc)),
                                  dtype=dtype)
            blk = blk * valid_j[None, :, None, None]
            Wc = Wc.at[:, :, 1 + di, 1 + dj].set(blk)
    return Wc


def stencil_to_dense(W, nx, ny, ndof):
    """Assemble the dense matrix of a 9-point block stencil (coarse solve /
    tests only — O(n^2) memory)."""
    n = (nx + 1) * (ny + 1) * ndof
    A = jnp.zeros((n, n), dtype=W.dtype)
    node = np.arange((nx + 1) * (ny + 1)).reshape(nx + 1, ny + 1)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            i0, i1 = max(0, -di), min(nx + 1, nx + 1 - di)
            j0, j1 = max(0, -dj), min(ny + 1, ny + 1 - dj)
            rows = node[i0:i1, j0:j1]
            colsn = node[i0 + di:i1 + di, j0 + dj:j1 + dj]
            blk = W[i0:i1, j0:j1, 1 + di, 1 + dj]  # (., ., ndof, ndof)
            r = (ndof * rows[:, :, None, None]
                 + np.arange(ndof)[None, None, :, None])
            c = (ndof * colsn[:, :, None, None]
                 + np.arange(ndof)[None, None, None, :])
            A = A.at[r, c].add(blk)
    return A


# ---------------------------------------------------------------------------
# Chebyshev smoother (pointwise-Jacobi preconditioned)
# ---------------------------------------------------------------------------


def estimate_lmax(W, dinv, nx, ny, ndof, iters=12, seed=7):
    """lambda_max(D^-1 A) by power iteration (build-time, not jitted hot)."""
    n = (nx + 1) * (ny + 1) * ndof
    v = jax.random.uniform(jax.random.PRNGKey(seed), (n,), dtype=W.dtype,
                           minval=-1.0, maxval=1.0)
    # inherit W's shard_map variance so the fori_loop carry types match
    # when this runs (replicated) inside a shard_map region
    v = v * (1.0 + 0.0 * W.reshape(-1)[0])

    def body(_, v):
        w = dinv * stencil_matvec(W, v, nx, ny, ndof)
        return w / jnp.sqrt(jnp.sum(w * w))

    v = jax.lax.fori_loop(0, iters, body, v)
    w = dinv * stencil_matvec(W, v, nx, ny, ndof)
    return jnp.sum(v * w) / jnp.sum(v * v)


def cheb_smooth(W, dinv, lmax, x, b, nx, ny, ndof, degree=3,
                lo_frac=0.25, barrier=False):
    """Chebyshev iteration for D^-1 A on [lo_frac*lmax, 1.02*lmax].

    Standard three-term recurrence on the preconditioned residual; no inner
    products (every step is one stencil matvec + AXPYs).

    ``barrier=True`` pins every stencil matvec behind
    ``lax.optimization_barrier`` (see GridMGFactor's "barrier" variant).
    """
    ob = jax.lax.optimization_barrier if barrier else (lambda v: v)
    lmin = lo_frac * lmax
    lmax = 1.02 * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1

    r = b - ob(stencil_matvec(W, ob(x), nx, ny, ndof))
    d = (dinv[:, None] if r.ndim == 2 else dinv) * r / theta
    x = x + d
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        r = b - ob(stencil_matvec(W, ob(x), nx, ny, ndof))
        z = (dinv[:, None] if r.ndim == 2 else dinv) * r
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        x = x + d
        rho = rho_new
    return x


# ---------------------------------------------------------------------------
# The factor
# ---------------------------------------------------------------------------

VCYCLE_VARIANTS = ("plain", "barrier", "f64")


@jax.tree_util.register_pytree_node_class
class GridMGFactor:
    """apply(x) = (A)^-1 x for a 9-point block-stencil SPD A, via PCG with a
    geometric-multigrid V-cycle preconditioner.

    Stored per level l: stencil W_l (f32), Jacobi diag inverse, lambda_max of
    D^-1 A; coarsest level: dense Cholesky inverse. ``op64`` keeps the fine
    stencil in f64 for the outer f64 PCG residuals (exact solves to ~1e-13).
    """

    def __init__(self, Ws, dinvs, lmaxs, coarse_inv, W64, shapes, ndof,
                 degree=3, rtol=1e-13, maxiter=60, approx_rtol=1e-5,
                 approx_maxiter=18, stag_bad=2, vcycle="plain",
                 sweep_rtol=None, sweep_maxiter=None):
        self.Ws = tuple(Ws)  # f32 stencils, fine -> coarse
        self.dinvs = tuple(dinvs)
        self.lmaxs = tuple(lmaxs)
        self.coarse_inv = coarse_inv  # (nc, nc) dense inverse, f32
        self.W64 = W64  # fine stencil, f64 (or None for f32-only problems)
        self.shapes = tuple(tuple(s) for s in shapes)  # [(nx, ny), ...]
        self.ndof = ndof
        self.degree = degree
        self.rtol = rtol
        self.maxiter = maxiter
        self.approx_rtol = approx_rtol
        self.approx_maxiter = approx_maxiter
        # Separate tolerances for the forward-sweep apply channel
        # (``sweep_mv``): the forward Lanczos sweep wants the f32 solve
        # driven to its machine floor (rtol 0.0 — the FD-verification
        # noise floor of the objective tracks the sweep apply quality),
        # while the adjoint's mixed ladder keeps the cheap
        # approx_rtol solves (its outer rounds restart on true residuals,
        # so ladder quality only trades steps per round). None = inherit
        # the approx_* values (sweep_mv == approx_mv).
        self.sweep_rtol = sweep_rtol
        self.sweep_maxiter = sweep_maxiter
        self.stag_bad = stag_bad  # consecutive plateau iterations before
        # the PCG stagnation exit fires; large value = exit on tol/maxiter
        # only
        # V-cycle implementation variant (see ``_vcycle``):
        #   "plain"   — straight-line XLA recursion
        #   "barrier" — optimization_barrier around every smoother matvec
        #               and V-cycle stage edge
        #   "f64"     — run the whole V-cycle in f64 (~2x the V-cycle cost)
        self.vcycle = vcycle

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, W, grid_shape, ndof, min_coarse=2048, degree=3,
              rtol=1e-13, maxiter=60, approx_rtol=1e-5, approx_maxiter=18,
              stag_bad=2, vcycle="plain", sweep_rtol=None,
              sweep_maxiter=None):
        """W: fine-level stencil (f64 or f32) of the SPD shifted operator.
        ``vcycle``: one of ``VCYCLE_VARIANTS``.
        """
        if vcycle not in VCYCLE_VARIANTS:
            raise ValueError(f"GridMGFactor: unknown vcycle {vcycle!r}; "
                             f"expected one of {VCYCLE_VARIANTS}")
        W64 = W if W.dtype == jnp.float64 else None
        Wl = W.astype(jnp.float32)
        nx, ny = grid_shape
        Ws, dinvs, lmaxs, shapes = [], [], [], []
        while True:
            shapes.append((nx, ny))
            Ws.append(Wl)
            dg = jnp.stack([Wl[:, :, 1, 1, d, d] for d in range(ndof)],
                           axis=2).reshape(-1)
            dinv = 1.0 / dg
            dinvs.append(dinv)
            lmaxs.append(estimate_lmax(Wl, dinv, nx, ny, ndof))
            n_cur = (nx + 1) * (ny + 1) * ndof
            can_coarsen = not (nx % 2 or ny % 2 or nx < 4 or ny < 4)
            if not can_coarsen:
                # Refuse to silently densify a huge grid: an odd / tiny
                # dimension at large n means the caller's grid cannot build
                # a hierarchy and the dense coarse inverse would OOM.
                if n_cur > max(16 * min_coarse, 65536):
                    raise ValueError(
                        f"GridMGFactor: grid {nx}x{ny} cannot coarsen "
                        f"further at n={n_cur} (odd or tiny dimension); "
                        "use even element counts per level or a larger "
                        "min_coarse.")
                break
            if n_cur <= min_coarse:
                break
            # Keep coarsening through min_coarse (the level that first dips
            # under it becomes the dense-inverted coarsest) rather than
            # stopping one level early and Cholesky-inverting up to
            # ~4x min_coarse.
            Wl = galerkin_coarse_stencil(Wl, nx, ny, ndof)
            nx, ny = nx // 2, ny // 2

        Ac = stencil_to_dense(Ws[-1], *shapes[-1], ndof)
        # dense SPD inverse via Cholesky (f32); coarsest grid is small
        L = jnp.linalg.cholesky(Ac)
        from jax.scipy.linalg import solve_triangular

        eye = jnp.eye(Ac.shape[0], dtype=Ac.dtype)
        Linv = solve_triangular(L, eye, lower=True)
        coarse_inv = Linv.T @ Linv
        return cls(Ws, dinvs, lmaxs, coarse_inv, W64, shapes, ndof,
                   degree=degree, rtol=rtol, maxiter=maxiter,
                   approx_rtol=approx_rtol, approx_maxiter=approx_maxiter,
                   stag_bad=stag_bad, vcycle=vcycle,
                   sweep_rtol=sweep_rtol, sweep_maxiter=sweep_maxiter)

    # -- V-cycle -------------------------------------------------------------

    def _vcycle(self, lvl, b):
        """One V-cycle at ``b``'s dtype resolution.

        ``self.vcycle`` selects the implementation: "plain" is the
        straight-line recursion; "barrier" pins every smoother matvec and
        stage edge behind ``lax.optimization_barrier``; "f64" runs all
        levels in f64. The latter two are different program shapes of the
        same math, kept as fallbacks should a compiler mis-fuse the f32
        V-cycle subgraph inside a large enclosing program.
        """
        barrier = self.vcycle == "barrier"
        ob = jax.lax.optimization_barrier if barrier else (lambda v: v)
        nx, ny = self.shapes[lvl]
        if lvl == len(self.Ws) - 1:
            ci = self.coarse_inv
            return ci.astype(b.dtype) @ b if ci.dtype != b.dtype else ci @ b
        W, dinv, lmax = self.Ws[lvl], self.dinvs[lvl], self.lmaxs[lvl]
        if W.dtype != b.dtype:  # "f64" variant: cast the level up
            W = W.astype(b.dtype)
            dinv = dinv.astype(b.dtype)
        x = cheb_smooth(W, dinv, lmax, jnp.zeros_like(b), b, nx, ny,
                        self.ndof, degree=self.degree, barrier=barrier)
        r = b - ob(stencil_matvec(W, ob(x), nx, ny, self.ndof))
        xc = self._vcycle(lvl + 1,
                          ob(restrict(r, nx // 2, ny // 2, self.ndof)))
        x = x + prolong(xc, nx // 2, ny // 2, self.ndof)
        return cheb_smooth(W, dinv, lmax, x, b, nx, ny, self.ndof,
                           degree=self.degree, barrier=barrier)

    def _apply_vcycle32(self, r):
        """One f32 V-cycle preconditioner apply on (n, k) r."""
        return self._vcycle(0, r.astype(jnp.float32))

    # -- PCG drivers ----------------------------------------------------------

    def _pcg(self, bb, matvec64, rtol, maxiter, x0=None):
        """Flexible PCG; residuals/updates in bb.dtype, preconditioner f32.

        bb : (n, k). Per-column coefficients; converged columns freeze
        (their alpha is zeroed). Stagnation exit only after TWO consecutive
        iterations without a 10% reduction of the best residual seen so far
        (a single plateau iteration — pre-superlinear phase or the f32
        preconditioner noise floor — must not abort the solve).

        x0 : optional warm-start iterate (n, k). The convergence gate stays
        relative to ||b|| per column, so a good guess only removes
        iterations — it can never loosen the solve. Used by the Ritz
        polish, whose guess Phi/(lam - sigma) starts the solve at a
        relative residual of ~(current eigen-residual) instead of ~1.

        Returns (x, info) with info = dict(niter, res2 = per-column final
        squared residuals, tol2) so callers can detect an unconverged apply
        (ADVICE r1: no silent truncation).
        """
        dtype = bb.dtype
        nx, ny = self.shapes[0]

        def M(r):
            # SPD guard: if the V-cycle output is broken (zero / indefinite
            # vs r), fall back to the unpreconditioned direction — CG then
            # still converges, just slower, instead of deadlocking at
            # alpha = 0. Also load-bearing beyond numerics: convergence is
            # gated on the TRUE f64 residual, so mv() can never report a
            # wrong solution as converged no matter what the preconditioner
            # returns. (Observed once: an XLA:CPU fusion bug corrupted the
            # V-cycle output only when inlined next to this while_loop in a
            # fori_loop body — this restructuring avoids that composition
            # and the guard makes any recurrence of it slow, not wrong.)
            # optimization_barrier on both sides pins the V-cycle's inputs
            # and outputs so its computation cannot be cross-fused with the
            # surrounding loop body.
            pdt = jnp.float64 if (self.vcycle == "f64"
                                  and dtype == jnp.float64) else jnp.float32
            rp = jax.lax.optimization_barrier(r.astype(pdt))
            zp = jax.lax.optimization_barrier(self._vcycle(0, rp))
            z = zp.astype(dtype)
            rz = jnp.sum(r * z, axis=0)
            ok = rz > 0.0
            return jnp.where(ok[None, :], z, r), jnp.where(
                ok, rz, jnp.sum(r * r, axis=0))

        b2 = jnp.sum(bb * bb, axis=0)
        tol2 = (rtol * rtol) * jnp.maximum(b2, 1e-300)

        x = M(bb)[0] if x0 is None else x0.astype(dtype)
        r = bb - matvec64(x)
        z, rz = M(r)
        p = z

        def cond(carry):
            k, x, r, z, p, rz, r2, best, bad = carry
            active = r2 > tol2
            return ((k < maxiter) & jnp.any(active)
                    & (bad < self.stag_bad))

        def body(carry):
            k, x, r, z, p, rz, r2, best, bad = carry
            Ap = matvec64(p)
            pAp = jnp.sum(p * Ap, axis=0)
            active = (r2 > tol2).astype(dtype)
            alpha = jnp.where(pAp > 0, rz / jnp.where(pAp > 0, pAp, 1.0),
                              0.0) * active
            x = x + p * alpha[None, :]
            r_new = r - Ap * alpha[None, :]
            z, rz_new = M(r_new)
            # flexible (Polak-Ribiere) beta: robust to the slightly varying
            # f32 V-cycle preconditioner inside f64 CG
            rz_flex = rz_new - jnp.sum(r * z, axis=0)
            beta = jnp.where(rz != 0.0, rz_flex / jnp.where(rz != 0.0, rz,
                                                            1.0), 0.0)
            p = z + p * beta[None, :]
            r2n = jnp.sum(r_new * r_new, axis=0)
            # stagnation vs the best TOTAL residual so far; two consecutive
            # plateau iterations required before giving up (a single
            # plateau — pre-superlinear phase or the f32 preconditioner
            # noise floor — must not abort the solve)
            improving = jnp.sum(r2n) < 0.9 * best
            bad = jnp.where(improving, 0, bad + 1)
            best = jnp.minimum(best, jnp.sum(r2n))
            return k + 1, x, r_new, z, p, rz_new, r2n, best, bad

        r2_0 = jnp.sum(r * r, axis=0)
        carry = (jnp.asarray(0), x, r, z, p, rz, r2_0, jnp.sum(r2_0),
                 jnp.asarray(0))
        k_end, x, _, _, _, _, r2, _, _ = jax.lax.while_loop(
            cond, body, carry)
        return x, {"niter": k_end, "res2": r2, "tol2": tol2}

    def _pcg32(self, bb, rtol, maxiter):
        """f32 PCG with the f32 fine stencil as the residual matvec."""
        return self._pcg(bb, self._matvec32, rtol, maxiter)

    def _matvec64(self, x):
        nx, ny = self.shapes[0]
        return stencil_matvec(self.W64, x, nx, ny, self.ndof)

    def _matvec32(self, x):
        nx, ny = self.shapes[0]
        return stencil_matvec(self.Ws[0], x, nx, ny, self.ndof)

    @property
    def shape(self):
        nx, ny = self.shapes[0]
        n = (nx + 1) * (ny + 1) * self.ndof
        return (n, n)

    @property
    def dtype(self):
        return jnp.float64 if self.W64 is not None else jnp.float32

    def mv(self, x):
        """Solve A y = x to ~rtol in the operator's working dtype.

        f64 path: flexible PCG in f64 with the f32 V-cycle as the
        preconditioner. (An iterative-refinement variant — f32 inner PCG
        solves + f64 residual matvecs — runs strictly more V-cycles for the
        same final accuracy, and the V-cycle, not the f64 matvec, is the
        unit cost.)
        """
        y, _ = self.mv_info(x)
        return y

    def mv_info(self, x, x0=None):
        """Like ``mv`` but also returns the inner-PCG convergence info
        (niter, per-column final squared residuals, tol2)."""
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
            x0 = None if x0 is None else x0[:, None]
        if self.W64 is None:
            if x0 is None:
                y, info = self._pcg32(x.astype(jnp.float32),
                                      max(self.rtol, 1e-6), self.maxiter)
            else:
                y, info = self._pcg(x.astype(jnp.float32), self._matvec32,
                                    max(self.rtol, 1e-6), self.maxiter,
                                    x0=x0)
        else:
            y, info = self._pcg(x.astype(jnp.float64), self._matvec64,
                                self.rtol, self.maxiter, x0=x0)
        if squeeze:
            y = y[:, 0]
        return y, info

    def mv_warm(self, x, x0):
        """Accurate solve with a warm-start iterate (see ``_pcg``)."""
        y, _ = self.mv_info(x, x0=x0)
        return y

    def approx_mv(self, x):
        """Preconditioner-quality f32 solve for mixed-precision ladders."""
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        y, _ = self._pcg32(x.astype(jnp.float32),
                           self.approx_rtol, self.approx_maxiter)
        if squeeze:
            y = y[:, 0]
        return y

    def sweep_mv(self, x):
        """Forward-sweep apply channel: like ``approx_mv`` but at
        (sweep_rtol, sweep_maxiter) when set — see __init__. The block
        Lanczos sweep prefers this method when present."""
        if self.sweep_rtol is None and self.sweep_maxiter is None:
            return self.approx_mv(x)
        rt = self.approx_rtol if self.sweep_rtol is None else self.sweep_rtol
        mi = (self.approx_maxiter if self.sweep_maxiter is None
              else self.sweep_maxiter)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        y, _ = self._pcg32(x.astype(jnp.float32), rt, mi)
        if squeeze:
            y = y[:, 0]
        return y

    def precond_mv(self, x):
        """ONE f32 V-cycle — the raw preconditioner apply (for outer Krylov
        methods that bring their own convergence control, e.g. the
        V-cycle-preconditioned projected block-CG adjoint)."""
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        y = self._apply_vcycle32(x).astype(
            jnp.float64 if self.W64 is not None else jnp.float32)
        if squeeze:
            y = y[:, 0]
        return y

    def __call__(self, x):
        return self.mv(x)

    def tree_flatten(self):
        children = (self.Ws, self.dinvs, self.lmaxs, self.coarse_inv,
                    self.W64)
        aux = (self.shapes, self.ndof, self.degree, self.rtol, self.maxiter,
               self.approx_rtol, self.approx_maxiter, self.sweep_rtol,
               self.sweep_maxiter, self.stag_bad,
               self.vcycle)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        Ws, dinvs, lmaxs, coarse_inv, W64 = children
        (shapes, ndof, degree, rtol, maxiter, approx_rtol, approx_maxiter,
         sweep_rtol, sweep_maxiter, stag_bad, vcycle) = aux
        return cls(Ws, dinvs, lmaxs, coarse_inv, W64, shapes, ndof,
                   degree=degree, rtol=rtol, maxiter=maxiter,
                   approx_rtol=approx_rtol, approx_maxiter=approx_maxiter,
                   stag_bad=stag_bad, vcycle=vcycle,
                   sweep_rtol=sweep_rtol, sweep_maxiter=sweep_maxiter)
