"""Block-tridiagonal Cholesky factor for structured-grid problems.

This is the on-device answer to SuperLU for the shift-invert factor at scale
(SURVEY.md §7 hard part #1): a regular nx x ny grid ordered line-by-line
makes A - sigma*B block tridiagonal with dense (b, b) blocks, b = ndof*(ny+1).
The factorization is a lax.scan of dense block operations (potrf + GEMMs); the block inverses are precomputed so every factor apply is a
forward/backward scan of (b, b) x (b,) GEMMs with no triangular solves on the
critical path.

cost: factorize O(nx * b^3) flops; apply O(nx * b^2) per vector.
memory: 2 * nx * b^2 words (block inverses + couplings) — store in f32 and
wrap with CG/iterative refinement in f64 when HBM-bound.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import solve_triangular


def grid_block_tridiag(mats, nx, ny, ndof=2):
    """Element matrices -> block-tridiagonal blocks for the line ordering.

    mats : (nx*ny, 4*ndof, 4*ndof) element matrices with element index
        e = i + nx*j and node order [(i,j), (i+1,j), (i+1,j+1), (i,j+1)]
        (eigd_tpu.fem.model.make_grid layout); nodes[i,j] = i*(ny+1)+j.

    Returns D (nx+1, b, b) diagonal blocks and E (nx, b, b) sub-diagonal
    blocks (E_i = A[line i+1, line i]), with b = ndof*(ny+1).
    """
    b = ndof * (ny + 1)
    d4 = 4 * ndof
    # rearrange to (nx, ny, d4, d4)
    Me = mats.reshape(ny, nx, d4, d4).transpose(1, 0, 2, 3)

    # local node -> (line offset 0/1, within-line node index j or j+1)
    # node order: n0=(i,j), n1=(i+1,j), n2=(i+1,j+1), n3=(i,j+1)
    node_line = np.array([0, 1, 1, 0])
    node_joff = np.array([0, 0, 1, 1])

    # index of each element dof within its line block, per j (ny, d4)
    j_idx = np.arange(ny)
    col = np.zeros((ny, d4), dtype=np.int32)
    line = np.zeros(d4, dtype=np.int32)
    for a in range(4):
        for d in range(ndof):
            col[:, ndof * a + d] = ndof * (j_idx + node_joff[a]) + d
            line[ndof * a + d] = node_line[a]
    col = jnp.asarray(col)
    line_mask0 = jnp.asarray((line == 0), dtype=mats.dtype)
    line_mask1 = jnp.asarray((line == 1), dtype=mats.dtype)

    # Split each element matrix into the four line-block pieces and
    # scatter-add into (b, b) blocks per column of elements.
    def blocks_for_line(Mi):
        """Mi: (ny, d4, d4) for one column i -> (D_lo, D_hi, E) blocks.

        D_lo : coupling within line i, D_hi : within line i+1,
        E    : A[line i+1, line i].
        """
        m00 = Mi * (line_mask0[None, :, None] * line_mask0[None, None, :])
        m11 = Mi * (line_mask1[None, :, None] * line_mask1[None, None, :])
        m10 = Mi * (line_mask1[None, :, None] * line_mask0[None, None, :])

        def scatter(m):
            out = jnp.zeros((b, b), dtype=mats.dtype)
            return out.at[col[:, :, None], col[:, None, :]].add(m)

        return scatter(m00), scatter(m11), scatter(m10)

    D_lo, D_hi, E = jax.vmap(blocks_for_line)(Me)  # (nx, b, b) each
    D = jnp.zeros((nx + 1, b, b), dtype=mats.dtype)
    D = D.at[:nx].add(D_lo)
    D = D.at[1:].add(D_hi)
    return D, E


def block_tridiag_from_dof_groups(mats, dofs, group_of_dof, nb, b):
    """Element matrices -> block-tridiagonal blocks for any DOF grouping
    where elements couple only adjacent groups (e.g. wingbox span stations).

    mats : (nelems, d, d); dofs : (nelems, d) global DOF indices;
    group_of_dof : (n,) int group index of each DOF, with DOFs of a group
    contiguous: dof = group*b + offset (pad groups to a common size b with
    unused trailing DOFs). Returns D (nb, b, b), E (nb-1, b, b) with
    E_i = A[group i+1, group i]. Zero diagonal entries (padding / masked
    DOFs) are replaced by 1 so the Cholesky exists.
    """
    del group_of_dof  # implied by the contiguous dof = group*b + off layout
    gi = dofs // b  # (nelems, d)
    wi = dofs % b
    same = gi[:, :, None] == gi[:, None, :]
    lower = gi[:, :, None] == gi[:, None, :] + 1

    d_idx = jnp.where(same, gi[:, :, None], nb)
    D = jnp.zeros((nb + 1, b, b), dtype=mats.dtype)
    D = D.at[d_idx, wi[:, :, None], wi[:, None, :]].add(
        jnp.where(same, mats, 0.0))[:nb]
    e_idx = jnp.where(lower, gi[:, None, :], nb)
    E = jnp.zeros((nb + 1, b, b), dtype=mats.dtype)
    E = E.at[e_idx, wi[:, :, None], wi[:, None, :]].add(
        jnp.where(lower, mats, 0.0))[: nb - 1]

    diag = jnp.diagonal(D, axis1=1, axis2=2)
    fix = (diag == 0.0).astype(mats.dtype)
    D = D + jax.vmap(jnp.diag)(fix)
    return D, E


@jax.tree_util.register_pytree_node_class
class BlockTridiagFactor:
    """apply(x) = A^{-1} x for block-tridiagonal SPD A via block Cholesky.

    Stores the inverses of the Cholesky diagonal blocks (Linv) and the
    scaled couplings F_i = E_i Linv_i^T, so applies are GEMM-only scans.
    """

    def __init__(self, Linv, F, shape_info):
        self.Linv = Linv  # (nb, b, b)
        self.F = F  # (nb-1, b, b)
        self.nb, self.b = shape_info

    @classmethod
    def from_blocks(cls, D, E, store_dtype=None):
        """Factorize (in the blocks' dtype) and optionally store the factor
        in a narrower dtype (f32): halves HBM for the 2*nx*b^2-word factor
        and runs the apply scans in f32; wrap with RefinedFactor
        to recover f64 solve accuracy via iterative refinement."""
        nb, b = D.shape[0], D.shape[1]
        eye = jnp.eye(b, dtype=D.dtype)

        # Block Cholesky: S_i = D_i - F_{i-1} F_{i-1}^T, L_i = chol(S_i),
        # F_i = E_i L_i^{-T}. One scan step per grid line.
        def body(carry, inputs):
            F_prev = carry
            Di, Ei = inputs  # Ei = E_i (coupling to the NEXT line); for the
            # last line Ei is zero padding
            S = Di - F_prev @ F_prev.T
            L = jnp.linalg.cholesky(S)
            Linv = solve_triangular(L, eye, lower=True)
            F_next = Ei @ Linv.T  # F_i = E_i Linv_i^T
            return F_next, (Linv, F_next)

        Epad_tail = jnp.concatenate(
            [E, jnp.zeros((nb - E.shape[0], b, b), dtype=D.dtype)])
        # 0*D[0] (not jnp.zeros) so the carry inherits the shard_map variance
        # of the blocks (scan carries must match their outputs' mesh axes).
        F0 = 0.0 * D[0]
        _, (Linv_all, F_all) = jax.lax.scan(body, F0, (D, Epad_tail))
        # A single-block factor has no couplings; store None, NOT a
        # zero-sized (0, b, b) array — zero-sized pytree leaves crossing a
        # jit/shard_map boundary (e.g. as custom-VJP residuals) are
        # canonicalized to replicated by GSPMD while their variance says
        # device-varying, which trips a hard sharding-override assert.
        F_sub = F_all[:-1] if nb > 1 else None
        if store_dtype is not None:
            Linv_all = Linv_all.astype(store_dtype)
            F_sub = F_sub.astype(store_dtype) if F_sub is not None else None
        return cls(Linv_all, F_sub, (nb, b))

    @property
    def shape(self):
        n = self.nb * self.b
        return (n, n)

    @property
    def dtype(self):
        return self.Linv.dtype

    def mv(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        x = x.astype(self.Linv.dtype)  # scans run at the factor's precision
        k = x.shape[1]
        xb = x.reshape(self.nb, self.b, k)
        F = (self.F if self.F is not None else
             jnp.zeros((0, self.b, self.b), dtype=self.Linv.dtype))
        Fpad = jnp.concatenate(
            [jnp.zeros((1, self.b, self.b), dtype=self.Linv.dtype), F])

        # forward: y_i = Linv_i (x_i - F_{i-1} y_{i-1})
        def fwd(y_prev, inputs):
            xi, Linv, Fprev = inputs
            y = Linv @ (xi - Fprev @ y_prev)
            return y, y

        y0 = 0.0 * xb[0]  # inherits shard_map variance (see from_blocks)
        _, Y = jax.lax.scan(fwd, y0, (xb, self.Linv, Fpad))

        # backward: z_i = Linv_i^T (y_i - F_i^T z_{i+1})
        def bwd(z_next, inputs):
            yi, Linv, Fi = inputs
            z = Linv.T @ (yi - Fi.T @ z_next)
            return z, z

        Fpad_tail = jnp.concatenate(
            [F, jnp.zeros((1, self.b, self.b), dtype=self.Linv.dtype)])
        _, Z = jax.lax.scan(bwd, y0, (Y, self.Linv, Fpad_tail), reverse=True)
        out = Z.reshape(self.nb * self.b, k)
        if squeeze:
            out = out[:, 0]
        return out

    def __call__(self, x):
        return self.mv(x)

    def tree_flatten(self):
        return (self.Linv, self.F), (self.nb, self.b)

    @classmethod
    def tree_unflatten(cls, aux, children):
        Linv, F = children
        return cls(Linv, F, aux)


@jax.tree_util.register_pytree_node_class
class BCRFactor:
    """Block cyclic reduction solver for SPD block-tridiagonal systems.

    The scan-based BlockTridiagFactor is latency-bound: its apply is 2*nb
    sequential (b, b) GEMM steps whose loop overhead dwarfs the math at
    nb ~ 500. Cyclic reduction restructures
    the same solve into log2(nb) *levels*, each one batched Cholesky /
    GEMM over all odd-indexed blocks at once — ~18 kernel-sized steps
    instead of ~1000, at ~2.5x the flops. This is the on-device answer to
    SuperLU's role in the reference (SURVEY.md §2.3, hard part #1).

    Elimination at one level (row i: E_{i-1} x_{i-1} + D_i x_i +
    E_i^T x_{i+1} = f_i, E_i = A[i+1, i]):
      odd j:  x_j = Dinv_j (f_j - E_{j-1} x_{j-1} - E_j^T x_{j+1})
      even i: D'_i = D_i - E_{i-1} Dinv_{i-1} E_{i-1}^T - E_i^T Dinv_{i+1} E_i
              E'_k = -E_{2k+1} Dinv_{2k+1} E_{2k}
              f'_i = f_i - E_{i-1} Dinv_{i-1} f_{i-1} - E_i^T Dinv_{i+1} f_{i+1}
    Stored per level (odd-indexed, batched): Dinv, HL = Dinv E_{j-1},
    HR = Dinv E_j^T; the even-row weights are their transposes.
    """

    def __init__(self, levels, last_Dinv, nb, b):
        self.levels = tuple(levels)  # ((Dinv, HL, HR), ...) per level
        self.last_Dinv = last_Dinv  # (nb_last, b, b)
        self.nb = nb
        self.b = b

    @staticmethod
    def _inv_spd(Dblocks, jitter=0.0):
        """Batched SPD inverse via Cholesky (batched GEMM work).

        jitter > 0 adds a relative diagonal regularization
        ``D + jitter * diag(D)`` before the Cholesky (Manteuffel shift).
        An f32 Cholesky breaks down (NaN) once the effective condition
        number approaches 1/eps_f32 ~ 1.7e7 — reached by thin-shell
        problems (CRM wingbox: rotation vs membrane DOF scales) and
        compounded by the cyclic-reduction Schur complements. The jittered
        factor is only a *preconditioner* inside RefinedFactor, whose f64
        refinement absorbs the O(jitter) perturbation at ~jitter
        contraction per pass."""
        if jitter:
            diag = jnp.diagonal(Dblocks, axis1=1, axis2=2)
            Dblocks = Dblocks + jax.vmap(jnp.diag)(
                jnp.asarray(jitter, Dblocks.dtype) * diag)
        L = jnp.linalg.cholesky(Dblocks)
        eye = jnp.eye(Dblocks.shape[1], dtype=Dblocks.dtype)
        Linv = jax.vmap(
            lambda Lk: solve_triangular(Lk, eye, lower=True))(L)
        return jnp.einsum("kji,kjl->kil", Linv, Linv)  # Linv^T Linv

    @classmethod
    def from_blocks(cls, D, E, min_blocks=1, store_dtype=None, jitter=0.0):
        nb, b = D.shape[0], D.shape[1]
        if store_dtype is not None:
            D = D.astype(store_dtype)
            E = E.astype(store_dtype)
        dtype = D.dtype
        levels = []
        Dc, Ec = D, E
        while Dc.shape[0] > max(1, min_blocks):
            nb_c = Dc.shape[0]
            n_odd = nb_c // 2
            n_even = nb_c - n_odd
            odd = Dc[1::2]  # (n_odd, b, b)
            Dinv = cls._inv_spd(odd, jitter)
            E_left = Ec[0::2][:n_odd]  # E_{2k}, exact length n_odd
            E_right = Ec[1::2]  # E_{2k+1}
            if E_right.shape[0] < n_odd:  # nb_c even: last odd has no right
                E_right = jnp.concatenate(
                    [E_right, jnp.zeros((n_odd - E_right.shape[0], b, b),
                                        dtype=dtype)])
            HL = jnp.einsum("kij,kjl->kil", Dinv, E_left)
            HR = jnp.einsum("kij,klj->kil", Dinv, E_right)  # Dinv E_right^T

            # D' on evens
            Dn = Dc[0::2]
            # left neighbour term (even k >= 1): HR_{k-1}^T E_right_{k-1}^T
            left = jnp.einsum("kji,klj->kil", HR, E_right)  # HR^T E_right^T
            n_l = min(n_odd, n_even - 1)
            Dn = Dn.at[1:1 + n_l].add(-left[:n_l])
            # right neighbour term (even k < n_odd): HL_k^T E_left_k
            right = jnp.einsum("kji,kjl->kil", HL, E_left)
            Dn = Dn.at[:n_odd].add(-right)
            # E' couples even k -> k+1: -HR_k^T E_left_k, valid while both
            # odd 2k+1 and even 2k+2 exist
            n_enew = n_even - 1
            En = -jnp.einsum("kji,kjl->kil", HR[:n_enew], E_left[:n_enew])

            levels.append((Dinv, HL, HR))
            Dc, Ec = Dn, En
        last_Dinv = cls._inv_spd(Dc, jitter)
        return cls(levels, last_Dinv, nb, b)

    @property
    def shape(self):
        n = self.nb * self.b
        return (n, n)

    @property
    def dtype(self):
        return self.last_Dinv.dtype

    def _solve(self, idx, f):
        """f: (nb_level, b, k) right-hand sides at this level."""
        if idx == len(self.levels):
            return jnp.einsum("kij,kjl->kil", self.last_Dinv, f)
        Dinv, HL, HR = self.levels[idx]
        n_odd = Dinv.shape[0]
        f_even = f[0::2]
        f_odd = f[1::2]
        n_even = f_even.shape[0]

        # f_even' = f_even - HR_{k-1}^T f_odd[k-1] - HL_k^T f_odd[k]
        left = jnp.einsum("kji,kjl->kil", HR, f_odd)
        n_l = min(n_odd, n_even - 1)
        f_even = f_even.at[1:1 + n_l].add(-left[:n_l])
        right = jnp.einsum("kji,kjl->kil", HL, f_odd)
        f_even = f_even.at[:n_odd].add(-right)

        x_even = self._solve(idx + 1, f_even)

        # x_odd = Dinv f_odd - HL x_even[k] - HR x_even[k+1]
        x_odd = jnp.einsum("kij,kjl->kil", Dinv, f_odd)
        x_odd = x_odd - jnp.einsum("kij,kjl->kil", HL, x_even[:n_odd])
        n_r = min(n_odd, n_even - 1)
        x_odd = x_odd.at[:n_r].add(
            -jnp.einsum("kij,kjl->kil", HR[:n_r], x_even[1:1 + n_r]))

        nb_c = n_even + n_odd
        x = jnp.zeros((nb_c,) + x_even.shape[1:], dtype=x_even.dtype)
        x = x.at[0::2].set(x_even).at[1::2].set(x_odd)
        return x

    def mv(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        x = x.astype(self.dtype)
        k = x.shape[1]
        xb = x.reshape(self.nb, self.b, k)
        out = self._solve(0, xb).reshape(self.nb * self.b, k)
        if squeeze:
            out = out[:, 0]
        return out

    def __call__(self, x):
        return self.mv(x)

    def tree_flatten(self):
        return (self.levels, self.last_Dinv), (self.nb, self.b)

    @classmethod
    def tree_unflatten(cls, aux, children):
        levels, last_Dinv = children
        return cls(levels, last_Dinv, *aux)


@jax.tree_util.register_pytree_node_class
class RefinedFactor:
    """Mixed-precision exact solve: f32 factor + f64 iterative refinement.

    apply(x) solves A y = x to f64 working accuracy by refining the f32
    factor's solution with f64 residuals of the matrix-free operator:
        y_{k+1} = y_k + M32^{-1} (x - A y_k)
    Converges at rate ~kappa(A)*eps_f32 per step; the loop is a while_loop
    gated on the f64 residual (cap ``max_refine``). The heavy O(nx*b^2)
    GEMM scans run in f32; the f64 work per step is one
    matrix-free element matvec. This is the scheme the factor's cost model
    needs at scale: the stored factor is 2*nx*b^2 f32 words (e.g. ~5.7 GB
    at 1M DOF on a 700x700 grid) instead of f64 block inverses.
    """

    def __init__(self, inner, op, tol=1e-13, max_refine=20):
        self.inner = inner  # f32 BlockTridiagFactor (or any approx factor)
        self.op = op  # f64 operator for A (matrix-free residuals)
        self.tol = tol
        self.max_refine = max_refine

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return jnp.float64

    def _approx(self, r):
        return self.inner.mv(r.astype(jnp.float32)).astype(jnp.float64)

    def approx_mv(self, r):
        """One preconditioner-quality (f32) solve, no refinement — for
        mixed-precision Krylov ladders that restart on true f64 residuals."""
        return self.inner.mv(r)

    def mv(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        x = x.astype(jnp.float64)
        nrm2 = jnp.sum(x * x, axis=0)
        tol2 = (self.tol**2) * jnp.maximum(nrm2, 1e-300)

        y = self._approx(x)
        big = jnp.full_like(nrm2, jnp.inf)

        def cond(carry):
            k, y, r2, r2_prev = carry
            # stop on tolerance, iteration cap, or stagnation: refinement
            # bottoms out at ~eps64 * cond(A), which can sit above tol —
            # burning the remaining passes buys nothing.
            improving = jnp.sum(r2) < 0.25 * jnp.sum(r2_prev)
            return ((k < self.max_refine) & jnp.any(r2 > tol2)
                    & ((k < 2) | improving))

        def body(carry):
            k, y, r2, _ = carry
            r = x - self.op.mv(y)
            y = y + self._approx(r)
            r2n = jnp.sum(r * r, axis=0)
            return k + 1, y, r2n, r2

        _, y, _, _ = jax.lax.while_loop(
            cond, body, (jnp.asarray(0), y, big, big * 4))
        if squeeze:
            y = y[:, 0]
        return y

    def __call__(self, x):
        return self.mv(x)

    def tree_flatten(self):
        return (self.inner, self.op), (self.tol, self.max_refine)

    @classmethod
    def tree_unflatten(cls, aux, children):
        inner, op = children
        return cls(*children, *aux)


@jax.tree_util.register_pytree_node_class
class PCGFactor:
    """Robust mixed-precision solve for ill-conditioned (thin-shell) systems:
    f64 PCG preconditioned by an f32 factor of the *equilibrated* matrix.

    RefinedFactor's plain iterative refinement needs the preconditioned
    spectral radius < 1, which an f32 factor loses once cond(A) passes
    ~1/eps_f32 (reached by shell models mixing rotation/membrane DOF scales
    — the CRM wingbox role, reference crm.py:62-144). PCG only needs the
    preconditioner SPD: with S = diag(A)^{-1/2} equilibration and a
    Manteuffel diagonal jitter on the f32 blocks (BCRFactor.from_blocks
    jitter=), the solve converges at sqrt(cond(M^-1 A)) — measured 57
    iterations to 4e-13 on a cond-2.6e7 wingbox where refinement diverges.

    inner : f32 factor of S (A) S (e.g. jittered BCRFactor).
    op    : f64 matrix-free operator for A.
    s     : (n,) f64 equilibration scale, S = diag(s).

    Blocked RHS: all k columns advance together with per-column alpha/beta;
    converged columns freeze (their alpha/beta zeroed), the loop exits when
    every column passes tol or at maxiter (the reference surfaces the same
    convergence info from its iterative solvers, _info lists at
    eigenvector_derivatives.py:1224-1319).
    """

    def __init__(self, inner, op, s, mask=None, tol=1e-12, maxiter=200,
                 approx_tol=1e-5, approx_maxiter=30):
        self.inner = inner
        self.op = op
        self.s = s
        # mask: (n,) 1.0 = free DOF, 0.0 = constrained/padded. The operator
        # has zero rows there; completing it with identity (matching the
        # unit diagonals injected into the preconditioner blocks) keeps the
        # PCG system SPD on the FULL space — a zero-curvature direction in
        # an unmasked RHS otherwise drives alpha -> inf -> NaN.
        self.mask = mask
        self.tol = tol
        self.maxiter = maxiter
        self.approx_tol = approx_tol
        self.approx_maxiter = approx_maxiter

    def _opmv(self, p):
        y = self.op.mv(p)
        if self.mask is not None:
            y = y + (1.0 - self.mask)[:, None] * p
        return y

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return jnp.float64

    def _pre(self, r):
        """One preconditioner apply: S M32^{-1} S r (f64 in/out)."""
        return self.s[:, None] * self.inner.mv(
            (self.s[:, None] * r).astype(jnp.float32)).astype(jnp.float64)

    def approx_mv(self, r):
        """Inexact solve for mixed sibk ladders / approx Lanczos sweeps: the
        same PCG loop truncated at (approx_tol, approx_maxiter).

        A single preconditioner apply is NOT enough here (unlike
        GridMGFactor, whose V-cycle already solves to ~1e-1): for thin-shell
        conditioning the equilibrated+jittered f32 BCR apply is only a
        ~O(1)-relative-error map, and a sibk ladder built from it diverges —
        measured at 250k CRM DOF, mode-0 true residual GREW 10x over 3
        rounds. ~20 PCG iterations restore a ~1e-5-quality apply, which the
        outer rounds' true-residual restarts then contract on.

        The loop runs entirely in f32 when the operator exposes element
        data: an f64 element einsum per iteration was the dominant cost of
        the whole CRM pipeline, while the f32 matvec's ~3e-6 relative backward error sits well
        under the 1e-5 approx target. Falls back to the f64 loop for
        operators without .mats.
        """
        if getattr(self.op, "mats", None) is not None:
            return self._pcg32(r, self.approx_tol, self.approx_maxiter)
        return self._pcg(r, self.approx_tol, self.approx_maxiter)[0]

    def _pcg32(self, x, tol, maxiter):
        """approx-channel PCG with f32 state, f32 element matvec (batched
        einsum), f32 preconditioner."""
        from .operators import ElementOperator

        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        x = x.astype(jnp.float32)
        op32 = ElementOperator(self.op.mats.astype(jnp.float32),
                               self.op.dofs, self.op.n)
        s32 = self.s.astype(jnp.float32)
        mask32 = None if self.mask is None else self.mask.astype(
            jnp.float32)

        def opmv(p):
            y = op32.mv(p)
            if mask32 is not None:
                y = y + (1.0 - mask32)[:, None] * p
            return y

        def pre(r):
            return s32[:, None] * self.inner.mv(s32[:, None] * r)

        nrm2 = jnp.sum(x * x, axis=0)
        tol2 = jnp.float32(tol * tol) * jnp.maximum(nrm2, 1e-30)

        r = x
        z = pre(r)
        rz = jnp.sum(r * z, axis=0)
        y = jnp.zeros_like(x)
        p = z
        r2 = nrm2

        def cond(carry):
            k, _, _, r2, _, _ = carry
            return (k < maxiter) & jnp.any(r2 > tol2)

        def body(carry):
            k, y, r, r2, rz, p = carry
            active = r2 > tol2
            Ap = opmv(p)
            pAp = jnp.sum(p * Ap, axis=0)
            alpha = jnp.where(active, rz / jnp.where(pAp == 0.0, 1.0, pAp),
                              0.0)
            y = y + alpha[None, :] * p
            r = r - alpha[None, :] * Ap
            r2n = jnp.sum(r * r, axis=0)
            z = pre(r)
            rzn = jnp.sum(r * z, axis=0)
            beta = jnp.where(active, rzn / jnp.where(rz == 0.0, 1.0, rz),
                             0.0)
            p = z + beta[None, :] * p
            return k + 1, y, r, r2n, rzn, p

        k, y, _, r2, _, _ = jax.lax.while_loop(
            cond, body, (jnp.asarray(0), y, r, r2, rz, p))
        if squeeze:
            y = y[:, 0]
        return y

    def precond_mv(self, r):
        """ONE raw preconditioner apply (ladder='precond' mixed sibk)."""
        squeeze = r.ndim == 1
        if squeeze:
            r = r[:, None]
        y = self._pre(r.astype(jnp.float64))
        return y[:, 0] if squeeze else y

    def mv_info(self, x):
        return self._pcg(x, self.tol, self.maxiter)

    def mv_warm(self, x, x0):
        """Accurate solve warm-started at x0 (the Ritz polish supplies
        Phi * spectral scale, starting the PCG at a relative residual of
        ~the current eigen-residual instead of ~1 — the convergence gate
        stays relative to ||x||, so the guess only removes iterations)."""
        return self._pcg(x, self.tol, self.maxiter, x0=x0)[0]

    def _pcg(self, x, tol, maxiter, x0=None):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
            x0 = None if x0 is None else x0[:, None]
        x = x.astype(jnp.float64)
        nrm2 = jnp.sum(x * x, axis=0)
        tol2 = (tol ** 2) * jnp.maximum(nrm2, 1e-300)

        if x0 is None:
            r = x
            y = jnp.zeros_like(x)
        else:
            y = x0.astype(jnp.float64)
            r = x - self._opmv(y)
        z = self._pre(r)
        rz = jnp.sum(r * z, axis=0)
        p = z
        r2 = jnp.sum(r * r, axis=0)

        def cond(carry):
            k, _, _, r2, _, _ = carry
            return (k < maxiter) & jnp.any(r2 > tol2)

        def body(carry):
            k, y, r, r2, rz, p = carry
            active = r2 > tol2
            Ap = self._opmv(p)
            pAp = jnp.sum(p * Ap, axis=0)
            alpha = jnp.where(active, rz / jnp.where(pAp == 0.0, 1.0, pAp),
                              0.0)
            y = y + alpha[None, :] * p
            r = r - alpha[None, :] * Ap
            r2n = jnp.sum(r * r, axis=0)
            z = self._pre(r)
            rzn = jnp.sum(r * z, axis=0)
            beta = jnp.where(active, rzn / jnp.where(rz == 0.0, 1.0, rz),
                             0.0)
            p = z + beta[None, :] * p
            return k + 1, y, r, r2n, rzn, p

        k, y, _, r2, _, _ = jax.lax.while_loop(
            cond, body, (jnp.asarray(0), y, r, r2, rz, p))
        info = {"niter": k,
                "res": jnp.sqrt(r2 / jnp.maximum(nrm2, 1e-300))}
        if squeeze:
            y = y[:, 0]
        return y, info

    def mv(self, x):
        y, _ = self.mv_info(x)
        return y

    def __call__(self, x):
        return self.mv(x)

    def tree_flatten(self):
        return ((self.inner, self.op, self.s, self.mask),
                (self.tol, self.maxiter, self.approx_tol,
                 self.approx_maxiter))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)
