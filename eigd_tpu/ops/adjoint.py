"""Eigenvector-adjoint solvers and total-derivative assembly.

Rebuild of the reference eigd/eigenvector_derivatives.py:
``laa`` (:394-523), ``dl`` (:526-696), ``pcpg`` (:699-869), ``pgmres``
(:872-1040), ``sibk`` (:1052-1328), ``generate_adjoint_correction`` (:303-391),
``add_eig_total_derivative`` (:33-182) and ``eval_adjoint_residual_norm``
(:185-275).

Key re-designs (not translations):

* **Branchless repeated-eigenvalue corrections.** The reference stores the
  repeated-pair corrections in a Python dict ``{i: [(j, xi, eta)]}``. Here the
  corrections are dense (N, N) matrices ``Xi``/``Eta`` built with masked
  ``jnp.where`` (safe denominators), so the whole degenerate-eigenvector path
  is jittable and the total-derivative contraction stays a batched GEMM.
* **Block-everything.** All adjoint right-hand sides advance together: the
  per-eigenvector loops of pcpg/sibk become (n, N) blocked linear algebra, so
  every factor apply and projection is one matmul over the full block —
  the "block adjoint solves" win called out in SURVEY.md §2.4.
* **Static shapes.** Solvers run a fixed maximum iteration count with
  converged columns frozen by masking; convergence is reported in an info
  array instead of raising.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from .collective import pdot, psum, qr_tall, tdot
from .operators import as_operator
from .lanczos import LanczosResult, _tridiagonal


# ---------------------------------------------------------------------------
# Correction data for repeated / clustered eigenvalues
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class EigCorrection:
    """Dense form of the reference's adjoint-correction dict.

    ``Xi[j, i]`` / ``Eta[j, i]`` multiply ``Phi[:, j]`` in the corrected
    direction for mode ``i``; both are symmetric and vanish except on
    numerically repeated pairs (reference :370-383).
    """

    Xi: jax.Array  # (N, N)
    Eta: jax.Array  # (N, N)

    def tree_flatten(self):
        return (self.Xi, self.Eta), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def no_correction(N, dtype):
    z = jnp.zeros((N, N), dtype=dtype)
    return EigCorrection(z, z)


def are_eigenvalues_repeated(lam, atol=1e-5):
    """True if any adjacent sorted eigenvalues are within atol (ref :284-300)."""
    lam = jnp.asarray(lam)
    return jnp.any(jnp.abs(jnp.diff(lam)) < atol)


def generate_adjoint_correction(lam, Phi, psi, G=None, Phib=None,
                                eig_atol=1e-5, mode="normal", axis=None):
    """Correct the adjoint solution along the computed eigenvector directions.

    Branchless rebuild of reference :303-391. For *distinct* pairs the
    correction folds directly into psi; for numerically *repeated* pairs the
    (xi, eta) coefficients are returned in an EigCorrection for use inside
    ``add_eig_total_derivative``. Requires ``Phi^T B psi = 0`` on entry.

    Returns (psi_corrected, EigCorrection).
    """
    lam = jnp.asarray(lam)
    N = lam.shape[0]
    if G is None:
        G = -pdot(Phi.T, Phib, axis)  # (N, N)

    if mode == "normal":
        G0 = G
    elif mode == "buckling":
        G0 = lam[:, None] * G  # diag(lam) @ G
    else:
        raise ValueError(f"Unknown mode {mode!r}")

    # diff[j, i] = lam[j] - lam[i]
    diff = lam[:, None] - lam[None, :]
    eye = jnp.eye(N, dtype=bool)
    close = (jnp.abs(diff) < eig_atol) & ~eye
    safe = jnp.where(close | eye, 1.0, diff)

    # Distinct pairs: psi[:, i] += G0[j, i] / (lam[j] - lam[i]) * Phi[:, j]
    S = jnp.where(close | eye, 0.0, G0 / safe)
    psi = psi + Phi @ S

    # Repeated pairs. The reference's formulas (:374-375)
    #   Xi[j, i]  = (G0[j, i] - G0[i, j]) / (2 (lam[j] - lam[i]))
    #   Eta[j, i] = (lam[i] G0[j, i] - lam[j] G0[i, j]) / (2 (lam[j] - lam[i]))
    # are rewritten in the algebraically equivalent but numerically stable
    # separated form
    #   R[j, i]   = (G0[j, i] - G0[i, j]) / (lam[j] - lam[i])
    #   Xi[j, i]  = R[j, i] / 2
    #   Eta[j, i] = lam[i] * R[j, i] / 2 - G0[i, j] / 2.
    # Only R contains the 0/0 limit: for an objective with underlying
    # differentiability its numerator vanishes proportionally to the gap,
    # and numerically it bottoms out at rounding noise while the computed
    # gap of a truly repeated pair is O(eps*|lam|). Gaps below the
    # eigenvalue resolution are indistinguishable from zero, so R's divided
    # difference is floored at that scale; the regular -G0^T/2 part of Eta —
    # which is what survives at exact degeneracy — is untouched.
    anti = G0 - G0.T
    floor = 1e-9 * (jnp.abs(lam)[:, None] + jnp.abs(lam)[None, :]) + 1e-30
    mag = jnp.maximum(jnp.abs(diff), floor)
    signed = jnp.where(diff >= 0.0, mag, -mag)
    R = jnp.where(close, anti / signed, 0.0)
    Xi = 0.5 * R
    Eta = jnp.where(close, 0.5 * lam[None, :] * R - 0.5 * G0.T, 0.0)
    return psi, EigCorrection(Xi=Xi, Eta=Eta)


# Backwards-compatible alias used by the solver wrappers.
apply_adjoint_correction = generate_adjoint_correction


# ---------------------------------------------------------------------------
# Total derivative assembly
# ---------------------------------------------------------------------------


def total_derivative_weights(lam, Phi, lamb, Phib, psi, adj_corr_data=None,
                             mode="normal", axis=None):
    """Compute the (n, N) weight blocks W_A, W_B of the total derivative.

    The total derivative is  df/dx = dAdx(W_A, Phi) -/+ dBdx(W_B, Phi)
    (minus for normal mode, plus for buckling), with the per-mode weight
    vectors of reference :91-181 assembled as batched GEMMs:

    normal:   W_A = Phi diag(lamb) + psi + Phi Xi
              W_B = Phi diag(beta + lam*lamb) + psi diag(lam) + Phi Eta
    buckling: W_A = Phi diag(lam^2 lamb) + psi diag(lam) + Phi Eta
              W_B = Phi diag(lam*lamb - beta) + psi + Phi Xi
    with beta_i = 0.5 * phi_i . Phib_i.

    Note on the buckling lamb channel: with the constraint K phi + lam G phi
    = 0 and phi^T K phi = 1, the exact eigenvalue derivative is
    d(lam) = lam phi^T dK phi + lam^2 phi^T dG phi (verified against finite
    differences), so lamb enters the weights scaled by lam. The phi-component
    of the adjoint is c = lam*(lamb + psi^T G phi) and psi^T G phi = 0
    because G phi = -(1/lam) K phi and the solvers keep psi K-orthogonal.
    """
    lam = jnp.asarray(lam)
    N = lam.shape[0]
    if adj_corr_data is None:
        adj_corr_data = no_correction(N, Phi.dtype)
    Xi, Eta = adj_corr_data.Xi, adj_corr_data.Eta
    beta = 0.5 * psum(jnp.sum(Phi * Phib, axis=0), axis)

    if mode == "normal":
        W_A = Phi * lamb[None, :] + psi + Phi @ Xi
        W_B = (Phi * (beta + lam * lamb)[None, :] + psi * lam[None, :]
               + Phi @ Eta)
    elif mode == "buckling":
        W_A = (Phi * (lam * lamb)[None, :] + psi) * lam[None, :] + Phi @ Eta
        W_B = Phi * (lam * lamb - beta)[None, :] + psi + Phi @ Xi
    else:
        raise ValueError(f"Unknown mode {mode!r}")
    return W_A, W_B


def add_eig_total_derivative(lam, Phi, lamb, Phib, psi, dAdx, dBdx, dfdx,
                             adj_corr_data=None, mode="normal",
                             deriv_type="tensor", axis=None):
    """Accumulate the total derivative given the adjoint solution.

    ``dAdx(W, V) = sum_i w_i^T (dA/dx) v_i`` over columns (the reference's
    "tensor" path, :135-181; on device the batched path is always the right one,
    so deriv_type="vector" computes the same contraction).
    """
    del deriv_type  # batched contraction always
    W_A, W_B = total_derivative_weights(lam, Phi, lamb, Phib, psi,
                                        adj_corr_data=adj_corr_data, mode=mode,
                                        axis=axis)
    if mode == "normal":
        if dAdx is not None:
            dfdx = dfdx + dAdx(W_A, Phi)
        if dBdx is not None:
            dfdx = dfdx - dBdx(W_B, Phi)
    else:
        if dAdx is not None:
            dfdx = dfdx + dAdx(W_A, Phi)
        if dBdx is not None:
            dfdx = dfdx + dBdx(W_B, Phi)
    return dfdx


# ---------------------------------------------------------------------------
# Residual / orthogonality diagnostics
# ---------------------------------------------------------------------------


def eval_adjoint_residual_norm(A, B, lam, Phi, Phib, psi, mode="normal",
                               b_ortho=False, axis=None):
    """Residual norms and orthogonality of the adjoint equations (ref :185-275).

    res[i] = || A psi_i - lam_i B psi_i - b_i ||,
    b_i    = -(Phib_i - B phi_i (phi_i . Phib_i)),
    ortho[i] = |phi_i^T B psi_i|  (or max_j |(B phi_j)^T psi_i| if b_ortho).
    """
    A = as_operator(A)
    B = as_operator(B)
    lam = jnp.asarray(lam)
    BPhi = B.mv(Phi)
    proj_coef = psum(jnp.sum(Phi * Phib, axis=0), axis)
    bmat = -(Phib - BPhi * proj_coef[None, :])

    Apsi = A.mv(psi)
    Bpsi = B.mv(psi)
    if mode == "normal":
        r = Apsi - Bpsi * lam[None, :] - bmat
    elif mode == "buckling":
        r = Bpsi + Apsi * lam[None, :] - bmat
    else:
        raise ValueError(f"Unknown mode {mode!r}")

    if b_ortho:
        r = r - BPhi @ pdot(Phi.T, r, axis)
        ortho = jnp.max(jnp.abs(pdot(BPhi.T, psi, axis)), axis=0)
    else:
        ortho = jnp.abs(psum(jnp.sum(BPhi * psi, axis=0), axis))
    res = jnp.sqrt(psum(jnp.sum(r * r, axis=0), axis))
    return res, ortho


# ---------------------------------------------------------------------------
# LAA — Lanczos adjoint approximation (Galerkin in the Lanczos subspace)
# ---------------------------------------------------------------------------


def laa(Phib, B, factor, res: LanczosResult, D0=None, b_ortho=False,
        mode="normal", axis=None, approx=False):
    """Galerkin solution of the adjoint equations in the Lanczos subspace.

    Rebuild of reference :394-523, with the (m, N) divided-difference matrix D
    formed branchlessly in sorted-Ritz coordinates:

    D[i, j] = (Ys_i . Yb_j) / (theta_j - theta_i)  with masked entries, then
    psi = -factor(B V (Ys (D * scale))),  scale = 1/(lam - sigma)  (normal)
                                          scale = sigma/(lam - sigma) (buckling)
    """
    B = as_operator(B)
    m = res.m
    N = Phib.shape[1]
    V = res.V[:m]  # (m, n) rows
    Ys = res.Ys  # (m, m)
    theta_s = res.theta_s  # (m,)
    lam = res.lam[:N]
    sigma = res.sigma

    Yb = pdot(V, Phib, axis)  # (m, N)
    C = Ys.T @ Yb  # (m, N); C[i, j] = Ys[:, i] . Yb[:, j]

    if D0 is not None:
        D = D0
    else:
        denom = theta_s[None, :N] - theta_s[:, None]  # (m, N)
        rows = jnp.arange(m)[:, None]
        cols = jnp.arange(N)[None, :]
        if b_ortho:
            mask = rows >= N  # zero coefficient on every selected direction
        else:
            mask = rows != cols
        safe = jnp.where(mask & (denom != 0.0), denom, 1.0)
        D = jnp.where(mask & (denom != 0.0), C / safe, 0.0)
        # Directions never measured (adaptive-exit rows past niter, or
        # Gram-truncated directions in local-ortho mode) carry a fabricated
        # theta = 0; their Yb components are junk, so zero their rows
        # (ADVICE r1: without this, adjoint_method='laa' passes the error
        # uncorrected into gradients).
        good = jnp.abs(theta_s) > 1e-12 * jnp.max(jnp.abs(theta_s))
        D = D * good[:, None]

    if mode == "normal":
        scale = 1.0 / (lam - sigma)
    elif mode == "buckling":
        scale = sigma / (lam - sigma)
    else:
        raise ValueError(f"Unknown mode {mode!r}")

    t = Ys @ (D * scale[None, :])  # (m, N)
    # contract V's row dim directly: a user-level V.T may form an (n, m)
    # f64 copy
    rhs = B.mv(tdot(V, t))
    # approx=True: preconditioner-quality factor apply — the LAA result is
    # only an initial guess for the Krylov adjoint, so when a mixed-
    # precision ladder follows, a full-accuracy (multi-pass refined) apply
    # buys nothing
    mv = getattr(factor, "approx_mv", None) if approx else None
    if mv is not None:
        psi = -mv(rhs.astype(jnp.float32)).astype(Phib.dtype)
    else:
        psi = -factor.mv(rhs)
    return psi


# ---------------------------------------------------------------------------
# Least-squares helper for shifted projected systems
# ---------------------------------------------------------------------------


def _lstsq_qr(Amat, b):
    """min || A y - b || via reduced QR (no LU/SVD needed)."""
    q, r = jnp.linalg.qr(Amat)
    y = solve_triangular(r, q.T @ b, lower=False)
    resid = Amat @ y - b
    return y, jnp.sqrt(jnp.sum(resid * resid))


def _solve_shifted_lstsq(alpha, H0, r):
    """Solve min ||(I - alpha*H0) y - r|| with rectangular identity
    (reference _solve_lstsq, :1043-1049)."""
    M, K = H0.shape
    I = jnp.eye(M, K, dtype=H0.dtype)
    return _lstsq_qr(I - alpha * H0, r)


# ---------------------------------------------------------------------------
# SIBK — shift-invert block Krylov (the flagship adjoint solver)
# ---------------------------------------------------------------------------


def _projected_adjoint_residual(Phib, A, B, lam, Phi, BPhi, psi, mode, axis):
    """R = proj(-Phib - (A - lam B) psi): the sibk outer-round residual."""
    if mode == "normal":
        Rm = -Phib - (A.mv(psi) - B.mv(psi) * lam[None, :])
    else:
        Rm = -Phib - (B.mv(psi) + A.mv(psi) * lam[None, :])
    return Rm - BPhi @ pdot(Phi.T, Rm, axis)


def sibk_true_resnorm(Phib, A, B, lam, Phi, psi, mode="normal", axis=None):
    """Absolute projected-residual norms of the N adjoint systems — the
    quantity :func:`sibk`'s outer rounds restart on. Standalone so a
    host-chunked round loop (:func:`sibk_round`) can evaluate its own
    convergence/stagnation control between dispatches."""
    A = as_operator(A)
    B = as_operator(B)
    lam = jnp.asarray(lam)
    R = _projected_adjoint_residual(Phib, A, B, lam, Phi, B.mv(Phi), psi,
                                    mode, axis)
    return jnp.sqrt(psum(jnp.sum(R * R, axis=0), axis))


def _sibk_setup(Phib, A, B, lam, Phi, mode="normal", sigma=None,
                factor=None, rtol=1e-10, atol=1e-30, maxiter=50,
                check_every=3, axis=None, mixed=False, ladder="approx"):
    """Build the sibk round machinery shared by the fused solver (:func:`sibk`)
    and the host-chunked round program (:func:`sibk_round`).

    Everything here is a pure function of the arguments, so tracing it inside
    a jit with (A, B, factor) as *pytree arguments* produces the same program
    whether the outer rounds run as a ``lax.while_loop`` (fused) or as one
    dispatch per round from the host (chunked).
    """
    A = as_operator(A)
    B = as_operator(B)
    lam = jnp.asarray(lam)
    n, N = Phib.shape
    dtype = Phib.dtype

    BPhi = B.mv(Phi)
    G = -pdot(Phi.T, Phib, axis)
    rnorm0 = jnp.sqrt(jnp.max(psum(jnp.sum(Phib * Phib, axis=0), axis)))
    tol = jnp.maximum(rtol * rnorm0, atol)

    if mode == "normal":
        alphas = lam - sigma
    elif mode == "buckling":
        alphas = -(lam - sigma)
    else:
        raise ValueError(f"Unknown mode {mode!r}")

    def op_residual(psi_):
        return _projected_adjoint_residual(Phib, A, B, lam, Phi, BPhi, psi_,
                                           mode, axis)

    def true_resnorm(psi_):
        R = op_residual(psi_)
        return jnp.sqrt(psum(jnp.sum(R * R, axis=0), axis))

    # The ladder extends N vectors per factor apply (one block step): a
    # blocked factor apply costs the same as a single-vector one (the
    # solve sweeps are latency/bandwidth-bound), so the block form cuts the
    # number of factor applies by ~N for the same Krylov dimension. T block
    # steps give a ladder of K = T*N vectors.
    T = max(1, -(-maxiter // N))
    K = T * N
    eyeK = jnp.eye(K + N, K, dtype=dtype)
    eyeK_low = jnp.eye(K + N, K, k=-N, dtype=dtype)
    col = jnp.arange(K + N)

    ldt = jnp.float32 if (mixed and dtype == jnp.float64) else dtype
    lcast = (lambda x: x.astype(ldt)) if ldt != dtype else (lambda x: x)
    # Mixed-ladder apply: "approx" = preconditioner-quality f32 PCG solve
    # (~1e-5, ~10-18 V-cycles); "precond" = ONE raw V-cycle — ~10x cheaper
    # per step, weaker per-round contraction. The batched lstsq minimizes
    # the surrogate residual over whatever Krylov space the apply spans and
    # the outer rounds restart on TRUE f64 residuals either way, so the
    # choice trades steps-per-round against V-cycles-per-step.
    approx = None
    if ldt != dtype:
        if ladder == "precond":
            approx = getattr(factor, "precond_mv", None)
        if approx is None:
            approx = getattr(factor, "approx_mv", None)
    factor_lmv = approx if approx is not None else factor.mv
    Phi_l = lcast(Phi)
    BPhi_l = lcast(BPhi)

    def proj_l(X):
        return X - BPhi_l @ pdot(Phi_l.T, X, axis)

    def solve_all(H, r0, cheap=False):
        """Batched shifted lstsq over the (possibly truncated) ladder.

        Ladder columns that were never built (all-zero H columns after an
        early exit) are replaced by unit columns at rows >= j+N — NOT at
        their own row j, which real columns' residual lives on: a unit at
        (j, j) would let the least-squares zero the beta-coupling residual
        rows with spurious components and report false convergence.

        cheap=True solves via regularized normal equations (a (K, K)
        Cholesky instead of a Householder QR). Used ONLY for the in-loop convergence checks, where a
        slightly perturbed residual estimate just shifts the exit step;
        the ladder update itself always uses the QR path.
        """
        H = H.astype(dtype)
        cn = jnp.sum(H * H, axis=0)
        unit = (cn == 0.0).astype(dtype)
        I_mat = eyeK * (1.0 - unit)[None, :] + eyeK_low * unit[None, :]
        rhs = jnp.zeros((K + N, N), dtype=dtype).at[:N].set(
            r0.astype(dtype))

        if cheap:
            def solve_one(alpha_i, r_i):
                Amat = I_mat - alpha_i * H
                G = Amat.T @ Amat
                G = G + (1e-14 * jnp.trace(G) / K) * jnp.eye(
                    K, dtype=dtype)
                L = jnp.linalg.cholesky(G)
                z = solve_triangular(L, Amat.T @ r_i, lower=True)
                y = solve_triangular(L.T, z, lower=False)
                resid = Amat @ y - r_i
                return y, jnp.sqrt(jnp.sum(resid * resid))
        else:
            def solve_one(alpha_i, r_i):
                return _lstsq_qr(I_mat - alpha_i * H, r_i)

        return jax.vmap(solve_one, in_axes=(0, 1), out_axes=(1, 0))(
            alphas, rhs)

    def one_round(psi_, eps_f):
        R = lcast(op_residual(psi_))
        # The within-round exit is gated at eps_f * (round residual scale):
        # surrogate accuracy below the round's achievable TRUE contraction
        # (the factor-apply quality) is wasted ladder steps. eps_f starts at
        # the mixed-ladder design floor and is RE-MEASURED from the achieved
        # contraction of each completed round (self-calibrating: an f32
        # direct factor of an ill-conditioned shift really delivers ~1e-2
        # per round, not 3e-6 — measured at 263k DOF, round 1).
        rnorm_round = jnp.sqrt(
            jnp.max(psum(jnp.sum(R * R, axis=0), axis))).astype(dtype)
        tol_round = jnp.maximum(tol, eps_f * rnorm_round)
        # Seed the block: thin QR of the projected residuals (R is already in
        # the projected subspace, so the Q columns stay there).
        Wseed, r0 = qr_tall(R, axis)  # (n, N), (N, N)
        W = jnp.zeros((K + N, n), dtype=ldt).at[:N].set(Wseed.T)
        Z = jnp.zeros((K, n), dtype=ldt) + 0.0 * Wseed[None, :, 0]
        H = jnp.zeros((K + N, K), dtype=ldt)

        def step(t, W, Z, H):
            lo = t * N
            Wblk = jax.lax.dynamic_slice_in_dim(W, lo, N, axis=0)  # (N, n)
            Zblk = lcast(factor_lmv(Wblk.T))  # (n, N) blocked apply
            if mode == "normal":
                w = proj_l(lcast(B.mv(Zblk)))
            else:
                w = proj_l(lcast(A.mv(Zblk)))
            mask = (col < lo + N).astype(ldt)

            def ladder_T_dot(rows, h):
                # contract the ladder's row dim without an (n, K+N) copy
                return jax.lax.dot_general(
                    rows, h, (((0,), (0,)), ((), ())),
                    preferred_element_type=rows.dtype)

            h1 = pdot(W, w, axis) * mask[:, None]
            w = w - ladder_T_dot(W, h1)
            h2 = pdot(W, w, axis) * mask[:, None]
            w = w - ladder_T_dot(W, h2)
            w = proj_l(w)
            h = h1 + h2  # ((K+N), N)
            Qb, Rb = qr_tall(w, axis)
            W = jax.lax.dynamic_update_slice_in_dim(W, Qb.T, lo + N, axis=0)
            Z = jax.lax.dynamic_update_slice_in_dim(Z, Zblk.T, lo, axis=0)
            rowmask = ((col >= lo + N) & (col < lo + 2 * N)).astype(ldt)
            Rpad = jnp.zeros((K + N, N), dtype=ldt)
            Rpad = jax.lax.dynamic_update_slice(Rpad, Rb, (lo + N, 0))
            h = h * (1.0 - rowmask)[:, None] + Rpad
            H = jax.lax.dynamic_update_slice(H, h, (0, lo))
            return W, Z, H

        def cond(carry):
            t, done = carry[0], carry[1]
            return (t < T) & ~done

        def body(carry):
            t, done, W, Z, H = carry
            W, Z, H = step(t, W, Z, H)
            t1 = t + 1
            do_check = ((t1 % check_every) == 0) & (t1 < T)

            def check():
                # Ladder columns >= t1*N are zero, so the masked lstsq solves
                # the truncated systems exactly (zero extra components).
                _, res = solve_all(H, r0, cheap=True)
                return jnp.all(res < tol_round)

            done = jax.lax.cond(do_check, check, lambda: jnp.asarray(False))
            return t1, done, W, Z, H

        carry = (jnp.asarray(0), jnp.asarray(False), W, Z, H)
        t_end, _, W, Z, H = jax.lax.while_loop(cond, body, carry)

        # The round update also solves via the regularized normal equations:
        # at the moderate conditioning of the shifted projected systems the
        # update error (~cond^2 * eps64) sits below the ladder's own floor,
        # and the outer rounds restart on TRUE residuals anyway — while a
        # vmapped Householder QR per round costs more.
        Ymat, resids = solve_all(H, r0, cheap=True)
        psi_ = psi_ + jax.lax.dot_general(
            Z, lcast(Ymat), (((0,), (0,)), ((), ())),
            preferred_element_type=ldt).astype(dtype)
        return psi_, resids, t_end * N

    import types as _types

    return _types.SimpleNamespace(
        one_round=one_round, true_resnorm=true_resnorm, tol=tol,
        rnorm0=rnorm0, G=G, BPhi=BPhi,
        floor0=(3e-6 if ldt != dtype else 1e-14))


def sibk_round(Phib, A, B, lam, Phi, psi, eps_f, mode="normal", sigma=None,
               factor=None, rtol=1e-10, atol=1e-30, maxiter=50,
               check_every=3, axis=None, mixed=False, ladder="approx"):
    """ONE outer sibk round as a standalone pure function.

    Host-chunked execution support: at CRM scale the adjoint can be
    dispatched one round at a time with the (small) round carry crossing the
    host boundary, keeping each device execution short. Same math as one iteration of :func:`sibk`'s outer
    while_loop.

    Returns (psi, resids, resn_true, tol) — ``resn_true`` are the absolute
    true residual norms after the round and ``tol`` the absolute stopping
    tolerance, so the host loop's convergence/stagnation logic can mirror
    :func:`sibk`'s ``round_cond`` exactly.
    """
    s = _sibk_setup(Phib, A, B, lam, Phi, mode=mode, sigma=sigma,
                    factor=factor, rtol=rtol, atol=atol, maxiter=maxiter,
                    check_every=check_every, axis=axis, mixed=mixed,
                    ladder=ladder)
    psi, resids, nsteps = s.one_round(psi, eps_f)
    return psi, resids, s.true_resnorm(psi), s.tol


def sibk_finish(Phib, B, lam, Phi, psi, mode="normal", eig_atol=1e-5,
                axis=None):
    """Final projection + repeated-eig correction for a host-chunked sibk
    solve (the tail of :func:`sibk` after its rounds loop)."""
    B = as_operator(B)
    BPhi = B.mv(Phi)
    G = -pdot(Phi.T, Phib, axis)
    psi = psi - Phi @ pdot(BPhi.T, psi, axis)
    return generate_adjoint_correction(lam, Phi, psi, G=G,
                                       eig_atol=eig_atol, mode=mode,
                                       axis=axis)


def sibk(Phib, A, B, lam, Phi, mode="normal", psi=None, sigma=None,
         factor=None, rtol=1e-10, atol=1e-30, eig_atol=1e-5, maxiter=50,
         nrestart=2, check_every=3, bs_target=None, update_guess=None,
         callback=None, axis=None, mixed=False, ladder="approx"):
    """Shift-invert block Krylov adjoint solver.

    Redesign of reference :1052-1328. The reference advances the N
    adjoint systems in blocks of ``bs_target`` (default 1), growing one Krylov
    ladder per block with data-dependent convergence loops. Here the block is
    *always the full set of N right-hand sides*: one shared Krylov space is
    grown per round (every factor apply and projection is a blocked GEMM),
    the N shifted projected systems ``(I - alpha_i H) y_i = r_i`` with
    ``alpha_i = +/-(lam_i - sigma)`` are solved by batched QR least-squares,
    and up to ``nrestart`` outer rounds restart from the true residuals. This
    is the reference's ``update_guess=True`` mode taken to its batched limit.

    Convergence control (reference :1312-1321 restart budget and :1268-1276
    per-system exits, made jit-compatible): the ladder is a while_loop that
    every ``check_every`` steps solves the projected least-squares systems
    and exits once all N residuals are below ``tol = max(rtol * ||Phib||,
    atol)``; rounds are a while_loop that stops when the *true* residuals
    meet the same tolerance. Factor applies therefore track the difficulty
    of the solve instead of burning the full ``nrestart * maxiter`` budget.

    With ``axis`` set, all DOF-dimension reductions are psum'd over the
    shard_map axis (seed QR becomes CholeskyQR2).

    With ``mixed=True`` the whole ladder (basis, factor applies via
    ``factor.approx_mv`` when available, GEMMs) runs in f32 while the outer
    rounds restart on true f64 residuals — GMRES-IR-style mixed precision.
    Each round then contracts by the f32 solve quality (~1e-5) instead of
    converging in one, so give it nrestart ~ 4; an f32 ladder step moves
    half the bytes of an f64 one.

    Returns (psi, EigCorrection, info) with info = dict(res=(N,) final true
    relative residuals, niter=total ladder steps run, rounds=rounds run,
    hist=(nrestart, N) per-round residual history — the jit-compatible form
    of the reference's callback residual curves, natural_frequency.py:444-451).
    """
    del bs_target, update_guess, callback  # absorbed by the batched design
    s = _sibk_setup(Phib, A, B, lam, Phi, mode=mode, sigma=sigma,
                    factor=factor, rtol=rtol, atol=atol, maxiter=maxiter,
                    check_every=check_every, axis=axis, mixed=mixed,
                    ladder=ladder)
    N = Phib.shape[1]
    dtype = Phib.dtype

    if psi is None:
        psi = jnp.zeros_like(Phib)

    one_round = s.one_round
    true_resnorm = s.true_resnorm
    tol, rnorm0, floor0 = s.tol, s.rnorm0, s.floor0

    hist = jnp.full((max(1, nrestart), N), jnp.nan, dtype=dtype)

    def round_cond(carry):
        r, psi_, resn, _, _, eps_f, contraction = carry
        # stop on budget, convergence, or round-level stagnation (the last
        # round bought < 40% reduction: the ladder is at its quality floor
        # and further rounds burn factor applies without progress)
        return ((r < max(1, nrestart)) & jnp.any(resn > tol)
                & (contraction < 0.6))

    def round_body(carry):
        r, psi_, resn_prev, hist, nsteps, eps_f, _ = carry
        psi_, resids, t_end = one_round(psi_, eps_f)
        hist = hist.at[r].set(resids)
        resn = true_resnorm(psi_)
        achieved = jnp.max(resn) / jnp.maximum(jnp.max(resn_prev), 1e-300)
        eps_next = jnp.clip(0.5 * achieved, floor0, 0.5)
        return (r + 1, psi_, resn, hist, nsteps + t_end, eps_next,
                achieved)

    resn0 = true_resnorm(psi)
    carry = (jnp.asarray(0), psi, resn0, hist, jnp.asarray(0),
             jnp.asarray(floor0, dtype=dtype), jnp.asarray(0.0, dtype=dtype))
    rounds, psi, resn, hist, nsteps, _, _ = jax.lax.while_loop(
        round_cond, round_body, carry)

    # Enforce the orthogonality constraint Phi^T B psi = 0 explicitly before
    # the eigendirection fold-in: the Krylov update can leak tiny in-span
    # ghost components that the nearly-singular shifted solves amplify, and
    # the correction supplies the exact in-span values anyway.
    psi = psi - Phi @ pdot(s.BPhi.T, psi, axis)
    psi, data = generate_adjoint_correction(lam, Phi, psi, G=s.G,
                                            eig_atol=eig_atol, mode=mode)
    denom = jnp.maximum(rnorm0, 1e-300)
    info = {
        "res": resn / denom,
        "niter": nsteps,
        "rounds": rounds,
        "hist": hist / denom,
    }
    return psi, data, info


# ---------------------------------------------------------------------------
# PCPG — preconditioned conjugate projected gradient (block form)
# ---------------------------------------------------------------------------


def pcpg(Phib, A, B, lam, Phi, mode="normal", psi=None, sigma=None,
         factor=None, rtol=1e-10, atol=1e-30, eig_atol=1e-5, maxiter=100,
         reset=25, callback=None, axis=None, precond=None, deflate=None):
    """PCPG adjoint solver (Alvin, AIAA J. 1997), reference :699-869.

    All N systems advance together as an (n, N) block with per-column scalar
    coefficients; converged columns are frozen by masking, and the loop exits
    once every column converges (reference :832-840). info carries the
    per-iteration residual history (the reference's callback curves).

    ``precond``: optional cheap preconditioner apply replacing the exact
    ``factor.mv``. The key redesign for large n: the projected operator
    (A - lam_i B) restricted to the B-orthogonal complement of the computed
    modes is SPD, so ONE f32 multigrid V-cycle (GridMGFactor.precond_mv) or
    one f32 direct-factor apply (RefinedFactor.approx_mv) per iteration is
    enough — CG brings the convergence control that the exact factor apply
    (a full inner PCG solve, ~15x a V-cycle at 1M DOF) duplicated. With the
    LAA initial guess the initial residual is depleted on all RESOLVED Ritz
    directions, so the effective condition number is governed by the first
    unresolved eigenvalue, not lam_{N+1}. The beta update is flexible
    (Polak-Ribiere) so the slightly nonlinear f32 preconditioner cannot
    break conjugacy. Inputs to ``precond`` are cast to the preconditioner's
    own dtype contract (f32 in, f32 out) and results back to f64.

    ``deflate``: optional (U, BU) pair of B-orthonormal row bases of modes
    deflated out of the FORWARD solve (e.g. rigid-body modes, known
    eigenvalue 0). The projected operator is indefinite on that subspace
    ((0 - lam_i) < 0), which would break CG; instead the deflated-mode
    components of the adjoint are resolved EXPLICITLY —
    psi_i += u_r (u_r . Phib_i) / lam_i, the exact solution along a known
    eigendirection — and every CG iterate is kept B-orthogonal to U.
    Normal mode only (the deflation feature itself is normal-mode only).
    """
    del callback
    A = as_operator(A)
    B = as_operator(B)
    lam = jnp.asarray(lam)
    n, N = Phib.shape
    dtype = Phib.dtype

    if psi is None:
        psi = jnp.zeros_like(Phib)

    BPhi = B.mv(Phi)
    rnorm0 = jnp.sqrt(jnp.max(psum(jnp.sum(Phib * Phib, axis=0), axis)))
    tol = jnp.maximum(rtol * rnorm0, atol)

    if precond is None:
        def M(Zp):
            return factor.mv(Zp)
    else:
        def M(Zp):
            return precond(Zp.astype(jnp.float32)).astype(dtype)

    if deflate is not None:
        if mode != "normal":
            raise NotImplementedError(
                "pcpg deflation handling is normal-mode only")
        U, BU = deflate
        # exact adjoint components along the deflated eigendirections
        psi = psi + tdot(U, pdot(U, Phib, axis) / lam[None, :])

        def defl_r(X):  # residual-space projection (coefficients u_r . X)
            return X - tdot(BU, pdot(U, X, axis))

        def defl_z(X):  # solution-space projection (coefficients Bu_r . X)
            return X - tdot(U, pdot(BU, X, axis))
    else:
        def defl_r(X):
            return X

        def defl_z(X):
            return X

    if mode == "normal":
        R = -Phib - (A.mv(psi) - B.mv(psi) * lam[None, :])
    elif mode == "buckling":
        R = -Phib - (B.mv(psi) + A.mv(psi) * lam[None, :])
    else:
        raise ValueError(f"Unknown mode {mode!r}")
    G = pdot(Phi.T, R, axis)
    R = defl_r(R - BPhi @ G)

    def cond(carry):
        k, psi, R, Rprev, P0, zTr_prev, hist = carry
        resn2 = psum(jnp.sum(R * R, axis=0), axis)
        return (k < maxiter) & jnp.any(resn2 > tol * tol)

    def body(carry):
        k, psi, R, Rprev, P0, zTr_prev, hist = carry
        resn = jnp.sqrt(psum(jnp.sum(R * R, axis=0), axis))
        hist = hist.at[k].set(resn)
        active = resn > tol

        Zp = defl_r(R - BPhi @ pdot(Phi.T, R, axis))
        Z = M(Zp)
        Z = defl_z(Z - Phi @ pdot(BPhi.T, Z, axis))

        zTr = psum(jnp.sum(Z * R, axis=0), axis)
        # Flexible (Polak-Ribiere) beta: zTr - z . r_prev vanishes for an
        # exact fixed preconditioner (orthogonality of successive projected
        # residuals) but keeps the directions conjugate when M is a noisy
        # f32 V-cycle. Periodic hard reset as in the reference (:832-840).
        zTr_flex = zTr - psum(jnp.sum(Z * Rprev, axis=0), axis)
        is_reset = (k % reset) == 0
        beta = jnp.where(is_reset, 0.0,
                         zTr_flex / jnp.where(zTr_prev == 0.0, 1.0,
                                              zTr_prev))
        P = Z + beta[None, :] * P0

        tA = A.mv(P)
        tB = B.mv(P)
        if mode == "normal":
            denom = psum(jnp.sum(tA * P, axis=0)
                         - lam * jnp.sum(tB * P, axis=0), axis)
        else:
            denom = psum(jnp.sum(tB * P, axis=0)
                         + lam * jnp.sum(tA * P, axis=0), axis)
        step = jnp.where(active & (denom > 0.0),
                         zTr / jnp.where(denom == 0.0, 1.0, denom), 0.0)

        psi = psi + step[None, :] * P
        if mode == "normal":
            Rn = R - step[None, :] * (tA - tB * lam[None, :])
        else:
            Rn = R - step[None, :] * (tB + tA * lam[None, :])
        return k + 1, psi, Rn, R, P, zTr, hist

    P0 = 0.0 * R
    zTr0 = jnp.ones((N,), dtype=R.dtype)
    hist0 = jnp.full((maxiter, N), jnp.nan, dtype=R.dtype)
    niter, psi, R, _, _, _, hist = jax.lax.while_loop(
        cond, body, (jnp.asarray(0), psi, R, 0.0 * R, P0, zTr0, hist0))

    psi = psi - Phi @ pdot(BPhi.T, psi, axis)
    psi, data = generate_adjoint_correction(lam, Phi, psi, G=G,
                                            eig_atol=eig_atol, mode=mode)
    denom = jnp.maximum(rnorm0, 1e-300)
    info = {
        "res": jnp.sqrt(psum(jnp.sum(R * R, axis=0), axis)) / denom,
        "niter": niter,
        "hist": hist / denom,
    }
    return psi, data, info


# ---------------------------------------------------------------------------
# PGMRES — projected right-preconditioned GMRES (vmapped over modes)
# ---------------------------------------------------------------------------


def pgmres(Phib, A, B, lam, Phi, mode="normal", psi=None, sigma=None,
           factor=None, rtol=1e-10, atol=1e-30, eig_atol=1e-5, maxiter=50,
           check_every=8, callback=None, axis=None):
    """Projected GMRES adjoint solver, reference :872-1040.

    Each eigenvector has its own shifted operator, so the Arnoldi recurrences
    are independent; they are batched with vmap (the factor and matvec then
    run as batched GEMMs over the N systems). Every ``check_every`` steps the
    Hessenberg least-squares residual is evaluated and a converged system's
    recurrence freezes (reference's per-iteration exit, :1019-1033); info
    carries the per-check residual history.

    Memory note: the vmapped per-mode Arnoldi bases are O(N * K * n) —
    fine as a cross-validation method at moderate n, but at large n use
    ``sibk`` (one shared ladder, O((K + N) * n)); same guidance applies to
    pcpg's per-iteration O(N * n) work with an exact factor.
    """
    del callback
    A = as_operator(A)
    B = as_operator(B)
    lam = jnp.asarray(lam)
    n, N = Phib.shape
    dtype = Phib.dtype

    if psi is None:
        psi = jnp.zeros_like(Phib)

    BPhi = B.mv(Phi)
    rnorm0 = jnp.sqrt(jnp.max(psum(jnp.sum(Phib * Phib, axis=0), axis)))
    tol = jnp.maximum(rtol * rnorm0, atol)

    if mode == "normal":
        R0 = -Phib - (A.mv(psi) - B.mv(psi) * lam[None, :])
    elif mode == "buckling":
        R0 = -Phib - (B.mv(psi) + A.mv(psi) * lam[None, :])
    else:
        raise ValueError(f"Unknown mode {mode!r}")
    G = pdot(Phi.T, R0, axis)
    R0 = R0 - BPhi @ G

    K = maxiter
    col = jnp.arange(K + 1)
    nhist = K // check_every + 1

    def _safe_H(H):
        """Replace all-zero Hessenberg columns (steps never run after an
        early exit) with unit subdiagonal columns so the lstsq stays full
        rank; their solution components are exactly zero."""
        cn = jnp.sum(H * H, axis=0)
        unit = (cn == 0.0).astype(H.dtype)
        return H + jnp.eye(K + 1, K, k=-1, dtype=H.dtype) * unit[None, :]

    def solve_mode(r0, lam_i):
        beta0 = jnp.sqrt(psum(r0 @ r0, axis))
        W = jnp.zeros((K + 1, n), dtype=dtype)
        W = W.at[0].set(jnp.where(beta0 > 0.0, r0 / jnp.where(beta0 == 0.0, 1.0, beta0), 0.0))
        H = jnp.zeros((K + 1, K), dtype=dtype)
        Z = jnp.zeros((K, n), dtype=dtype) + 0.0 * r0[None, :]
        hist = jnp.full((nhist,), jnp.nan, dtype=dtype)

        def cond(carry):
            j, done = carry[0], carry[1]
            return (j < K) & ~done

        def body(carry):
            j, done, W, H, Z, hist = carry
            zp = W[j] - BPhi @ pdot(Phi.T, W[j], axis)
            z = factor.mv(zp)
            tA = A.mv(z)
            tB = B.mv(z)
            if mode == "normal":
                w = tA - lam_i * tB
            else:
                w = tB + lam_i * tA
            w = w - BPhi @ pdot(Phi.T, w, axis)
            mask = (col <= j).astype(dtype)
            h1 = pdot(W, w, axis) * mask
            w = w - W.T @ h1
            h2 = pdot(W, w, axis) * mask
            w = w - W.T @ h2
            h = h1 + h2
            nw2 = psum(w @ w, axis)
            ok = nw2 > 1e-60
            nw = jnp.sqrt(jnp.where(ok, nw2, 1.0))
            W = W.at[j + 1].set(jnp.where(ok, 1.0, 0.0) * w / nw)
            H = H.at[:, j].set(h.at[j + 1].set(jnp.where(ok, nw, 0.0)))
            Z = Z.at[j].set(z)
            j1 = j + 1
            do_check = (j1 % check_every) == 0

            def check(hist):
                rhs = jnp.zeros(K + 1, dtype=dtype).at[0].set(beta0)
                _, res = _lstsq_qr(_safe_H(H), rhs)
                hist = hist.at[j1 // check_every].set(res)
                return res < tol, hist

            done, hist = jax.lax.cond(
                do_check, check,
                lambda hist: (jnp.asarray(False), hist), hist)
            return j1, done, W, H, Z, hist

        carry = (jnp.asarray(0), jnp.asarray(False), W, H, Z, hist)
        niter, _, W, H, Z, hist = jax.lax.while_loop(cond, body, carry)
        rhs = jnp.zeros(K + 1, dtype=dtype).at[0].set(beta0)
        y, res = _lstsq_qr(_safe_H(H), rhs)
        dpsi = Z.T @ y
        return dpsi, res, niter, hist

    dpsi, res, niters, hist = jax.vmap(
        solve_mode, in_axes=(1, 0), out_axes=(1, 0, 0, 0))(R0, lam)
    # Skip systems whose initial residual already met the tolerance.
    beta0 = jnp.sqrt(psum(jnp.sum(R0 * R0, axis=0), axis))
    use = (beta0 >= tol).astype(dtype)
    psi = psi + dpsi * use[None, :]

    psi = psi - Phi @ pdot(BPhi.T, psi, axis)
    psi, data = generate_adjoint_correction(lam, Phi, psi, G=G,
                                            eig_atol=eig_atol, mode=mode)
    denom = jnp.maximum(rnorm0, 1e-300)
    info = {
        "res": res / denom,
        "niter": jnp.sum(niters),
        "hist": hist / denom,
    }
    return psi, data, info


# ---------------------------------------------------------------------------
# DL — direct linearization (exact reverse-mode through the Lanczos recurrence)
# ---------------------------------------------------------------------------


def dl(Phib, B, factor, res: LanczosResult, mode="normal", eig_atol=1e-5):
    """Exact reverse-mode differentiation through the three-term shift-invert
    Lanczos recurrence (reference :526-696).

    The reverse sweep reconstructs the forward intermediates from the stored
    basis V and tridiagonal T, running two factor applies per step; the
    per-step vector updates are expressed as masked rank-1 GEMMs so the sweep
    is a single lax.fori_loop.

    Fully jit-compatible (VERDICT r1 §7): the reference branches on a host-
    side repeated-eigenvalue check (:607-620); here the "repeated" seed
    modification Rmod = Phib + B Phi G is applied unconditionally — it is
    algebraically valid for distinct eigenvalues too (the in-span seed
    components removed from the recurrence are restored exactly by the
    branchless distinct-pair fold in ``generate_adjoint_correction``), so
    there is no data-dependent Python branch and ``dl`` can serve as
    ``EighGenConfig.adjoint_method`` inside the custom VJP.

    Requires the single-vector Lanczos chain (alpha/beta of the three-term
    recurrence); the block solver does not provide one.

    Accuracy caveat (measured): the reverse sweep divides by the beta
    coefficients, so if the iteration ran well PAST convergence (tiny
    trailing betas, eig_res ~ 1e-20) the sweep amplifies rounding and the
    gradient degrades to ~1e-5 relative; at an m where the wanted modes
    just converge it matches finite differences of the computed function
    to ~1e-10. Exact breakdown (beta == 0, frozen chain) contributes zero
    through a guarded division rather than NaN.

    Returns (psi, EigCorrection).
    """
    B = as_operator(B)
    m = res.m
    N = Phib.shape[1]
    n = Phib.shape[0]
    dtype = Phib.dtype

    V = res.V[:m].T  # (n, m) columns
    T = _tridiagonal(res.alpha, res.beta)
    Ys = res.Ys  # (m, m) sorted
    theta_s = res.theta_s
    lam = res.lam[:N]
    Phi = res.Phi
    sigma = res.sigma

    BPhi = B.mv(Phi)
    G = -pdot(Phi.T, Phib, None)
    Rmod = Phib + BPhi @ G

    Ysel = Ys[:, :N]  # (m, N)
    Vb = Rmod @ Ysel.T  # (n, m)
    Yb = V.T @ Rmod  # (m, N)

    # Divided differences in sorted coordinates (reference D loop, :622-631):
    # skip the diagonal and repeated selected pairs.
    rows = jnp.arange(m)[:, None]
    cols = jnp.arange(N)[None, :]
    denom = theta_s[None, :N] - theta_s[:, None]
    lam_pad = res.lam_all[res.order]  # (m,) sorted mapped eigenvalues
    close_sel = (jnp.abs(lam_pad[:, None] - lam[None, :]) < eig_atol) & \
        (rows < N)
    mask = (rows != cols) & ~close_sel & (denom != 0.0)
    C = Ys.T @ Yb  # (m, N)
    Ds = jnp.where(mask, C / jnp.where(mask, denom, 1.0), 0.0)
    Tb = Ys @ (Ds @ Ysel.T)  # (m, m)

    # --- reverse sweep ---------------------------------------------------
    colm = jnp.arange(m)

    t_last = B.mv(factor.mv(B.mv(V[:, m - 1])))
    Vb = Vb + jnp.outer(t_last, Tb[:, m - 1])
    sb = B.mv(V @ Tb[:, m - 1])
    u = factor.mv(sb)
    Vb = Vb.at[:, m - 1].add(B.mv(u))

    U = jnp.zeros((n, m), dtype=dtype)

    def body(k, carry):
        Vb, U, u = carry
        i = m - 2 - k
        # t = B @ V @ T[:, i] — T is tridiagonal so this equals the
        # reference's three-column combination (:650-652).
        t = B.mv(V @ T[:, i])
        vb_ip1 = Vb[:, i + 1]
        c0 = V[:, i + 1] @ vb_ip1 - T[i + 1, i] * Tb[i + 1, i]
        # guarded division: an exact-breakdown step (beta frozen to 0 by the
        # forward guard) carried no information, so its adjoint is zero
        bok = jnp.abs(T[i + 1, i]) > 1e-30
        sb = (vb_ip1 - c0 * B.mv(V[:, i + 1])) * jnp.where(
            bok, 1.0 / jnp.where(bok, T[i + 1, i], 1.0), 0.0)

        # Vb[:, j] -= T[j, i] * sb for j <= i  (rows i-1 and i of column i of T)
        mask_le = (colm <= i).astype(dtype)
        Vb = Vb - jnp.outer(sb, T[:, i] * mask_le)

        hb = (V.T @ sb - Tb[:, i]) * mask_le
        Vb = Vb - jnp.outer(t, hb)
        sb = sb - B.mv(V @ hb)

        U = U.at[:, i + 1].set(u)
        u = factor.mv(sb)
        Vb = Vb.at[:, i].add(B.mv(u))
        return Vb, U, u

    Vb, U, u = jax.lax.fori_loop(0, m - 1, body, (Vb, U, u))
    U = U.at[:, 0].set(u)

    if mode == "normal":
        psi = -U @ (Ysel / (lam - sigma)[None, :])
    elif mode == "buckling":
        psi = -U @ (sigma * Ysel / (lam - sigma)[None, :])
    else:
        raise ValueError(f"Unknown mode {mode!r}")

    psi = psi - Phi @ (BPhi.T @ psi)
    psi, data = generate_adjoint_correction(lam, Phi, psi, G=G,
                                            eig_atol=eig_atol, mode=mode)
    return psi, data
