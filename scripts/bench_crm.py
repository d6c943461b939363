"""CRM wingbox benchmark line: one warm forward (eigensolve) + adjoint pass
on the station-balanced scalable path, a CPU ARPACK+SuperLU baseline on the
SAME mesh (the reference CRM pipeline shape, /root/reference/examples/crm.py:
212-376 — TACS assembly bridged to SciPy, shift-invert eigsh, factor-apply
budget for the adjoint), and a central-difference check of the modal-
compliance gradient. Prints ONE JSON line on stdout; diagnostics to stderr.

Defaults target the ~100k-DOF configuration (nspan=256, nchord=16,
nheight=4, m=96 — the EIGD_RUN_SLOW test config,
tests/test_crm.py::test_compliance_fd_large). BCR cost scales as nb*b^3, so
chord/height resolution, not span, sets the block cost.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

import eigd_tpu  # noqa: E402,F401  (x64 mode and the compile cache)

NSPAN = int(os.environ.get("CRM_NSPAN", 256))
NCHORD = int(os.environ.get("CRM_NCHORD", 16))
NHEIGHT = int(os.environ.get("CRM_NHEIGHT", 4))
N = int(os.environ.get("CRM_N", 6))
M_KRYLOV = int(os.environ.get("CRM_M", 96))
POLISH = os.environ.get("CRM_POLISH")
POLISH = None if POLISH is None else int(POLISH)
POLISH_SPARE = int(os.environ.get("CRM_POLISH_SPARE", 0))
BLOCK = os.environ.get("CRM_BLOCK")
BLOCK = None if BLOCK is None else int(BLOCK)
_T0 = time.perf_counter()
BUDGET = float(os.environ.get("CRM_BUDGET", 1800))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _rem():
    return BUDGET - (time.perf_counter() - _T0)


def run_pass(crm):
    t0 = time.perf_counter()
    crm.initialize()
    t_fwd = time.perf_counter() - t0
    crm.initialize_adjoint()
    crm.add_modal_compliance_derivative(1.0)
    t0 = time.perf_counter()
    crm.finalize_adjoint()
    t_adj = time.perf_counter() - t0
    return t_fwd, t_adj


def cpu_baseline(crm):
    """Reference-shaped CPU pipeline on the same mesh: sparse assembly,
    SuperLU shift-invert ARPACK eigsh, plus the adjoint's factor-apply
    budget (SpLuOperator counting is the reference's own cost proxy)."""
    from scipy import sparse
    from scipy.sparse import linalg as spla

    Ke, Me = crm._element_mats(crm.x)
    Ke = np.asarray(Ke)
    Me = np.asarray(Me)
    dofs = np.asarray(crm.dofs)
    n = crm.nvars
    rows = np.repeat(dofs, 24, axis=1).reshape(-1)
    cols = np.tile(dofs, (1, 24)).reshape(-1)
    free = np.asarray(crm.free)

    t0 = time.perf_counter()
    K = sparse.coo_matrix((Ke.reshape(-1), (rows, cols)),
                          shape=(n, n)).tocsr()[free][:, free].tocsc()
    M = sparse.coo_matrix((Me.reshape(-1), (rows, cols)),
                          shape=(n, n)).tocsr()[free][:, free].tocsc()
    lu = spla.splu(K)
    OPinv = spla.LinearOperator(K.shape, matvec=lu.solve)
    lam, Q = spla.eigsh(K, k=N, M=M, sigma=0.0, which="LM", OPinv=OPinv)
    # adjoint-equivalent factor applications (mirrors bench.py cpu_baseline)
    rng = np.random.default_rng(0)
    for _ in range(120):
        lu.solve(rng.standard_normal(K.shape[0]))
    lu.solve(rng.standard_normal((K.shape[0], N)))
    return time.perf_counter() - t0, lam


def main():
    from eigd_tpu.models.crm import CRM

    crm = CRM(nspan=NSPAN, nchord=NCHORD, nheight=NHEIGHT, N=N,
              m=M_KRYLOV, lanczos_polish=POLISH,
              lanczos_polish_spare=POLISH_SPARE, lanczos_block=BLOCK)
    crm._ensure_cfg()
    dev = jax.devices()
    log(f"device: {dev[0].platform} {dev[0].device_kind} x{len(dev)}")
    log(f"CRM bench: {crm.nvars} padded DOF, {crm.nb} stations x b={crm.b}, "
        f"m={crm.m} block={crm.cfg.block} sweep={crm.cfg.lanczos_sweep}")

    t_fwd, t_adj = run_pass(crm)  # cold: compile (cached) + run
    log(f"cold pass: fwd {t_fwd:.1f}s adj {t_adj:.1f}s "
        f"lam[:3]={np.asarray(crm.lam[:3])}")
    t_fwd, t_adj = run_pass(crm)  # warm: the measured number
    wall = t_fwd + t_adj
    comp = float(crm.get_modal_compliance())
    log(f"warm pass: fwd {t_fwd:.1f}s adj {t_adj:.1f}s "
        f"compliance={comp:.8e}")

    result = {
        "metric": f"CRM wingbox: {N} eigenpairs + adjoint gradient, "
                  f"{crm.nvars} padded DOF ({crm.nb} stations x b={crm.b})",
        "value": wall, "unit": "s",
        "device": {"platform": dev[0].platform,
                   "kind": dev[0].device_kind, "count": len(dev)},
        "vs_baseline": None, "fd_rel": None}
    # Re-printed after every completed stage (same protocol as bench.py):
    # the caller takes the last parseable line.
    print(json.dumps(result), flush=True)

    pert = np.random.default_rng(7).uniform(size=crm.ncomp)
    ans = float(jnp.asarray(pert) @ crm.xb)

    base = float("nan")
    if not os.environ.get("CRM_NO_BASELINE") and _rem() > 120:
        # min of 2 reps (CPU draw-to-draw variance is ~±20%; min is the
        # conservative side of vs_baseline — same protocol as bench.py)
        reps = int(os.environ.get("CRM_BASELINE_REPS", 2))
        times = []
        for rr in range(reps):
            bt, lam_cpu = cpu_baseline(crm)
            log(f"CPU baseline rep {rr}: {bt:.1f}s lam={lam_cpu[:3]}")
            times.append(bt)
            if _rem() < 90:
                break
        base = min(times)
        if np.isfinite(base):
            result["vs_baseline"] = round(base / wall, 3)
            result["cpu_baseline_s"] = round(base, 2)
            print(json.dumps(result), flush=True)

    # jvp-vs-vjp oracle through the chunked tangent channel (VERDICT r4
    # item 4): shares the identical primal solve with the reverse-mode
    # gradient — no FD step size, no objective-smoothness requirement. The
    # round/guess programs cache-hit from the adjoint solve, so this costs
    # ~one adjoint solve.
    if not os.environ.get("CRM_NO_JVP") and _rem() > t_adj + 90:
        t0 = time.perf_counter()
        dv = crm.objective_jvp(pert)
        jvp_rel = abs(ans - dv) / abs(dv)
        result["jvp_rel"] = jvp_rel
        log(f"JVP check: vjp={ans:.12e} jvp={dv:.12e} rel={jvp_rel:.3e}"
            f" ({time.perf_counter() - t0:.1f}s)")
        print(json.dumps(result), flush=True)

    if not os.environ.get("CRM_NO_FD") and _rem() > 4 * t_fwd + 60:
        # Richardson-extrapolated central differences (same estimator set as
        # bench.py; fd_rel = the Richardson-4 at the largest h pair, every
        # quotient recorded)
        hs = tuple(float(h) for h in os.environ.get(
            "CRM_FD_H", "2e-5,1e-5").split(","))
        fds, detail = {}, {"plain": {}, "rich4": {}}

        def value_at(xp):
            c2 = CRM(nspan=NSPAN, nchord=NCHORD, nheight=NHEIGHT, N=N,
                     m=M_KRYLOV, lanczos_block=BLOCK)
            c2.x = jnp.asarray(xp)
            # reuse the compiled programs (same shapes/config)
            c2.cfg = crm.cfg
            c2._fwd_prog, c2._bwd_prog = crm._fwd_prog, crm._bwd_prog
            c2.initialize()
            return float(c2.get_modal_compliance())

        for h in hs:
            if _rem() < 2 * t_fwd + 30:
                break
            vp = value_at(crm.x + h * jnp.asarray(pert))
            vm = value_at(crm.x - h * jnp.asarray(pert))
            fd = (vp - vm) / (2 * h)
            fds[h] = fd
            rel = abs(ans - fd) / abs(fd)
            detail["plain"][f"{h:.1e}"] = rel
            log(f"FD h={h:.0e}: adjoint={ans:.10e} fd={fd:.10e} "
                f"rel={rel:.3e}")
        for h in hs:
            if h / 2 in fds and h in fds:
                r4 = (4.0 * fds[h / 2] - fds[h]) / 3.0
                rel = abs(ans - r4) / abs(r4)
                detail["rich4"][f"{h:.1e}"] = rel
                log(f"FD richardson h={h:.0e}: fd4={r4:.10e} rel={rel:.3e}")
        if detail["rich4"]:
            h_big = max(h for h in hs if h / 2 in fds and h in fds)
            result["fd_rel"] = detail["rich4"][f"{h_big:.1e}"]
        elif detail["plain"]:
            result["fd_rel"] = min(detail["plain"].values())
        result["fd_detail"] = detail
        print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
