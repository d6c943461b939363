"""Benchmark: N smallest eigenpairs + full adjoint gradient of a plane-stress
topology problem, on the default JAX device.

Pipeline under one jitted program (or two, the staged forward/reverse split,
at >= 500k DOF): filter -> stencil assembly -> multigrid shift-invert factor
-> block shift-invert Lanczos (rigid modes deflated) + Ritz polish -> mixed
SIBK adjoint -> total derivative.

Baseline: the reference's pipeline shape on the host CPU — SciPy SuperLU
factorization + ARPACK shift-invert eigensolve + the same number of factor
applications the adjoint performs (SpLuOperator counting is the reference's
own cost proxy, eigenvector_derivatives.py:16-22).

Stages, each run in a child process one after another so that only one
process holds the device at a time; the parent never touches the device:

  263k  512x256 (263,682 DOF): wall time, FD check, CPU baseline, jvp oracle
  1m    1024x512 (1,051,650 DOF), staged: wall time, FD check, jvp oracle
  crm   scripts/bench_crm.py: the CRM wingbox line

    python bench.py               # every stage
    python bench.py --stage 263k  # one stage, in this process

The cumulative result JSON is re-printed on stdout after every stage; the
diagnostics go to stderr. A failed stage shows in the output and makes the
exit code non-zero.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_MODES = 6
STAGES = {"263k": (512, 256), "1m": (1024, 512)}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _env(name, default, cast=float):
    v = os.environ.get(name)
    return default if v is None else cast(v)


def make_topo(nx=None, ny=None):
    """The plane-stress natural-frequency model at the bench configuration.

    Defaults are the 512x256 cell; ``EIGD_BENCH_*`` variables override
    single knobs. Settings fork on size (``big``: >= 500k DOF) where the
    263k accuracy recipe does not transfer to 1M.
    """
    from eigd_tpu.models.natural_frequency import make_model

    nx = _env("EIGD_BENCH_NX", 512, int) if nx is None else nx
    ny = _env("EIGD_BENCH_NY", 256, int) if ny is None else ny
    big = 2 * (nx + 1) * (ny + 1) >= 500_000
    # forward Lanczos block size: Krylov vectors per factor apply; fatter
    # blocks amortize the latency-bound V-cycle apply over more directions
    block = _env("EIGD_BENCH_BLOCK", 8 if big else 16, int)
    # FIXED trip count at 263k (an adaptive exit's data-dependent block
    # count makes the objective jump ~1e-6 under FD perturbations): q=11
    # block-16 steps at 263k, up to 22 block-8 steps at 1M
    m = _env("EIGD_BENCH_M", block * (22 if big else 11), int)
    ltol = os.environ.get("EIGD_BENCH_LANCZOS_TOL",
                          "1e-11" if big else "none")
    factor = os.environ.get("EIGD_BENCH_FACTOR", "mg")
    # sigma=-1: any sigma<0 keeps K-sigma*M SPD; -1 sits close to the
    # spectrum (lam_1 ~ 0.95), so the shift-invert gap ratios are strong
    sigma = _env("EIGD_BENCH_SIGMA", -1.0)
    ladder = os.environ.get("EIGD_BENCH_LADDER", "approx")
    adj_maxiter = _env("EIGD_BENCH_ADJ_MAXITER",
                       120 if ladder == "precond" else 30, int)
    if factor == "mg":
        fo = {"rtol": _env("EIGD_BENCH_RTOL", 1e-11),
              "maxiter": _env("EIGD_BENCH_MG_MAXITER", 60, int),
              "approx_rtol": _env("EIGD_BENCH_APPROX_RTOL", 1e-5),
              "approx_maxiter": _env("EIGD_BENCH_APPROX_MAXITER", 18, int),
              # forward-sweep apply channel: f32 solves driven to the
              # machine floor (rtol 0) at 263k — the FD-check noise floor
              # of the objective tracks sweep apply quality — while the
              # adjoint ladder keeps the cheap approx_rtol solves
              "sweep_rtol": None if big else _env("EIGD_BENCH_SWEEP_RTOL",
                                                  0.0),
              "sweep_maxiter": None if big else _env(
                  "EIGD_BENCH_SWEEP_MAXITER", 24, int),
              "degree": _env("EIGD_BENCH_MG_DEGREE", 3, int),
              # V-cycle depth: stop coarsening at this size (dense coarse
              # solve)
              "min_coarse": _env("EIGD_BENCH_MG_MIN_COARSE", 4500, int),
              # stagnation exits off at 263k: data-dependent plateau exits
              # in the PCG applies are an FD-noise source
              "stag_bad": _env("EIGD_BENCH_STAG", 2 if big else 1000000,
                               int)}
    else:
        fo = {"tol": 1e-11}
    # Adjoint: sibk with the mixed f32 ladder by default; "pcpg" is the
    # block projected CG with ONE f32 V-cycle per iteration as the
    # preconditioner (see ops/adjoint.py pcpg docstring).
    adj_method = os.environ.get("EIGD_BENCH_ADJOINT", "sibk")
    mixed = bool(_env("EIGD_BENCH_MIXED", 1, int))
    if adj_method == "pcpg":
        adj_opts = {"maxiter": adj_maxiter, "mixed": mixed}
    else:
        adj_opts = {"maxiter": adj_maxiter,
                    "nrestart": _env("EIGD_BENCH_NRESTART", 8, int),
                    "mixed": mixed, "ladder": ladder}
    return make_model(nx=nx, ny=ny, Lx=2.0, Ly=1.0, N=N_MODES, rfact=2.0,
                      m=m, factor_kind=factor,
                      lanczos_tol=None if ltol == "none" else float(ltol),
                      lanczos_block=block,
                      lanczos_ortho=os.environ.get("EIGD_BENCH_ORTHO",
                                                   "local"),
                      lanczos_check_every=2,
                      # adjoint_rtol = rtol * 1e-2
                      rtol=_env("EIGD_BENCH_ADJ_RTOL",
                                1e-7 if big else 4e-8),
                      sigma=sigma, factor_options=fo,
                      # Ritz polish: shift-invert subspace-iteration steps
                      # on the selected Ritz block (one accurate factor
                      # apply each), carrying `spare` extra vectors
                      lanczos_polish=_env("EIGD_BENCH_POLISH",
                                          2 if big else 3, int),
                      lanczos_polish_spare=_env("EIGD_BENCH_POLISH_SPARE",
                                                0 if big else 8, int),
                      adjoint_method=adj_method, adjoint_options=adj_opts,
                      # "approx": f32 preconditioner-quality forward sweep +
                      # polish accurate applies (see block_lanczos_solve)
                      lanczos_sweep=os.environ.get("EIGD_BENCH_SWEEP",
                                                   "approx"))


def pre_and_tail(topo):
    """The objective's two differentiable ends around the eigensolve."""
    from eigd_tpu.fem import assembly as fem

    def pre(x):
        return fem.element_density(topo.fltr.apply(x), topo.conn)

    def tail(lam, Q):
        # eta-weighted eigenvector aggregate (the reference's aggregate
        # design, buckling.py:702-760): smooth in lam, so the objective is
        # continuous through mode crossings at the solved-set boundary and
        # invariant under degenerate-pair rotations — a bare sum(Q[:8]**2)
        # jumps O(1) when modes 6/7 swap under an FD perturbation.
        eta = jnp.exp(-2.0 * (lam - lam[0]))
        return jnp.sum(jnp.sqrt(lam)) + jnp.sum(eta[None, :] * Q[:8, :] ** 2)

    return pre, tail


def value_and_grad_program(topo, staged):
    """x -> (value, grad): one fused jit, or the staged two-program form."""
    pre, tail = pre_and_tail(topo)
    if staged:
        from eigd_tpu.ops.autodiff import staged_value_and_grad

        return staged_value_and_grad(pre, tail, topo.problem, topo.cfg)

    def objective(x):
        lam, Q, _, _ = topo._solve_fn(x)
        return tail(lam, Q)

    return jax.jit(jax.value_and_grad(objective))


def time_runs(run, x0, reps=3):
    """(compile+first-run seconds, [warm seconds], value, grad)."""
    t0 = time.perf_counter()
    v, g = run(x0)
    g.block_until_ready()
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        v, g = run(x0)
        g.block_until_ready()
        times.append(time.perf_counter() - t0)
    return compile_s, times, v, g


def fd_check(run, x0, pert, ans, hs=(3e-2, 1.5e-2)):
    """Central differences of the objective along ``pert`` at each h, and
    Richardson-4 extrapolation of each (h, h/2) pair. The headline fd_rel
    is the Richardson-4 estimate at the largest h pair; every quotient is
    returned in the detail dict."""
    fds, detail = {}, {"plain": {}, "rich4": {}}
    for h in hs:
        vp, _ = run(x0 + h * pert)
        vm, _ = run(x0 - h * pert)
        fds[h] = (float(vp) - float(vm)) / (2 * h)
        detail["plain"][f"{h:.1e}"] = abs(ans - fds[h]) / abs(fds[h])
        log(f"FD h={h:.1e}: adjoint={ans:.10e} fd={fds[h]:.10e} "
            f"rel={detail['plain'][f'{h:.1e}']:.3e}")
    rich = {h: (4.0 * fds[h / 2] - fds[h]) / 3.0 for h in hs if h / 2 in fds}
    for h, r4 in rich.items():
        detail["rich4"][f"{h:.1e}"] = abs(ans - r4) / abs(r4)
        log(f"FD richardson h={h:.1e}: fd4={r4:.10e} "
            f"rel={detail['rich4'][f'{h:.1e}']:.3e}")
    fd_rel = (detail["rich4"][f"{max(rich):.1e}"] if rich
              else min(detail["plain"].values()))
    return fd_rel, detail


def jvp_check(topo, x0, pert, ans):
    """jvp-vs-vjp directional consistency: forward mode shares the primal
    solve with the reverse-mode gradient, so |jvp - g.p|/|jvp| isolates
    solver/derivation error with no FD step size (the full-scale analog
    of the reference's complex-step channel,
    eigenvector_derivatives.py:1387-1414).

    Returns (jvp_rel, the eigenvalues of the shared forward solve)."""
    from eigd_tpu.ops.autodiff import staged_jvp

    pre, tail = pre_and_tail(topo)
    fn = staged_jvp(pre, tail, topo.problem, topo.cfg)
    res = fn.fwd_prog(x0)
    lam = np.asarray(res.lam)  # read before tan_prog donates res
    _, dv = fn.tan_prog(x0, pert, res)
    dv = float(dv)
    rel = abs(ans - dv) / abs(dv)
    log(f"JVP check: vjp={ans:.12e} jvp={dv:.12e} rel={rel:.3e}")
    return rel, lam


def cpu_baseline(topo, sigma=-1.0, adjoint_applies=120):
    """Reference-shaped SciPy pipeline on the model's assembled K, M:
    SuperLU + ARPACK shift-invert + the adjoint's factor applications.
    Returns (seconds, the N + 3 smallest eigenvalues incl. the rigid
    triple)."""
    from scipy.sparse import linalg as spla

    t0 = time.perf_counter()
    K, M = assembled_csc(topo)
    lu = spla.splu((K - sigma * M).tocsc())
    OPinv = spla.LinearOperator(K.shape, matvec=lu.solve)
    lam, _ = spla.eigsh(K, k=N_MODES + 3, M=M, sigma=sigma, which="LM",
                        OPinv=OPinv)
    rng = np.random.default_rng(0)
    for _ in range(adjoint_applies):
        lu.solve(rng.standard_normal(K.shape[0]))
    lu.solve(rng.standard_normal((K.shape[0], N_MODES + 3)))
    return time.perf_counter() - t0, np.sort(lam)


def assembled_csc(topo, x=None):
    """SciPy CSC K, M of the model at design x (default: topo.x)."""
    from scipy import sparse

    from eigd_tpu.fem import assembly as fem

    x = topo.x if x is None else x
    rhoE = fem.element_density(topo.fltr.apply(x), topo.conn)
    K_op, M_op = topo._assemble(rhoE)
    dofs = np.asarray(K_op.dofs)
    n = K_op.n
    d = dofs.shape[1]
    rows = np.repeat(dofs, d, axis=1).reshape(-1)
    cols = np.tile(dofs, (1, d)).reshape(-1)

    def csc(mats):
        return sparse.coo_matrix((np.asarray(mats).reshape(-1),
                                  (rows, cols)), shape=(n, n)).tocsc()

    return csc(K_op.mats), csc(M_op.mats)


def device_fields():
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def run_stage(name):
    """One natural-frequency stage in this process; returns its JSON dict."""
    nx, ny = STAGES[name]
    n_dof = 2 * (nx + 1) * (ny + 1)
    staged = n_dof >= 500_000
    dev = device_fields()
    log(f"stage {name}: {nx}x{ny} ({n_dof} DOF) on {dev}")
    topo = make_topo(nx, ny)
    x0 = jnp.asarray(topo.x)
    run = value_and_grad_program(topo, staged)
    compile_s, times, v, g = time_runs(run, x0)
    log(f"compile+first run: {compile_s:.1f}s value={float(v):.12e}")
    log(f"warm runs: {times}")
    if not np.all(np.isfinite(np.asarray(g))):
        raise FloatingPointError("non-finite gradient")
    result = {
        "metric": f"wall time: {N_MODES} eigenpairs + adjoint gradient, "
                  f"{nx}x{ny} plane-stress topology ({n_dof} DOF), "
                  + ("staged fwd/bwd jits" if staged else "monolithic jit"),
        "value": min(times), "unit": "s", "device": dev,
        "compile_s": compile_s, "warm_s": times,
        "peak_bytes": (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use")}
    if staged:
        t0 = time.perf_counter()
        jax.block_until_ready(run.fwd_prog(x0))
        result["fwd_s"] = time.perf_counter() - t0
    pert = jnp.asarray(np.random.default_rng(7).uniform(size=x0.shape))
    ans = float(pert @ g)
    result["fd_rel"], result["fd_detail"] = fd_check(run, x0, pert, ans)
    if name == "263k":
        reps = _env("EIGD_BENCH_BASELINE_REPS", 2, int)
        base = []
        for r in range(reps):
            bt, lam = cpu_baseline(topo)
            log(f"CPU baseline rep {r}: {bt:.1f}s lam[3:6]={lam[3:6]}")
            base.append(bt)
        result["cpu_baseline_s"] = min(base)
        result["vs_baseline"] = min(base) / result["value"]
    result["jvp_rel"], lam = jvp_check(topo, x0, pert, ans)
    result["lam"] = lam.tolist()
    return result


def _last_json_line(stdout):
    for line in reversed((stdout or "").strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    return None


def run_child(cmd, timeout):
    """Run one stage as a child process; its stderr streams through."""
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                             timeout=timeout, cwd=ROOT)
    except subprocess.TimeoutExpired:
        return {"error": f"timeout after {timeout:.0f}s"}
    data = _last_json_line(out.stdout)
    if out.returncode != 0 or data is None:
        return {"error": f"rc={out.returncode}", "partial": data}
    data["total_s"] = time.perf_counter() - t0
    return data


def main(argv):
    if len(argv) == 2 and argv[0] == "--stage":
        print(json.dumps(run_stage(argv[1])), flush=True)
        return 0
    if argv:
        log(__doc__)
        return 2
    budget = _env("EIGD_BENCH_BUDGET", 3000)
    t_start = time.perf_counter()
    result = {}
    for name, cmd in (
            ("263k", [sys.executable, __file__, "--stage", "263k"]),
            ("1m", [sys.executable, __file__, "--stage", "1m"]),
            ("crm", [sys.executable,
                     os.path.join(ROOT, "scripts", "bench_crm.py")])):
        left = budget - (time.perf_counter() - t_start)
        result[name] = run_child(cmd, max(left, 1.0))
        print(json.dumps(result), flush=True)
    failed = [k for k, v in result.items() if "error" in v]
    if failed:
        log(f"failed stages: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
