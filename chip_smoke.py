"""Smoke test of the eigensolve + adjoint gradient on one NVIDIA GPU.

    python chip_smoke.py          # every phase below, on one card
    python chip_smoke.py --four   # only the four-card sharded path

Phases, each a hard check (any failure exits non-zero and prints no result):

1. host: the card's name and power limit from nvidia-smi, then the
   card-marked tests (``pytest -m gpu``) in a child process, which is the
   only process on the card while it runs;
2. device: JAX must see a GPU (no fallback);
3. precision: the dense ``eigh_gen_dense`` gradient against a central
   difference (n=80);
4. ops at 1.05M DOF against NumPy f64 on the host: the stencil matvec in
   f64 and f32 (the Pallas kernel, and the plain-XLA form beside it), the
   native f64 basis product, and an f32 product under the
   default matmul precision (TF32 off), each with its time and its share of
   the published HBM bound;
5. main path: ``jax.jit(jax.value_and_grad(objective))`` of the 263k-DOF
   bench model (``bench.make_topo()``): compile and warm times, peak device
   memory, the eigenvalues against SciPy ``eigsh`` on the same K and M, the
   jvp-vs-vjp oracle and the Richardson-4 finite difference.

``--four`` runs the 1024x512 line-sharded objective on four cards and the
same objective on one card, and compares value and gradient.

The last line of stdout is one JSON object: ``{"ok": true, "device":
{"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published HBM bandwidth by device_kind (NVIDIA H100 SXM data sheet).
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


class SmokeFailure(Exception):
    pass


def say(*a):
    print(*a, flush=True)


def check(name, value, bar):
    """Hard check value <= bar; prints the reading either way."""
    ok = bool(np.isfinite(value) and value <= bar)
    say(f"  {name}: {value:.3e} (bar {bar:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name} = {value!r} > {bar!r}")
    return value


# ---------------------------------------------------------------------------
# Phase 1-2: host and device
# ---------------------------------------------------------------------------


def host_checks(run_tests=True):
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except FileNotFoundError as e:
        raise SmokeFailure(f"no nvidia-smi: {e}") from e
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    for line in out.stdout.strip().splitlines():
        say(line.strip())
    if run_tests:
        env = dict(os.environ, EIGD_TEST_DEVICE="gpu")
        t0 = time.perf_counter()
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
             "-p", "no:cacheprovider", os.path.join(ROOT, "tests")],
            env=env, cwd=ROOT, timeout=600).returncode
        say(f"phase host: pytest -m gpu rc={rc} "
            f"({time.perf_counter() - t0:.1f}s)")
        if rc != 0:
            raise SmokeFailure(f"pytest -m gpu exited {rc}")


def require_gpu(min_count=1):
    """The JAX device list; raises unless it is >= min_count GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < min_count:
        raise SmokeFailure(f"need {min_count} GPU(s), JAX has "
                           f"{len(devs)} x {devs[0].platform}")
    say(f"phase device: {devs[0].platform} {devs[0].device_kind} "
        f"x{len(devs)}, jax {jax.__version__}")
    return devs


# ---------------------------------------------------------------------------
# Phase 3: dense precision check
# ---------------------------------------------------------------------------


def dense_check(n=80, N=4, seed=42):
    """Relative error of the eigh_gen_dense gradient against a central
    difference along a random direction."""
    import jax
    import jax.numpy as jnp

    from eigd_tpu import eigh_gen_dense
    from eigd_tpu.ops.autodiff import EighGenConfig

    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.concatenate([np.arange(1.0, 9.0), np.linspace(50.0, 120.0,
                                                          n - 8)])
    A0 = jnp.asarray(Q @ np.diag(w) @ Q.T)
    B0 = jnp.eye(n)
    cfg = EighGenConfig(N=N, m=50, sigma=0.0, adjoint_method="sibk")

    def f(x):
        lam, Phi = eigh_gen_dense(A0 + jnp.diag(x), B0 + 0.01 * jnp.diag(x),
                                  cfg)
        return jnp.sum(jnp.sqrt(lam)) + jnp.sum(Phi[:5, :] ** 2)

    x0 = jnp.asarray(0.1 * rng.standard_normal(n))
    g = jax.grad(f)(x0)
    p = jnp.asarray(rng.uniform(size=n))
    h = 1e-5
    fd = (f(x0 + h * p) - f(x0 - h * p)) / (2 * h)
    return abs(float(p @ g) - float(fd)) / abs(float(fd))


# ---------------------------------------------------------------------------
# Phase 4: ops at real widths against NumPy f64
# ---------------------------------------------------------------------------


def stencil_ref(W, x, nx, ny, ndof):
    """NumPy f64 9-point block stencil y = A x (x is (n, k))."""
    k = x.shape[1]
    xp = np.pad(x.reshape(nx + 1, ny + 1, ndof, k),
                ((1, 1), (1, 1), (0, 0), (0, 0)))
    y = np.zeros((nx + 1, ny + 1, ndof, k))
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            xs = xp[1 + di: 2 + di + nx, 1 + dj: 2 + dj + ny]
            y += np.einsum("ijab,ijbk->ijak", W[:, :, 1 + di, 1 + dj], xs)
    return y.reshape(-1, k)


def device_seconds(f, *args, reps=20):
    """Mean seconds per call of a jitted f, warm, back to back."""
    import jax

    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def bound_share(nbytes, seconds, kind):
    bw = HBM_BYTES_PER_S.get(kind)
    if bw is None:
        return f"{nbytes / seconds / 1e9:.1f} GB/s (no published bound " \
               f"for {kind!r})"
    return (f"{nbytes / seconds / 1e9:.1f} GB/s, {nbytes / bw / seconds:.1%}"
            f" of the {bw / 1e12:.2f} TB/s bound")


def stencil_check(nx, ny, ndof=2, k=8, dtype="float64", seed=0, time_it=True,
                  plain=False):
    """Max error of ``stencil_matvec`` (the Pallas kernel on the GPU;
    ``plain=True``: the XLA form) in ``dtype`` against the NumPy f64
    reference, over the scale 18 max|W| max|x|. Returns (err/scale,
    seconds per call or None, bytes moved per call)."""
    import jax
    import jax.numpy as jnp

    from eigd_tpu.ops.stencil import stencil_matvec, stencil_matvec_xla

    kW, kx = jax.random.split(jax.random.PRNGKey(seed))
    W = jax.random.normal(kW, (nx + 1, ny + 1, 3, 3, ndof, ndof),
                          jnp.float64)
    x = jax.random.normal(kx, ((nx + 1) * (ny + 1) * ndof, k), jnp.float64)
    Wd, xd = W.astype(dtype), x.astype(dtype)
    f = jax.jit(stencil_matvec_xla if plain else stencil_matvec,
                static_argnums=(2, 3, 4))
    y = np.asarray(f(Wd, xd, nx, ny, ndof), np.float64)
    Wh, xh = np.asarray(Wd, np.float64), np.asarray(xd, np.float64)
    ref = stencil_ref(Wh, xh, nx, ny, ndof)
    scale = 18.0 * np.abs(Wh).max() * np.abs(xh).max()
    err = np.abs(y - ref).max() / scale
    nodes = (nx + 1) * (ny + 1)
    nbytes = nodes * (9 * ndof * ndof + 2 * ndof * k) * Wd.dtype.itemsize
    secs = device_seconds(f, Wd, xd, nx, ny, ndof) if time_it else None
    return err, secs, nbytes


def gemm_check(m, n, k, seed=1, time_it=True):
    """Relative (Frobenius) error of the native f64 basis product
    ``pdot`` (m, n) @ (n, k) against NumPy f64. Returns (rel, seconds,
    bytes)."""
    import jax
    import jax.numpy as jnp

    from eigd_tpu.ops.collective import pdot

    kX, kw = jax.random.split(jax.random.PRNGKey(seed))
    X = jax.random.normal(kX, (m, n), jnp.float64)
    w = jax.random.normal(kw, (n, k), jnp.float64)
    f = jax.jit(lambda X, w: pdot(X, w, None))
    got = np.asarray(f(X, w))
    ref = np.asarray(X) @ np.asarray(w)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    nbytes = (m * n + n * k + m * k) * 8
    secs = device_seconds(f, X, w) if time_it else None
    return rel, secs, nbytes


def f32_gemm_check(n, k, seed=2):
    """Relative error of an f32 (n, n) @ (n, k) product under the default
    matmul precision against the f64 product of the same f32 inputs: ~1e-7
    in full f32, ~1e-3 if the product ran in TF32."""
    import jax
    import jax.numpy as jnp

    kA, kb = jax.random.split(jax.random.PRNGKey(seed))
    A = jax.random.normal(kA, (n, n), jnp.float32)
    b = jax.random.normal(kb, (n, k), jnp.float32)
    got = np.asarray(jax.jit(jnp.matmul)(A, b), np.float64)
    ref = np.asarray(A, np.float64) @ np.asarray(b, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def ops_phase(kind, nx=1024, ny=512):
    say(f"phase ops: {nx}x{ny} grid ({2 * (nx + 1) * (ny + 1)} DOF)")
    for dtype, bar in (("float64", 1e-13), ("float32", 1e-5)):
        for plain, name in ((False, "stencil_matvec"),
                            (True, "stencil_matvec_xla")):
            err, secs, nbytes = stencil_check(nx, ny, dtype=dtype,
                                              plain=plain)
            check(f"{name} {dtype} k=8 max err / (18 max|W| max|x|)",
                  err, bar)
            say(f"    {secs * 1e6:.1f} us per call, {nbytes / 1e6:.1f} MB: "
                + bound_share(nbytes, secs, kind))
    n = 2 * (nx + 1) * (ny + 1)
    rel, secs, nbytes = gemm_check(184, n, 16)
    check(f"f64 pdot (184 x {n}) @ ({n} x 16) rel err", rel, 1e-12)
    say(f"    {secs * 1e3:.3f} ms per call, {nbytes / 1e6:.1f} MB: "
        + bound_share(nbytes, secs, kind))
    # the coarse-grid solve's shape: dense (nc, nc) inverse times a block
    check("f32 (4290 x 4290) @ (4290 x 16), default precision, rel err vs "
          "f64", f32_gemm_check(4290, 16), 1e-5)


# ---------------------------------------------------------------------------
# Phase 5: the main path
# ---------------------------------------------------------------------------


def natural_frequency_phase(nx=None, ny=None, lam_bar=1e-8, jvp_bar=1e-5,
                            fd_bar=1e-4, fd_hs=(3e-2, 1.5e-2)):
    """value_and_grad of the bench objective through ``make_model``, with
    the eigenvalues checked against SciPy eigsh (same K, M, sigma) and the
    gradient against the jvp oracle and Richardson-4 differences."""
    import jax
    import jax.numpy as jnp

    import bench

    topo = bench.make_topo(nx, ny)
    nx, ny = topo.grid_shape
    say(f"phase main path: {nx}x{ny} ({topo.nvars} DOF), block "
        f"{topo.cfg.block}, m={topo.cfg.m}, polish {topo.cfg.polish}")
    x0 = jnp.asarray(topo.x)
    run = bench.value_and_grad_program(topo, staged=False)
    compile_s, times, v, g = bench.time_runs(run, x0)
    stats = jax.devices()[0].memory_stats() or {}
    say(f"  compile+first run {compile_s:.2f}s, warm {times} s, "
        f"peak {stats.get('peak_bytes_in_use', 0) / 1e9:.3f} GB, "
        f"value {float(v):.12e}")
    if not np.all(np.isfinite(np.asarray(g))):
        raise SmokeFailure("non-finite gradient")
    pert = jnp.asarray(np.random.default_rng(7).uniform(size=x0.shape))
    ans = float(pert @ g)
    jvp_rel, lam = bench.jvp_check(topo, x0, pert, ans)
    _, lam_ref = bench.cpu_baseline(topo, sigma=topo.sigma,
                                    adjoint_applies=0)
    lam_ref = lam_ref[3:3 + len(lam)]  # skip the rigid triple
    say(f"  lam {lam}")
    check("lam vs SciPy eigsh max rel", float(
        np.max(np.abs(lam - lam_ref) / np.abs(lam_ref))), lam_bar)
    check("jvp_rel", jvp_rel, jvp_bar)
    fd_rel, _ = bench.fd_check(run, x0, pert, ans, hs=fd_hs)
    check("fd_rel (Richardson-4)", fd_rel, fd_bar)
    return {"compile_s": compile_s, "warm_s": times, "jvp_rel": jvp_rel,
            "fd_rel": fd_rel}


# ---------------------------------------------------------------------------
# --four: the line-sharded flagship on four cards against one card
# ---------------------------------------------------------------------------

FLAGSHIP = dict(nx=1024, ny=512, N=6, m=176, factor="mg",
                adjoint_method="pcpg", adjoint_maxiter=60, lanczos_block=8,
                polish=1, sigma=-1.0)


def four_card_check(n_devices=4, value_bar=1e-6, grad_bar=1e-6, **kw):
    """value_and_grad of the line-sharded objective on ``n_devices`` cards
    and on one card; returns (value rel diff, max grad diff / max|g|).

    The two programs compile (and run once) in two threads at the same
    time, since compilation dominates the wall time; the warm runs that
    follow are sequential."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from eigd_tpu.parallel.sharded import make_sharded_objective

    kw = {**FLAGSHIP, **kw}
    nx, ny = kw.pop("nx"), kw.pop("ny")
    progs = {}
    for nd in (n_devices, 1):
        obj, fltr, mesh, part = make_sharded_objective(nd, nx, ny, **kw)
        progs[nd] = (jax.jit(jax.value_and_grad(obj)), mesh, part,
                     0.9 * jnp.ones(fltr.num_design_vars))

    def first_run(nd):
        run, mesh, _, x0 = progs[nd]
        t0 = time.perf_counter()
        with mesh:
            jax.block_until_ready(run(x0))
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(progs)) as ex:
        firsts = {nd: ex.submit(first_run, nd) for nd in progs}
        firsts = {nd: f.result() for nd, f in firsts.items()}
    out = {}
    for nd, (run, mesh, part, x0) in progs.items():
        with mesh:
            t0 = time.perf_counter()
            v, g = run(x0)
            g.block_until_ready()
            warm = time.perf_counter() - t0
        say(f"  {nd} device(s), {part.n} DOF: compile+first "
            f"{firsts[nd]:.2f}s (concurrent), warm {warm:.4f}s, "
            f"value {float(v):.12e}")
        out[nd] = (float(v), np.asarray(g))
    (v4, g4), (v1, g1) = out[n_devices], out[1]
    vrel = check(f"value {n_devices} vs 1 device rel", abs(v4 - v1) / abs(v1),
                 value_bar)
    grel = check(f"gradient {n_devices} vs 1 device, max diff / max|g|",
                 float(np.max(np.abs(g4 - g1)) / np.max(np.abs(g1))),
                 grad_bar)
    return vrel, grel


# ---------------------------------------------------------------------------


def main(argv):
    four = argv == ["--four"]
    if argv and not four:
        print(__doc__, file=sys.stderr)
        return 2
    try:
        import eigd_tpu  # noqa: F401
        import bench  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    try:
        host_checks(run_tests=not four)
        devs = require_gpu(4 if four else 1)
        kind = devs[0].device_kind
        if four:
            say("phase four cards: line-sharded 1024x512 flagship")
            four_card_check(4)
            count = 4
        else:
            say("phase precision: eigh_gen_dense n=80")
            check("dense gradient vs central difference rel", dense_check(),
                  1e-7)
            ops_phase(kind)
            natural_frequency_phase()
            count = len(devs)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
