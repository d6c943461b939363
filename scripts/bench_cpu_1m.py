"""1M-DOF CPU baseline measurement.

Runs the reference-shaped SciPy pipeline (SuperLU factor + ARPACK
shift-invert eigsh + the adjoint's 120+1 factor applications,
eigenvector_derivatives.py:11-23, arpack.py:438-442 of the reference) at the
flagship 1024x512 plane-stress configuration (1,051,650 DOF) on the host
CPU, twice, and prints one JSON line with both times and the min:

    JAX_PLATFORMS=cpu python scripts/bench_cpu_1m.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import bench  # noqa: E402

NX, NY = bench.STAGES["1m"]


def main():
    reps = int(os.environ.get("EIGD_CPU_1M_REPS", 2))
    topo = bench.make_topo(NX, NY)
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        base_time, lam = bench.cpu_baseline(topo)
        total = time.perf_counter() - t0
        times.append(base_time)
        print(f"rep {r}: solve={base_time:.1f}s total={total:.1f}s "
              f"lam[3:6]={lam[3:6]}", file=sys.stderr, flush=True)
    out = {"metric": "CPU baseline: SuperLU+ARPACK+120 applies, "
                     f"{NX}x{NY} ({2 * (NX + 1) * (NY + 1)} DOF)",
           "times_s": [round(t, 1) for t in times],
           "value": round(min(times), 1), "unit": "s"}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
