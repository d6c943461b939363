"""Time the 9-point block stencil matvec on the GPU: plain XLA
(``stencil.stencil_matvec_xla``) against the Pallas Triton kernel
(``stencil_kernel.stencil_matvec_pallas``) over a small block/num_warps
sweep, at the 1.05M-DOF (k=8) and 263k-DOF (k=16) grids, f64 and f32.
Each time is the mean of back-to-back warm calls ending in
``block_until_ready``; the share is against the published HBM bound.

    python scripts/bench_stencil.py
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from eigd_tpu.ops.stencil import stencil_matvec_xla  # noqa: E402
from eigd_tpu.ops.stencil_kernel import stencil_matvec_pallas  # noqa: E402

CASES = [((1024, 512), 8, "float64"), ((1024, 512), 8, "float32"),
         ((512, 256), 16, "float32"), ((512, 256), 16, "float64")]
SWEEP = [(b, w) for b in (64, 128, 256) for w in (2, 4, 8)]


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = jax.devices()[0]
    print(f"{dev.platform} {dev.device_kind}", flush=True)
    ndof = 2
    for (nx, ny), k, dtype in CASES:
        kW, kx = jax.random.split(jax.random.PRNGKey(0))
        W = jax.random.normal(kW, (nx + 1, ny + 1, 3, 3, ndof, ndof), dtype)
        x = jax.random.normal(kx, ((nx + 1) * (ny + 1) * ndof, k), dtype)
        nodes = (nx + 1) * (ny + 1)
        nbytes = nodes * (9 * ndof * ndof + 2 * ndof * k) * W.dtype.itemsize
        plain = jax.jit(stencil_matvec_xla, static_argnums=(2, 3, 4))
        ref = plain(W, x, nx, ny, ndof)
        t = chip_smoke.device_seconds(plain, W, x, nx, ny, ndof)
        tag = f"{nx}x{ny} k={k} {dtype}"
        print(f"{tag} xla: {t * 1e6:.1f} us, "
              + chip_smoke.bound_share(nbytes, t, dev.device_kind),
              flush=True)
        best = None
        for block, warps in SWEEP:
            f = jax.jit(lambda W, x, b=block, w=warps: stencil_matvec_pallas(
                W, x, nx, ny, ndof, block=b, num_warps=w))
            err = float(jnp.abs(f(W, x) - ref).max()
                        / jnp.abs(ref).max())
            t = chip_smoke.device_seconds(f, W, x)
            print(f"{tag} pallas block={block} warps={warps}: "
                  f"{t * 1e6:.1f} us, err {err:.1e}, "
                  + chip_smoke.bound_share(nbytes, t, dev.device_kind),
                  flush=True)
            best = min(best or (t, block, warps), (t, block, warps))
        print(f"{tag} best pallas: block={best[1]} warps={best[2]} "
              f"{best[0] * 1e6:.1f} us", flush=True)


if __name__ == "__main__":
    main()
