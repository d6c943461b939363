"""Global configuration for eigd_tpu.

The derivative-parity target (<= 1e-8 relative error against finite-difference
checks, BASELINE.md) requires float64 end to end, so importing eigd_tpu enables
JAX x64 mode.
"""

import hashlib
import os
import platform

import jax

jax.config.update("jax_enable_x64", True)
# f32 matmuls run at full f32 precision, never TF32 on the GPU's tensor
# cores (~1e-3 relative): TF32 silently destroys the SPD Schur complements of
# the f32 factorization path and the f32 V-cycle. f64 is unaffected.
jax.config.update("jax_default_matmul_precision", "highest")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_flags_tag():
    """Short hash of the host CPU's ISA flags.

    XLA:CPU caches AOT machine code, and an entry compiled on a host with
    other ISA features loads with a "could lead to execution errors such as
    SIGILL" warning and runs with wrong numerics. Keying CPU-pinned caches by
    the flags keeps each host's entries apart.
    """
    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return tag + "-" + hashlib.sha1(
                        line.encode()).hexdigest()[:8]
    except OSError:  # pragma: no cover - non-Linux
        pass
    return tag


def compile_cache_dir():
    """Directory of the persistent compilation cache.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself).
    Otherwise ``<repo>/.jax_cache``, with a per-CPU-flags subdirectory for a
    process pinned to the CPU backend.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    base = os.path.join(REPO_ROOT, ".jax_cache")
    if (os.environ.get("JAX_PLATFORMS") or "").strip().lower() == "cpu":
        return os.path.join(base, "cpu-" + _cpu_flags_tag())
    return base


# Persistent compilation cache: first compiles of the jitted solver cores are
# expensive, so cache them across processes. Disable with
# EIGD_NO_COMPILE_CACHE=1.
if not os.environ.get("EIGD_NO_COMPILE_CACHE"):
    _cache_dir = compile_cache_dir()
    try:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(_cache_dir, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", _cache_dir)
        # Threshold 0: the test suite's compile cost is hundreds of small
        # XLA:CPU compiles (~50 ms each); a 0.5 s floor caches none of them.
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    except OSError:  # pragma: no cover - read-only checkout: no cache
        pass
