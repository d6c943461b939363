"""chip_smoke.py on the CPU: the script refuses to run (no GPU, no result
line), and its phase functions pass at tiny sizes against the same
references the card run uses."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_require_gpu_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.require_gpu()


def test_dense_check():
    assert chip_smoke.dense_check() < 1e-7


@pytest.mark.parametrize("dtype,bar", [("float64", 1e-13),
                                       ("float32", 1e-5)])
def test_stencil_check(dtype, bar):
    err, _, nbytes = chip_smoke.stencil_check(16, 8, dtype=dtype,
                                              time_it=False)
    assert err < bar
    itemsize = 8 if dtype == "float64" else 4
    assert nbytes == 17 * 9 * (36 + 32) * itemsize


def test_gemm_checks():
    rel, _, _ = chip_smoke.gemm_check(24, 3000, 16, time_it=False)
    assert rel < 1e-12
    assert chip_smoke.f32_gemm_check(256, 16) < 1e-5


def test_natural_frequency_phase_16x8():
    """The main-path phase at 16x8 with the 263k settings: eigenvalues
    against SciPy eigsh, the jvp oracle and Richardson-4 differences."""
    out = chip_smoke.natural_frequency_phase(16, 8, fd_bar=1e-4)
    assert out["jvp_rel"] < 1e-5
    assert np.isfinite(out["fd_rel"])
