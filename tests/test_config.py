"""Placement of the persistent compilation cache, checked in a fresh
interpreter per case (the cache is configured when eigd_tpu is imported)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_after_import(env):
    code = ("import eigd_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


@pytest.fixture
def base_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "EIGD_NO_COMPILE_CACHE")}
    env["PYTHONPATH"] = ROOT
    return env


def test_cache_dir_from_env(base_env, tmp_path):
    base_env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "xla")
    assert _cache_dir_after_import(base_env) == str(tmp_path / "xla")


def test_cache_dir_default_is_repo_local(base_env):
    base_env["JAX_PLATFORMS"] = "cpu"
    got = _cache_dir_after_import(base_env)
    base = os.path.join(ROOT, ".jax_cache")
    # CPU-pinned processes key a subdirectory by the host's CPU flags
    assert os.path.dirname(got) == base
    assert os.path.basename(got).startswith("cpu-")
