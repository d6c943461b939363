"""Test configuration.

By default every test runs on the host CPU backend with 8 virtual devices
(XLA host-platform device multiplexing), which is how the multi-device
sharding tests run without accelerators. ``EIGD_TEST_DEVICE=gpu`` leaves the
platform to JAX instead, for the card-marked tests (``pytest -m gpu``); a
fixture skips those wherever JAX has no GPU.
"""

import os

import pytest

if os.environ.get("EIGD_TEST_DEVICE") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip card-marked tests where JAX has no GPU (decided at run time,
    never at import or collection)."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: EIGD_TEST_DEVICE=gpu "
                    "pytest -m gpu tests/")
