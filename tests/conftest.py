"""Test configuration: CPU backend with 8 virtual devices + float64.

Mirrors the reference's testing posture (fp64 LAPACK tolerances, serial
runs) while going beyond it: the reference never tests multi-process
(/root/reference/.github/workflows/ci.yml runs single-process only); we
simulate an 8-device mesh on CPU so the sharded code paths are exercised
in every test run.  Tests that need a GPU carry the ``gpu`` marker and
skip here; run them on the card with
``RAILS_TEST_PLATFORM=gpu python -m pytest -m gpu tests/``.
"""

import os

# RAILS_TEST_PLATFORM=gpu leaves JAX on its default (GPU) backend for the
# ``gpu``-marked tests; otherwise every test runs on the simulated CPU
# mesh.  XLA flags must be in the environment before the CPU client
# initializes.
ON_CPU = os.environ.get("RAILS_TEST_PLATFORM", "cpu") == "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if ON_CPU and "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if ON_CPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    if ON_CPU:
        assert jax.default_backend() == "cpu", "tests must run on CPU"
        assert len(jax.devices()) == 8, "tests expect 8 simulated devices"


@pytest.fixture
def rng():
    return np.random.default_rng(4634)  # the reference's MATLAB seed
