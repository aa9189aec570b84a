"""Platform decisions (rails_tpu/device.py): compile-cache location, the
peaks table, and the gate of the serial-QR projected-solve warning."""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rails_tpu
from rails_tpu import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCompileCache:
    def test_env_var_wins(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert device.compile_cache_dir() == str(tmp_path)

    def test_default_is_fixed_repo_path(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = device.compile_cache_dir()
        assert path == os.path.join(REPO, ".jax_cache")
        assert device.compile_cache_dir() == path   # stable across calls

    def test_enable_sets_jax_config(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        old = jax.config.jax_compilation_cache_dir
        try:
            assert device.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        finally:
            jax.config.update("jax_compilation_cache_dir", old)


class TestPeaks:
    def test_h200_from_data_sheet(self):
        p = device.device_peaks("NVIDIA H200")
        assert p["hbm_bytes_per_s"] == 4.8e12
        assert p["f32_flops"] == 67e12
        assert "data sheet" in p["source"]

    def test_unknown_device_is_an_error(self):
        with pytest.raises(ValueError, match="no published peaks"):
            device.device_peaks("Some Accelerator 9000")

    def test_cpu_only_on_request(self):
        with pytest.raises(ValueError, match="allow_cpu"):
            device.device_peaks("cpu")
        assert device.device_peaks("cpu", allow_cpu=True)[
            "hbm_bytes_per_s"] > 0

    def test_default_reads_first_device(self):
        # the tests run on the CPU backend
        assert device.device_peaks(allow_cpu=True)["device_kind"] == "cpu"


class TestScheduleGates:
    def test_cpu_has_lapack_schur(self):
        assert device.backend() == "cpu"
        assert device.on_cpu() and device.has_lapack_schur()

    @staticmethod
    def _untagged_solve():
        rng = np.random.default_rng(0)
        n = 200
        a = rng.uniform(-1, 1, (n, n)) * 0.05 - 3.0 * np.eye(n)
        b = jnp.asarray(rng.uniform(0, 1, (n, 2)))
        return rails_tpu.solve(rails_tpu.DenseOperator(jnp.asarray(a)), b,
                               tol=1e-8, maxit=2, expand=2,
                               restart_size=160)

    def test_serial_qr_warning_fires_without_lapack(self, monkeypatch):
        monkeypatch.setattr(device, "has_lapack_schur", lambda: False)
        with pytest.warns(rails_tpu.ProjectedSolverPerformanceWarning):
            self._untagged_solve()

    def test_serial_qr_warning_silent_with_lapack(self):
        with warnings.catch_warnings():
            warnings.simplefilter(
                "error", rails_tpu.ProjectedSolverPerformanceWarning)
            self._untagged_solve()
