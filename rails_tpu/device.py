"""Platform decisions in one place.

Everything that depends on which device JAX runs on goes through this
module: whether XLA offers a LAPACK Schur decomposition, where the
persistent compile cache lives, and the published peak rates of the
device a benchmark divides its times by.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = [
    "backend",
    "on_cpu",
    "has_lapack_schur",
    "compile_cache_dir",
    "enable_compile_cache",
    "PEAKS",
    "device_peaks",
]

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def backend() -> str:
    """The default JAX backend's platform name ('cpu', 'gpu', ...)."""
    return jax.default_backend()


def on_cpu() -> bool:
    return backend() == "cpu"


def has_lapack_schur() -> bool:
    """True where ``jax.lax.linalg.schur`` lowers (XLA's CPU backend
    calls LAPACK zgees).  Elsewhere the projected solves and ``eigs``
    run the Hessenberg + shifted-QR iteration of linalg/schur_qr.py."""
    return on_cpu()


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``.

    The path is part of the cache key, so it is fixed: never derived
    from a temporary name, a process id or the time."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir``
    and return the directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


# Published peaks keyed by ``device_kind``.  H200 SXM: NVIDIA H200
# Tensor Core GPU data sheet (dense rates, 700 W).  float32 is the rate
# outside the tensor cores; a float32 matmul that is allowed TF32 runs on
# them at up to 495 TFLOP/s with ~10 mantissa bits.
PEAKS = {
    "NVIDIA H200": {"hbm_bytes_per_s": 4.8e12, "f32_flops": 67e12,
                    "f64_flops": 34e12,
                    "source": "NVIDIA H200 data sheet (SXM)"},
}

# The CPU has no published peak; a nominal stream rate keeps CPU
# rehearsals of the benchmark computable, and is allowed only on request.
_CPU_PEAKS = {"hbm_bytes_per_s": 50e9, "f32_flops": 1e12,
              "f64_flops": 0.5e12, "source": "nominal CPU rehearsal value"}


def device_peaks(device_kind: Optional[str] = None, *,
                 allow_cpu: bool = False) -> dict:
    """Peak rates of ``device_kind`` (default: the first JAX device).

    An unknown device is an error, never a default; ``cpu`` is accepted
    only with ``allow_cpu=True``."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    if device_kind in PEAKS:
        return dict(PEAKS[device_kind], device_kind=device_kind)
    if device_kind.lower() == "cpu":
        if allow_cpu:
            return dict(_CPU_PEAKS, device_kind=device_kind)
        raise ValueError("device_kind 'cpu' needs allow_cpu=True (--cpu)")
    raise ValueError(
        f"no published peaks for device_kind {device_kind!r}; add it to "
        f"rails_tpu.device.PEAKS with its source")
