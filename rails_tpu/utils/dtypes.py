"""Dtype policy helpers.

The reference (Sbte/RAILS) is float64 throughout (BLAS/LAPACK D-routines,
e.g. /root/reference/src/BlasWrapper.hpp:21-40).  On the GPU float64 is
native at half the float32 rate, and float32 moves half the bytes, so the
framework is dtype-generic:

- every public entry point takes a ``dtype`` (default: the JAX default real
  dtype, i.e. float64 when ``jax_enable_x64`` is set, float32 otherwise);
- accuracy-critical reductions accumulate with
  ``preferred_element_type=float32`` at minimum;
- tests run on CPU with x64 enabled to match the reference tolerances.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "default_real_dtype",
    "complex_dtype_for",
    "real_dtype_for",
    "finfo_eps",
    "highest_precision",
]


def highest_precision(fn):
    """Trace ``fn`` under full-precision matmuls.

    On the GPU a float32 matmul at default precision may run in TF32
    (~10 mantissa bits), which is fine for NN training but catastrophic
    for iterative linear algebra (a 2x2 Lyapunov solve loses 3 digits).
    The small k-by-k projected kernels are latency- not throughput-bound,
    so full precision is free; the large m-sized streaming ops choose
    their precision explicitly instead.
    """
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def default_real_dtype():
    """The default real floating dtype under the active x64 setting."""
    return jnp.asarray(0.0).dtype


def complex_dtype_for(dtype) -> jnp.dtype:
    """The complex dtype matching a real dtype's precision."""
    dtype = jnp.dtype(dtype)
    if dtype == jnp.float64:
        return jnp.dtype(jnp.complex128)
    return jnp.dtype(jnp.complex64)


def real_dtype_for(dtype) -> jnp.dtype:
    dtype = jnp.dtype(dtype)
    if dtype in (jnp.complex128, jnp.float64):
        return jnp.dtype(jnp.float64)
    return jnp.dtype(jnp.float32)


def finfo_eps(dtype) -> float:
    return float(jnp.finfo(jnp.dtype(dtype)).eps)
