"""Compensated float32 reductions (error-free transforms).

The reference runs float64 BLAS throughout
(/root/reference/src/BlasWrapper.hpp:21-40).  A float32 solve (half the
bytes of every m-sized pass) has its accuracy floor set by rounding
noise in the long m-length reductions: the Gram blocks V'AV (solver
``gram_update``), the Lanczos 3-term recurrence scalars, and the
orthogonalization inner products.  A plain f32 contraction of length m
carries ~sqrt(m)*eps relative rounding noise (~6e-5 at m=1e6).  On the
GPU float64 is native (at half the f32 rate), so this module serves the
float32 path of ``precision="compensated"`` and ``rails_tpu.refine``.

This module restores (near-)float64-quality results from f32 storage
using classic error-free transforms (Ogita, Rump & Oishi, "Accurate sum
and dot product", SIAM J. Sci. Comput. 26(6), 2005):

- ``two_sum(a, b)``      -> (s, e) with s = fl(a+b) and a+b = s+e exactly.
- ``two_prod(a, b)``     -> (p, e) with a*b = p+e exactly (Dekker split;
  no FMA primitive is exposed by XLA, so the split form is used).
- ``dot2(x, y)``         -> compensated dot along axis 0: full working-
  precision accuracy (error ~ eps + cond * eps^2) at ~4x the elementwise
  flops of a plain dot - still memory-bound for the skinny operands it
  is meant for.
- ``gram2(x, w, chunk)`` -> x' @ w via chunked GEMM partial products with
  a compensated cross-chunk pairwise reduction.  Each chunk accumulates
  in plain f32 inside the GEMM (cannot be compensated), so the error
  drops from ~sqrt(m)*eps to ~sqrt(chunk)*eps - a sqrt(m/chunk)
  improvement (~30x at m=1e6, chunk=1024) while every FLOP stays in a
  GEMM.  The chunk GEMMs run at "highest" precision: a TF32 product
  would undo the compensation.

``dot2`` is exact-compensated but elementwise: use it when the output is
small (vector-vector, or a handful of column pairs).  ``gram2`` rides
GEMMs: use it for the (m,a)'(m,b) Gram blocks.

Under GSPMD row sharding both compose with psum: the per-device partial
(hi, lo) pairs are psum'd separately and re-joined with two_sum, which
keeps the cross-device reduction compensated as well (psum of <=
mesh-size terms adds only ~log(n_dev) ulps).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["two_sum", "two_prod", "dot2", "gram2", "gram2_pair", "sum2"]


def two_sum(a, b):
    """Error-free sum: returns (s, e) with s = fl(a+b), a+b = s+e exactly."""
    s = a + b
    bv = s - a
    e = (a - (s - bv)) + (b - bv)
    return s, e


def _split(a):
    """Dekker split: a = hi + lo with hi, lo each representable in half
    the mantissa, so hi*hi etc. are exact.  f32: 24-bit mantissa ->
    factor 2^12 + 1; f64: 2^27 + 1."""
    if a.dtype == jnp.float64:
        factor = jnp.float64(2.0 ** 27 + 1.0)
    else:
        factor = jnp.float32(2.0 ** 12 + 1.0)
    c = factor * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free product: returns (p, e) with p = fl(a*b), a*b = p+e."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _pairwise_two_sum(parts):
    """Compensated pairwise-tree sum over axis 0 of ``parts``.

    Returns (hi, lo): hi = best f-precision estimate of sum(parts, 0),
    lo = compensation term.  Each tree level uses two_sum and plain-adds
    the error terms (errors of errors are O(eps^2) relative - ignorable).
    Tree depth is static, so everything is traced/unrolled: log2(n)
    levels of full-lane VPU adds.
    """
    lo = jnp.zeros_like(parts[0])
    while parts.shape[0] > 1:
        n = parts.shape[0]
        half = n // 2
        a, b = parts[:half], parts[half:2 * half]
        s, e = two_sum(a, b)
        err = jnp.sum(e, axis=0)
        if n % 2:
            parts = jnp.concatenate([s, parts[2 * half:]], axis=0)
        else:
            parts = s
        lo = lo + err
    return parts[0], lo


def sum2(x, axis=0):
    """Compensated sum along ``axis`` (pairwise two_sum tree).

    Returns the compensated estimate hi + lo collapsed to x.dtype.
    """
    x = jnp.moveaxis(x, axis, 0)
    hi, lo = _pairwise_two_sum(x)
    return hi + lo


@functools.partial(jax.jit, static_argnames=("block",))
def dot2(x, y, block: int = 65536):
    """Compensated x' @ y along axis 0 at full working-precision accuracy.

    x: (m,) or (m, a); y: (m,) or (m, b).  Output (), (a,), (b,) or
    (a, b) matching a plain ``x.T @ y``.  Cost: ~10 VPU flops per
    product term - use for skinny operands (a*b small), where the op
    is HBM-bound and the extra flops are free.

    Algorithm: elementwise two_prod, then a compensated pairwise-tree
    reduction of the products with the exact product errors folded into
    the compensation stream (OgRuOi05 Dot2, pairwise variant).
    """
    xv = x[:, None] if x.ndim == 1 else x
    yv = y[:, None] if y.ndim == 1 else y
    m, a = xv.shape
    b = yv.shape[1]
    # (m, a, b) product stream, reduced blockwise to bound memory.
    nblk = max(1, -(-m // block))
    hi = jnp.zeros((a, b), xv.dtype)
    lo = jnp.zeros((a, b), xv.dtype)
    for i in range(nblk):
        xs = xv[i * block:(i + 1) * block]
        ys = yv[i * block:(i + 1) * block]
        p, e = two_prod(xs[:, :, None], ys[:, None, :])
        ph, pl = _pairwise_two_sum(p)
        s, e2 = two_sum(hi, ph)
        hi = s
        lo = lo + e2 + pl + jnp.sum(e, axis=0)
    out = hi + lo
    if x.ndim == 1 and y.ndim == 1:
        return out[0, 0]
    if x.ndim == 1:
        return out[0]
    if y.ndim == 1:
        return out[:, 0]
    return out


@functools.partial(jax.jit, static_argnames=("chunk",))
def gram2_pair(x, w, chunk: int = 1024):
    """Like gram2 but returns the (hi, lo) pair uncollapsed, so a host
    consumer can reconstruct the float64-quality result exactly
    (hi.astype(f64) + lo.astype(f64)).  Used by the refined driver's
    host-side f64 residual compression (rails_tpu/refine.py)."""
    m = x.shape[0]
    pad = (-m) % chunk
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
        w = jnp.pad(w, ((0, pad), (0, 0)))
    nc = x.shape[0] // chunk
    xc = x.reshape(nc, chunk, x.shape[1])
    wc = w.reshape(nc, chunk, w.shape[1])
    parts = jnp.einsum("cma,cmb->cab", xc, wc,
                       precision=jax.lax.Precision.HIGHEST)
    return _pairwise_two_sum(parts)


@functools.partial(jax.jit, static_argnames=("chunk",))
def gram2(x, w, chunk: int = 1024):
    """x' @ w via chunked matmuls + compensated cross-chunk reduction.

    x: (m, a), w: (m, b) -> (a, b).  Each chunk partial runs as a GEMM
    at HIGHEST precision (f32 accumulate); the cross-chunk pairwise
    two_sum tree removes the long-reduction error growth, leaving only
    the per-chunk ~sqrt(chunk)*eps noise.  Memory overhead is the
    (nchunks, a, b) partial buffer; callers keep a*b modest (the
    projected blocks are <= Kb^2 ~ 1e6 entries).
    """
    m = x.shape[0]
    pad = (-m) % chunk
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
        w = jnp.pad(w, ((0, pad), (0, 0)))
    nc = x.shape[0] // chunk
    xc = x.reshape(nc, chunk, x.shape[1])
    wc = w.reshape(nc, chunk, w.shape[1])
    parts = jnp.einsum("cma,cmb->cab", xc, wc,
                       precision=jax.lax.Precision.HIGHEST)
    hi, lo = _pairwise_two_sum(parts)
    return hi + lo
