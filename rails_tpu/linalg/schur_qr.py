"""Complex Schur decomposition as a pure-JAX, jittable kernel.

XLA has a Schur primitive on the CPU only (LAPACK's ``dhseqr``/``dgees``;
rails_tpu.device.has_lapack_schur), but the RAILS projected solve
needs exactly sb03md's capability: factor a general real k-by-k matrix
A = U T U^H with T upper triangular (/root/reference/src/SlicotWrapper.cpp:
8-49 does this internally via LAPACK).  We build it from scratch:

1. ``hessenberg``: Householder reduction A = Q H Q^H, as k-2 masked rank-1
   update steps (each O(k^2), total O(k^3), all dense vector/matmul ops).
2. ``complex_schur``: single-shift QR iteration with Wilkinson shifts and
   aggressive deflation.  Each sweep is one *full-size* complex QR
   factorization (an XLA-native batched Householder kernel) - a deliberate
   choice for accelerators: instead of the scalar Givens bulge-chase
   LAPACK uses (deeply sequential), we pay O(k^3) of dense work per sweep
   and converge in O(k) sweeps.  Deflated trailing blocks stay upper
   triangular under full-matrix QR steps (block-triangular structure is
   preserved), so masking the active window is unnecessary; only the
   *shift* tracks the active window.

The projected matrices in RAILS are small (k <= a few hundred), so the
O(k^4) total is small next to the m-sized work, and this kernel is called
once per solver iteration.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from rails_tpu.utils.dtypes import highest_precision

__all__ = ["hessenberg", "complex_schur"]


def _csign(z):
    """z/|z| with sign(0) = 1 (complex-safe Householder phase)."""
    az = jnp.abs(z)
    return jnp.where(az == 0, jnp.ones_like(z), z / jnp.where(az == 0, 1.0, az))


@jax.jit
@highest_precision
def hessenberg(a: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Reduce a (real or complex) square matrix to upper Hessenberg form.

    Returns (h, q) with a = q @ h @ q^H and h[i, j] == 0 for i > j + 1.
    """
    k = a.shape[0]
    h0 = jnp.asarray(a)
    q0 = jnp.eye(k, dtype=h0.dtype)
    if k <= 2:
        return h0, q0

    rows = jax.lax.broadcasted_iota(jnp.int32, (k,), 0)

    def step(j, hq):
        h, q = hq
        # Householder vector zeroing h[j+2:, j], pivot row j+1.
        mask = rows >= j + 1
        x = jnp.where(mask, h[:, j], 0.0)
        pivot = jnp.sum(jnp.where(rows == j + 1, x, 0.0))
        nrm = jnp.linalg.norm(x)
        alpha = -_csign(pivot) * nrm
        e1 = (rows == j + 1).astype(h.dtype)
        v = x - alpha * e1
        vnrm = jnp.linalg.norm(v)
        # skip degenerate column (already reduced): v = 0 -> P = I
        v = jnp.where(vnrm > 0, v / jnp.where(vnrm > 0, vnrm, 1.0), 0.0)
        vc = jnp.conj(v)
        # P = I - 2 v v^H applied from both sides + accumulate Q
        h = h - 2.0 * jnp.outer(v, vc @ h)
        h = h - 2.0 * jnp.outer(h @ v, vc)
        q = q - 2.0 * jnp.outer(q @ v, vc)
        return h, q

    h, q = jax.lax.fori_loop(0, k - 2, step, (h0, q0))
    return h, q


def _wilkinson_shift(h, p):
    """Eigenvalue of the trailing active 2x2 block closest to its (2,2) entry."""
    blk = jax.lax.dynamic_slice(h, (p - 2, p - 2), (2, 2))
    a, b, c, d = blk[0, 0], blk[0, 1], blk[1, 0], blk[1, 1]
    tr = a + d
    det = a * d - b * c
    disc = jnp.sqrt(tr * tr - 4.0 * det)
    l1 = 0.5 * (tr + disc)
    l2 = 0.5 * (tr - disc)
    return jnp.where(jnp.abs(l1 - d) < jnp.abs(l2 - d), l1, l2)


@functools.partial(jax.jit, static_argnames=("max_sweeps",))
@highest_precision
def complex_schur(
    a: jax.Array, max_sweeps: Optional[int] = None
) -> Tuple[jax.Array, jax.Array]:
    """Complex Schur decomposition a = u @ t @ u^H, t upper triangular.

    Args:
      a: (k, k) complex (cast real input to complex first).
      max_sweeps: iteration bound; default 12*k + 60.  Each sweep is one
        shifted full-matrix QR step.
    """
    if not jnp.iscomplexobj(a):
        raise TypeError("complex_schur expects a complex array; cast first")
    k = a.shape[0]
    if max_sweeps is None:
        max_sweeps = 12 * k + 60
    if k == 0:
        return a, a
    if k == 1:
        return a, jnp.eye(1, dtype=a.dtype)

    h0, u0 = hessenberg(a)
    eye = jnp.eye(k, dtype=a.dtype)
    rows = jax.lax.broadcasted_iota(jnp.int32, (k, k), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (k, k), 1)
    sub_i = jax.lax.broadcasted_iota(jnp.int32, (k - 1,), 0)
    eps = jnp.finfo(jnp.real(a).dtype).eps

    def clean_and_active(h):
        """Zero negligible subdiagonals; return (h, p) with p = active size."""
        # Enforce exact Hessenberg form: roundoff junk below the subdiagonal
        # would otherwise be amplified into deflated positions whenever a
        # shift makes H - mu*I nearly singular (near-zero R diagonal entries
        # turn negligible column tails into full rotations).
        h = jnp.where(rows > cols + 1, 0.0, h)
        diag = jnp.abs(jnp.diagonal(h))
        sub = jnp.diagonal(h, offset=-1)
        small = jnp.abs(sub) <= eps * (diag[:-1] + diag[1:] + eps)
        # zero all small subdiagonal entries (aggressive deflation);
        # position (i+1, i) maps to small[i] via the column index
        h = jnp.where((rows == cols + 1) & small[jnp.minimum(cols, k - 2)], 0.0, h)
        sub_nz = jnp.abs(jnp.diagonal(h, offset=-1)) > 0
        # active window = [0, p): p = 2 + last index with nonzero subdiagonal
        p = jnp.max(jnp.where(sub_nz, sub_i + 2, 1))
        return h, p

    h0, p0 = clean_and_active(h0)

    def cond(carry):
        _, _, p, sweeps, _ = carry
        return (p > 1) & (sweeps < max_sweeps)

    def body(carry):
        h, u, p, sweeps, stagnant = carry
        mu = _wilkinson_shift(h, p)
        # exceptional shift if no deflation for a while (breaks cycles)
        sub_pm1 = jnp.sum(jnp.where((rows == p - 1) & (cols == p - 2), h, 0.0))
        h_pp = jnp.sum(jnp.where((rows == p - 1) & (cols == p - 1), h, 0.0))
        mu_exc = h_pp + 0.75 * jnp.abs(sub_pm1)
        mu = jnp.where(stagnant >= 8, mu_exc, mu)
        qs, r = jnp.linalg.qr(h - mu * eye)
        h = r @ qs + mu * eye
        u = u @ qs
        h, p_new = clean_and_active(h)
        stagnant = jnp.where(p_new < p, 0, stagnant + 1)
        return h, u, p_new, sweeps + 1, stagnant

    h, u, p, _, _ = jax.lax.while_loop(
        cond, body, (h0, u0, p0, jnp.int32(0), jnp.int32(0))
    )
    # enforce exact triangularity on output
    t = jnp.where(rows > cols, 0.0, h)
    return t, u
