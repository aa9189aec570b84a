"""Device sparse-matrix formats.

The reference's distributed sparse matrix is row-partitioned CSR
(Epetra_CrsMatrix).  The device formats here trade CSR's per-row
indirection for dense, regular payloads that XLA fuses into a single
pass over the operand:

- **DIA (diagonal)**: offsets + dense diagonal data.  The PDE/ocean
  matrices the reference targets (2D Laplacian stencils, structured-grid
  Jacobians like DataErik) have a handful of distinct diagonals; SpMM
  is a sum of shifted elementwise products over a once-padded operand -
  no gathers, memory-bandwidth-bound, trivially row-shardable (the shift
  halo becomes a neighbor exchange).
- **ELL (padded row-wise)**: column indices + values padded to the max
  row degree.  SpMM is one gather of V rows + a fused multiply-add per
  slot.  Handles general sparsity (sprand tests, irregular meshes).
- **HYB**: DIA for the densely-occupied diagonals plus an ELL remainder.

``sparse_from_*`` picks DIA automatically when the distinct-offset count
is small (the structured case), else HYB or ELL.  Host-side analysis uses
scipy.sparse; device payloads are plain jnp arrays registered as pytree
leaves so operators pass through jit/sharding like any array.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from rails_tpu.operators import LinearOperator

__all__ = [
    "DiaMatrix",
    "EllMatrix",
    "HybMatrix",
    "SparseOperator",
    "sparse_from_dense",
    "sparse_from_scipy",
    "sparse_from_csr",
]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DiaMatrix:
    """offsets[d] static python ints; data[d, m]: data[d, i] multiplies
    x[i + offsets[d]] into y[i]."""

    data: jax.Array                  # (d, m)
    offsets: Tuple[int, ...]         # static
    shape: Tuple[int, int]           # static

    def matmat(self, x: jax.Array) -> jax.Array:
        # one fused expression over a once-padded operand: the zero
        # padding stands in for the out-of-range columns, so every
        # diagonal is a full-length shifted slice and XLA emits a single
        # pass that reads x (neighbouring diagonals hit in cache) and
        # writes y once
        m, n = self.shape
        lo = max(0, -min(self.offsets))
        hi = max(0, m + max(self.offsets) - n)
        xpad = jnp.pad(x, ((lo, hi),) + ((0, 0),) * (x.ndim - 1))
        vshape = (m,) + (1,) * (x.ndim - 1)
        y = None
        for idx, off in enumerate(self.offsets):
            term = self.data[idx].reshape(vshape).astype(x.dtype) * \
                jax.lax.slice_in_dim(xpad, lo + off, lo + off + m, axis=0)
            y = term if y is None else y + term
        if y is None:
            return jnp.zeros((m,) + x.shape[1:], dtype=x.dtype)
        return y

    def matmat2(self, x: jax.Array):
        """Error-free A @ x: returns (hi, lo) with A x = hi + lo up to
        O(eps^2).  Each product rides two_prod, each accumulation
        two_sum (Ogita-Rump-Oishi EFTs; see utils/compensated.py).
        Feeds the exact residual factorization of the refined driver
        (rails_tpu/refine.py) - f32 storage, f64-quality factor."""
        from rails_tpu.utils.compensated import two_prod, two_sum

        m, n = self.shape
        hi = jnp.zeros((m,) + x.shape[1:], dtype=x.dtype)
        lo = jnp.zeros_like(hi)
        for idx, off in enumerate(self.offsets):
            diag = self.data[idx]
            lo_i, hi_i = (0, min(m, n - off)) if off >= 0 \
                else (-off, min(m, n - off))
            if hi_i <= lo_i:
                continue
            p, e = two_prod(diag[lo_i:hi_i, None], x[lo_i + off:hi_i + off])
            s, e2 = two_sum(hi[lo_i:hi_i], p)
            hi = hi.at[lo_i:hi_i].set(s)
            lo = lo.at[lo_i:hi_i].add(e + e2)
        return hi, lo

    def transpose(self) -> "DiaMatrix":
        """A'[j, i]: diagonal o of A becomes diagonal -o of A', with data
        re-indexed so data'[-o][i] = data[o][i - o]."""
        m, n = self.shape
        new_offsets = tuple(-o for o in self.offsets)
        rolled = []
        for idx, off in enumerate(self.offsets):
            d = self.data[idx]
            rolled.append(jnp.roll(d, off))
        return DiaMatrix(jnp.stack(rolled), new_offsets, (n, m))

    def astype(self, dtype) -> "DiaMatrix":
        if self.data.dtype == jnp.dtype(dtype):
            return self
        return DiaMatrix(self.data.astype(dtype), self.offsets, self.shape)

    def tree_flatten(self):
        return (self.data,), (self.offsets, self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class EllMatrix:
    """Padded row-wise format: y[i] = sum_l values[i, l] * x[indices[i, l]];
    padding slots have values == 0 and *row-local* indices (the row's own
    first column), so a row slab's column span - the halo a distributed
    apply exchanges (parallel/halo_ell.py) - stays tight."""

    indices: jax.Array               # (m, L) int32
    values: jax.Array                # (m, L)
    shape: Tuple[int, int]           # static

    def matmat(self, x: jax.Array) -> jax.Array:
        # one (m, s) gather + fused multiply-add per slot: peak memory
        # O(m*s), not the O(m*L*s) of a single big-gather einsum (at
        # MOC-like L~30 that temporary was 30x the operand)
        m, ell_l = self.indices.shape
        y = jnp.zeros((m,) + x.shape[1:], dtype=x.dtype)
        vshape = (m,) + (1,) * (x.ndim - 1)
        for l in range(ell_l):
            y = y + self.values[:, l].reshape(vshape) * jnp.take(
                x, self.indices[:, l], axis=0)
        return y

    def matmat2(self, x: jax.Array):
        """Error-free A @ x -> (hi, lo); see DiaMatrix.matmat2."""
        from rails_tpu.utils.compensated import two_prod, two_sum

        m, ell_l = self.indices.shape
        hi = jnp.zeros((m,) + x.shape[1:], dtype=x.dtype)
        lo = jnp.zeros_like(hi)
        vshape = (m,) + (1,) * (x.ndim - 1)
        for l in range(ell_l):
            p, e = two_prod(self.values[:, l].reshape(vshape),
                            jnp.take(x, self.indices[:, l], axis=0))
            hi, e2 = two_sum(hi, p)
            lo = lo + e + e2
        return hi, lo

    def astype(self, dtype) -> "EllMatrix":
        if self.values.dtype == jnp.dtype(dtype):
            return self
        return EllMatrix(self.indices, self.values.astype(dtype),
                         self.shape)

    def tree_flatten(self):
        return (self.indices, self.values), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class HybMatrix:
    """Hybrid DIA + ELL split (the classic HYB format): the
    densely-occupied diagonals ride the DIA path, the stray off-stencil
    entries go to a skinny ELL remainder.
    Extends the structured fast path to matrices that are banded *except*
    for a few irregular couplings (periodic wrap-around, boundary
    conditions, observation rows)."""

    dia: DiaMatrix
    ell: EllMatrix
    shape: Tuple[int, int]           # static

    def matmat(self, x: jax.Array) -> jax.Array:
        return self.dia.matmat(x) + self.ell.matmat(x)

    def matmat2(self, x: jax.Array):
        from rails_tpu.utils.compensated import two_sum

        h1, l1 = self.dia.matmat2(x)
        h2, l2 = self.ell.matmat2(x)
        hi, e = two_sum(h1, h2)
        return hi, l1 + l2 + e

    def astype(self, dtype) -> "HybMatrix":
        dia = self.dia.astype(dtype)
        ell = self.ell.astype(dtype)
        if dia is self.dia and ell is self.ell:
            return self
        return HybMatrix(dia, ell, self.shape)

    def tree_flatten(self):
        return (self.dia, self.ell), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])


@jax.tree_util.register_pytree_node_class
class SparseOperator(LinearOperator):
    """LinearOperator over a DIA/ELL payload, with a transposed payload for
    rmatmat (built host-side at construction)."""

    def __init__(self, fwd, bwd, *, is_symmetric=False, is_spd=False,
                 is_hurwitz=False, nnz: int = 0):
        self.fwd = fwd
        self.bwd = bwd
        self.is_symmetric = is_symmetric
        self.is_spd = is_spd
        self.is_hurwitz = is_hurwitz
        self.nnz = nnz

    @property
    def shape(self):
        return self.fwd.shape

    @property
    def format(self) -> str:
        if isinstance(self.fwd, DiaMatrix):
            return "dia"
        return "hyb" if isinstance(self.fwd, HybMatrix) else "ell"

    @property
    def payload_dtype(self):
        p = self.fwd
        if isinstance(p, HybMatrix):
            p = p.dia
        return p.data.dtype if isinstance(p, DiaMatrix) else p.values.dtype

    def matmat(self, x):
        return self.fwd.matmat(x)

    def matmat2(self, x):
        """Error-free apply (hi, lo) for the refined driver."""
        return self.fwd.matmat2(x)

    def rmatmat(self, x):
        return (self.fwd if self.bwd is None else self.bwd).matmat(x)

    def to_dense(self):
        return self.fwd.matmat(jnp.eye(self.shape[1]))

    def astype(self, dtype):
        fwd = self.fwd.astype(dtype)
        bwd = None if self.bwd is None else self.bwd.astype(dtype)
        if fwd is self.fwd and bwd is self.bwd:
            return self
        return SparseOperator(fwd, bwd, is_symmetric=self.is_symmetric,
                              is_spd=self.is_spd, is_hurwitz=self.is_hurwitz,
                              nnz=self.nnz)

    def tree_flatten(self):
        return (self.fwd, self.bwd), (self.is_symmetric, self.is_spd,
                                      self.is_hurwitz, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.fwd, obj.bwd = children
        obj.is_symmetric, obj.is_spd, obj.is_hurwitz, obj.nnz = aux
        return obj


def payload_to_scipy(p) -> sp.csr_matrix:
    """Host-side inverse of sparse_from_scipy for a device payload
    (diagnostics: condest checks, test oracles)."""
    if isinstance(p, DiaMatrix):
        m, n = p.shape
        data = np.asarray(p.data)
        rows, cols, vals = [], [], []
        for k, off in enumerate(p.offsets):
            lo, hi = max(0, -off), min(m, n - off)
            if hi <= lo:
                continue
            i = np.arange(lo, hi)
            rows.append(i)
            cols.append(i + off)
            vals.append(data[k, lo:hi])
        return sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows),
                                    np.concatenate(cols))),
            shape=p.shape).tocsr()
    if isinstance(p, EllMatrix):
        ind = np.asarray(p.indices)
        val = np.asarray(p.values)
        m, ell_l = ind.shape
        rows = np.repeat(np.arange(m), ell_l)
        out = sp.coo_matrix((val.ravel(), (rows, ind.ravel())),
                            shape=p.shape).tocsr()
        out.eliminate_zeros()
        return out
    if isinstance(p, HybMatrix):
        return (payload_to_scipy(p.dia) + payload_to_scipy(p.ell)).tocsr()
    raise TypeError(type(p))


def _dia_from_scipy(a: sp.spmatrix, dtype) -> DiaMatrix:
    m, n = a.shape
    adia = a.todia()
    offsets = tuple(int(o) for o in adia.offsets)
    # scipy dia: data[k, j] is the value at column j on diagonal k, i.e.
    # entry (j - offset, j).  Our convention: data[k, i] multiplies
    # x[i + offset] into y[i], i.e. entry (i, i + offset) -> data[k, i] =
    # scipy_data[k, i + offset].
    data = np.zeros((len(offsets), m), dtype=jnp.dtype(dtype).name)
    sd = adia.data
    for k, off in enumerate(offsets):
        lo, hi = max(0, -off), min(m, n - off, sd.shape[1] - off)
        if hi > lo:
            data[k, lo:hi] = sd[k, lo + off:hi + off]
    return DiaMatrix(jnp.asarray(data), offsets, (m, n))


def ell_arrays_from_scipy(a: sp.spmatrix, dtype,
                          pad_row_local: bool = True):
    """Raw padded row-ELL (indices, values) of a scipy matrix - the
    shared CSR-to-ELL scatter core (also used by the distributed Schur
    payload builder, parallel/schur_dist.py).  ``pad_row_local`` fills
    padding slots with the row's own first column index (keeps a row
    slab's column span, hence its halo, tight); False pads with index 0
    (value 0 either way, harmless to gather and scatter applies)."""
    csr = a.tocsr()
    m, n = csr.shape
    deg = np.diff(csr.indptr)
    ell_l = max(int(deg.max()), 1) if m else 1
    if pad_row_local:
        # empty rows pad with the clamped row id
        pad = np.minimum(np.arange(m, dtype=np.int64), max(n - 1, 0))
        if csr.nnz:
            first = np.where(deg > 0, csr.indices[np.minimum(
                csr.indptr[:-1], csr.nnz - 1)], pad)
        else:
            first = pad
        indices = np.repeat(first[:, None], ell_l,
                            axis=1).astype(np.int32)
    else:
        indices = np.zeros((m, ell_l), np.int32)
    values = np.zeros((m, ell_l), dtype=jnp.dtype(dtype).name)
    if csr.nnz:
        rows = np.repeat(np.arange(m), deg)
        slots = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], deg)
        indices[rows, slots] = csr.indices
        values[rows, slots] = csr.data
    return indices, values


def _ell_from_scipy(a: sp.spmatrix, dtype) -> EllMatrix:
    indices, values = ell_arrays_from_scipy(a, dtype)
    return EllMatrix(jnp.asarray(indices), jnp.asarray(values), a.shape)


def _hyb_split(a: sp.csr_matrix, dia_fill_limit: float,
               dia_max_offsets: int):
    """Pick the diagonals worth storing densely: greedily keep the most
    occupied ones while the DIA fill (one m-vector per kept diagonal)
    stays under ``dia_fill_limit`` x the nnz they cover.  Returns
    (dia_part, ell_part) as scipy matrices, or None if the split isn't
    worthwhile (covers < 50% of nnz or the remainder isn't small)."""
    coo = a.tocoo()
    m = a.shape[0]
    offs = coo.col - coo.row
    uniq, counts = np.unique(offs, return_counts=True)
    order = np.argsort(-counts)
    kept = []
    covered = 0
    for j in order[:dia_max_offsets]:
        # marginal test: a diagonal stored densely costs m slots; one
        # whose own fill m/count exceeds the limit belongs in the ELL
        # remainder (counts sorted desc, so stop at the first such)
        if m > dia_fill_limit * counts[j]:
            break
        if (len(kept) + 1) * m > dia_fill_limit * (covered + counts[j]):
            break
        kept.append(uniq[j])
        covered += counts[j]
    if not kept or covered < 0.5 * max(coo.nnz, 1):
        return None
    kept_mask = np.isin(offs, kept)
    if (~kept_mask).sum() == 0:
        return None  # pure DIA, no remainder
    dia_part = sp.coo_matrix(
        (coo.data[kept_mask], (coo.row[kept_mask], coo.col[kept_mask])),
        shape=a.shape)
    ell_part = sp.coo_matrix(
        (coo.data[~kept_mask], (coo.row[~kept_mask], coo.col[~kept_mask])),
        shape=a.shape).tocsr()
    # remainder must be skinny, or ELL padding defeats the purpose
    if np.diff(ell_part.indptr).max() > max(
            8, 2 * coo.nnz // max(m, 1)):
        return None
    return dia_part.tocsr(), ell_part


def _hyb_from_scipy(a: sp.csr_matrix, dtype, dia_fill_limit: float,
                    dia_max_offsets: int) -> Optional[HybMatrix]:
    split = _hyb_split(a, dia_fill_limit, dia_max_offsets)
    if split is None:
        return None
    dia_part, ell_part = split
    return HybMatrix(_dia_from_scipy(dia_part, dtype),
                     _ell_from_scipy(ell_part, dtype), a.shape)


def sparse_from_scipy(a: sp.spmatrix, *, fmt: str = "auto",
                      dia_max_offsets: int = 96, dia_fill_limit: float = 8.0,
                      dtype=None, **tags) -> SparseOperator:
    """Build a device SparseOperator from a scipy sparse matrix.

    fmt: 'auto' | 'dia' | 'hyb' | 'ell'.  'auto' picks DIA when the
    matrix has at most ``dia_max_offsets`` distinct diagonals *and* the
    DIA fill (d*m values stored for nnz actual entries) stays under
    ``dia_fill_limit`` - structured-grid Jacobians like the reference's
    DataErik ocean matrix (54 offsets, fill 4.8x) take the DIA fast
    path.  When full DIA doesn't qualify but a subset of diagonals
    covers most of the nnz, 'auto' falls back to HYB (dense diagonals +
    ELL remainder); otherwise ELL.
    """
    if dtype is None:
        dtype = jnp.asarray(0.0).dtype
    a = a.tocsr()
    m, n = a.shape
    nnz = int(a.nnz)
    if fmt == "auto":
        coo = a.tocoo()
        n_offsets = len(np.unique(coo.col - coo.row))
        dia_ok = (n_offsets <= dia_max_offsets
                  and n_offsets * m <= dia_fill_limit * max(nnz, 1))
        fmt = "dia" if dia_ok else "hyb"
    sym = bool(tags.get("is_symmetric", False))
    if not sym and nnz and m == n and (a != a.T).nnz == 0:
        sym = True
        tags["is_symmetric"] = True
    if fmt == "dia":
        fwd = _dia_from_scipy(a, dtype)
        bwd = None if sym else _dia_from_scipy(a.T.tocsr(), dtype)
    elif fmt == "hyb":
        fwd = _hyb_from_scipy(a, dtype, dia_fill_limit, dia_max_offsets)
        if fwd is None:
            fmt = "ell"
        elif sym:
            bwd = None
        else:
            bwd = _hyb_from_scipy(
                a.T.tocsr(), dtype, dia_fill_limit, dia_max_offsets)
            if bwd is None:  # transpose split can fail independently
                bwd = _ell_from_scipy(a.T.tocsr(), dtype)
    if fmt == "ell":
        fwd = _ell_from_scipy(a, dtype)
        bwd = None if sym else _ell_from_scipy(a.T.tocsr(), dtype)
    elif fmt not in ("dia", "hyb"):
        raise ValueError(f"unknown sparse format {fmt!r}")
    return SparseOperator(fwd, bwd, nnz=nnz, **tags)


def sparse_from_dense(a, **kw) -> SparseOperator:
    return sparse_from_scipy(sp.csr_matrix(np.asarray(a)), **kw)


def sparse_from_csr(indptr, indices, data, shape=None, **kw) -> SparseOperator:
    """From raw CSR arrays (the DataErik on-disk layout, see rails_tpu.io)."""
    indptr = np.asarray(indptr)
    if shape is None:
        m = len(indptr) - 1
        shape = (m, m)
    csr = sp.csr_matrix((np.asarray(data), np.asarray(indices), indptr),
                        shape=shape)
    return sparse_from_scipy(csr, **kw)
