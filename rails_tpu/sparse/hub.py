"""Hub-splitting for power-law (scale-free) sparsity.

Plain ELL pads every row to the maximum degree, so a handful of hub
rows with degree ~m make the payload ~m x m.  ``hub_operator`` splits A
by a degree threshold:

- **hub rows** (degree > threshold, at most ``max_hubs``): stored DENSE
  as D = A[H, :] (h, m) - their apply is one (h, m) @ (m, s) GEMM,
  scattered back by one small ``y[H] +=`` update.
- **hub columns** (same set, for the non-hub rows): remapped onto the
  compacted index space [0, h) and stored as an (m, h) ELL over x[H].
- **remainder** (non-hub rows x non-hub cols): the low-degree bulk, a
  plain ELL (callers RCM-reorder first when the bulk has recoverable
  structure - rails_tpu.sparse.reorder).

``hub_coverage`` reports the fraction of nnz the hub set covers; for a
pure Barabasi-Albert graph it is ~sqrt(h/m), and the split leaves most
of the matrix in the remainder.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from rails_tpu.operators import LinearOperator
from rails_tpu.sparse.formats import EllMatrix, _ell_from_scipy

__all__ = ["HubSplitOperator", "hub_operator", "hub_coverage"]

_DENSE_BYTES_CAP = 1 << 30    # refuse silently huge dense hub blocks


def hub_coverage(a: sp.spmatrix, n_hubs: int) -> float:
    """Fraction of nnz incident to the ``n_hubs`` highest-degree
    rows/columns (for pure Barabasi-Albert this is ~sqrt(n_hubs/m))."""
    a = a.tocsr()
    deg = np.asarray(np.diff(a.indptr)) + np.asarray(
        np.diff(a.tocsc().indptr))
    hubs = np.argsort(-deg)[:n_hubs]
    mask = np.zeros(a.shape[0], bool)
    mask[hubs] = True
    coo = a.tocoo()
    covered = mask[coo.row] | mask[coo.col]
    return float(covered.sum() / max(coo.nnz, 1))


@jax.tree_util.register_pytree_node_class
class HubSplitOperator(LinearOperator):
    """y = rest @ x + hubcol_ell @ x[H] + e_H (D @ x).

    ``rest`` and ``hubcol`` are EllMatrix payloads (the latter over the
    compacted hub space), ``d`` the dense hub-row block.  Symmetric
    matrices reuse one split for rmatmat; nonsymmetric ones carry the
    transpose's split."""

    def __init__(self, rest: EllMatrix, hubcol: Optional[EllMatrix],
                 hub_idx, d, shape: Tuple[int, int], *,
                 bwd: Optional["HubSplitOperator"] = None,
                 is_symmetric=False, is_hurwitz=False, nnz: int = 0):
        self.rest = rest
        self.hubcol = hubcol          # (m, h) ELL over compacted hubs
        self.hub_idx = hub_idx        # (h,) int32 hub indices
        self.d = d                    # (h, m) dense hub rows
        self._shape = shape
        self.bwd = bwd
        self.is_symmetric = is_symmetric
        self.is_spd = False
        self.is_hurwitz = is_hurwitz
        self.nnz = nnz

    @property
    def shape(self):
        return self._shape

    @property
    def payload_dtype(self):
        return self.rest.values.dtype

    def _apply(self, rest, hubcol, hub_idx, d, x):
        y = rest.matmat(x)
        if hubcol is not None:
            y = y + hubcol.matmat(x[hub_idx])
        if d is not None:
            # HIGHEST: a float32 GEMM may otherwise run at reduced
            # precision (TF32 on the GPU); the apply streams D, so the
            # full-precision product costs nothing measurable
            y = y.at[hub_idx].add(jax.lax.dot(
                d, x, precision=jax.lax.Precision.HIGHEST))
        return y

    def matmat(self, x):
        return self._apply(self.rest, self.hubcol, self.hub_idx, self.d,
                           x)

    def rmatmat(self, x):
        if self.bwd is None:
            return self.matmat(x)   # symmetric
        return self.bwd.matmat(x)

    def astype(self, dtype):
        dt = jnp.dtype(dtype)
        if self.rest.values.dtype == dt:
            return self
        return HubSplitOperator(
            self.rest.astype(dtype),
            None if self.hubcol is None else self.hubcol.astype(dtype),
            self.hub_idx, None if self.d is None else self.d.astype(dtype),
            self._shape,
            bwd=None if self.bwd is None else self.bwd.astype(dtype),
            is_symmetric=self.is_symmetric, is_hurwitz=self.is_hurwitz,
            nnz=self.nnz)

    def to_dense(self):
        return self.matmat(jnp.eye(self._shape[1],
                                   dtype=self.payload_dtype))

    def tree_flatten(self):
        return ((self.rest, self.hubcol, self.hub_idx, self.d, self.bwd),
                (self._shape, self.is_symmetric, self.is_hurwitz,
                 self.nnz))

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        (obj.rest, obj.hubcol, obj.hub_idx, obj.d, obj.bwd) = children
        (obj._shape, obj.is_symmetric, obj.is_hurwitz, obj.nnz) = aux
        obj.is_spd = False
        return obj


def _split_one(a: sp.csr_matrix, hubs: np.ndarray, dtype,
               dense_cap: int):
    """One direction of the split; returns (rest_ell, hubcol_ell,
    hub_idx, d) or None when the dense block would exceed the cap."""
    m, n = a.shape
    h = len(hubs)
    if h and h * n * jnp.dtype(dtype).itemsize > dense_cap:
        return None
    hub_row = np.zeros(m, bool)
    hub_row[hubs] = True
    hub_col = np.zeros(n, bool)
    hub_col[hubs] = True
    coo = a.tocoo()
    in_d = hub_row[coo.row]
    in_hc = hub_col[coo.col] & ~in_d
    in_rest = ~in_d & ~in_hc

    def part(mask, shape, cols=None):
        c = coo.col[mask] if cols is None else cols
        return sp.coo_matrix(
            (coo.data[mask], (coo.row[mask], c)), shape=shape).tocsr()

    rest = _ell_from_scipy(part(in_rest, (m, n)), dtype)
    hubcol = None
    if in_hc.sum():
        # compact hub columns onto [0, h)
        remap = np.zeros(n, np.int64)
        remap[hubs] = np.arange(h)
        hubcol = _ell_from_scipy(
            part(in_hc, (m, h), remap[coo.col[in_hc]]), dtype)
    d = None
    if h:
        d = jnp.asarray(part(in_d, (m, n))[hubs].toarray(), dtype=dtype)
    return rest, hubcol, jnp.asarray(hubs.astype(np.int32)), d


def hub_operator(a: sp.spmatrix, *, max_hubs: int = 256,
                 degree_factor: float = 8.0, dtype=None,
                 dense_cap: int = _DENSE_BYTES_CAP,
                 **tags) -> HubSplitOperator:
    """Build the hub-split operator (module docstring).

    Hubs = rows/columns whose (in + out) degree exceeds
    ``degree_factor`` times the median degree, capped at ``max_hubs``
    (highest-degree first).  A factor of the median separates genuine
    superhubs from the bulk regardless of how many there are - a
    quantile rule can cut mid-cluster and leave hub rows in the
    remainder, where a single one pads the whole ELL remainder to its
    degree.  Callers with structured bulk should RCM-reorder the system
    first (rails_tpu.sparse.reorder); ``hub_coverage`` gives the
    fraction of nnz the split takes out of the remainder.
    """
    if dtype is None:
        dtype = jnp.asarray(0.0).dtype
    a = a.tocsr()
    m, n = a.shape
    if m != n:
        raise ValueError("hub_operator expects a square matrix")
    deg = np.asarray(np.diff(a.indptr)) + np.asarray(
        np.diff(a.tocsc().indptr))
    thresh = degree_factor * max(np.median(deg), 1.0)
    hubs = np.flatnonzero(deg > thresh)
    if len(hubs) > max_hubs:
        hubs = hubs[np.argsort(-deg[hubs])[:max_hubs]]
    hubs = np.sort(hubs)
    fwd = _split_one(a, hubs, dtype, dense_cap)
    if fwd is None:
        raise ValueError(
            f"dense hub block {len(hubs)} x {n} exceeds dense_cap="
            f"{dense_cap}; lower max_hubs or raise the cap")
    sym = bool(tags.pop("is_symmetric", False))
    if not sym and a.nnz and (a != a.T).nnz == 0:
        sym = True
    bwd = None
    if not sym:
        bwd_parts = _split_one(a.T.tocsr(), hubs, dtype, dense_cap)
        if bwd_parts is None:
            raise ValueError("transpose dense hub block exceeds cap")
        bwd = HubSplitOperator(*bwd_parts, (n, m), is_symmetric=False)
    return HubSplitOperator(*fwd, (m, n), bwd=bwd, is_symmetric=sym,
                            nnz=int(a.nnz), **tags)
