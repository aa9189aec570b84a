"""Distributed ELL SpMM with explicit halo exchange.

Extends the explicit-halo shard_map pattern (halo_spmm.py) to ELL
payloads, covering the reference's baseline case - Epetra's SpMV on
*arbitrary* CrsMatrix sparsity under MPI row distribution
(/root/reference/src/Epetra_OperatorWrapper.cpp:75-91) - for every
matrix whose per-shard remote references stay within the neighbor slabs
(banded/structured sparsity, and general sparsity after RCM reordering).

Design (host-side setup, device-side apply):

- each device owns a contiguous row slab of x and of the ELL payload;
- the builder rebases every column index into the *extended local*
  coordinate system ``[0, halo_lo + m_loc + halo_hi)``, where ``halo_lo``
  / ``halo_hi`` are the worst-case remote spans over all shards (uniform
  so the SPMD program is homogeneous), and stacks the per-shard indices
  with the values into row-sharded buffers;
- the apply ppermutes the boundary rows to both neighbors, concatenates
  ``[halo_lo | x_loc | halo_hi]``, and runs the plain ELL gather
  (``EllMatrix.matmat``) over the extended slab.

The halo is ``(halo_lo + halo_hi) * s`` elements - a band's worth - so
the exchange is a latency, not a bandwidth, cost.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rails_tpu.operators import LinearOperator
from rails_tpu.parallel.mesh import ROW_AXIS, row_sharding
from rails_tpu.sparse.formats import EllMatrix

__all__ = ["HaloEll", "build_halo_ell", "halo_ell_spmm", "HaloEllOperator",
           "HaloHybOperator"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class HaloEll:
    """Stacked per-shard ELL payload in extended-local coordinates.
    ``indices`` / ``values`` are (m, L), sharded over rows; shard r's
    indices address its own ``[halo_lo | x_loc | halo_hi]`` slab.
    ``halo_lo``/``halo_hi`` are static and uniform across shards."""

    indices: jax.Array               # (m, L) int32, extended-local
    values: jax.Array                # (m, L)
    halo_lo: int
    halo_hi: int
    shape: Tuple[int, int]           # global (m, m)

    def astype(self, dtype) -> "HaloEll":
        if self.values.dtype == jnp.dtype(dtype):
            return self
        return HaloEll(self.indices, self.values.astype(dtype),
                       self.halo_lo, self.halo_hi, self.shape)

    def tree_flatten(self):
        return (self.indices, self.values), (self.halo_lo, self.halo_hi,
                                             self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], *aux)


def build_halo_ell(ell: EllMatrix, mesh: Mesh) -> Optional[HaloEll]:
    """Host-side shard analysis.  Returns None when the decomposition
    does not qualify: non-square payload, rows not divisible by the
    mesh, or remote references reaching beyond the adjacent slabs."""
    m, n = ell.shape
    nd = mesh.devices.size
    if m != n or m % nd:
        return None
    m_loc = m // nd
    indices = np.asarray(ell.indices).astype(np.int64)
    # worst-case remote spans over all shards (uniform halos keep the
    # SPMD program homogeneous); padding slots carry row-local indices
    # (formats.ell_arrays_from_scipy) so they never widen the spans
    r0 = (np.arange(m) // m_loc * m_loc)[:, None]
    halo_lo = max(int((r0 - indices).max()), 0)
    halo_hi = max(int((indices - (r0 + m_loc - 1)).max()), 0)
    if halo_lo > m_loc or halo_hi > m_loc:
        return None  # needs rows beyond the adjacent slabs
    local = (indices - (r0 - halo_lo)).astype(np.int32)
    payload = HaloEll(jnp.asarray(local), jnp.asarray(ell.values),
                      halo_lo, halo_hi, (m, n))
    return _place(payload, mesh)


def _place(p: HaloEll, mesh: Mesh) -> HaloEll:
    row = NamedSharding(mesh, P(ROW_AXIS))
    return HaloEll(jax.device_put(p.indices, row),
                   jax.device_put(p.values, row),
                   p.halo_lo, p.halo_hi, p.shape)


def _halo_ell_body(p: HaloEll, idx_loc, val_loc, x_loc, nd: int):
    """Per-shard apply (inside shard_map): exchange halos, extend the
    operand, gather."""
    m_loc = x_loc.shape[0]
    fwd = [(i, i + 1) for i in range(nd - 1)]
    bwd = [(i + 1, i) for i in range(nd - 1)]
    parts = []
    if p.halo_lo:
        parts.append(jax.lax.ppermute(
            x_loc[m_loc - p.halo_lo:], ROW_AXIS, fwd))
    parts.append(x_loc)
    if p.halo_hi:
        parts.append(jax.lax.ppermute(x_loc[:p.halo_hi], ROW_AXIS, bwd))
    x_ext = jnp.concatenate(parts, axis=0) if len(parts) > 1 else x_loc
    ell = EllMatrix(idx_loc, val_loc, (m_loc, x_ext.shape[0]))
    return ell.matmat(x_ext)


def halo_ell_spmm(p: HaloEll, x: jax.Array, mesh: Mesh) -> jax.Array:
    """A @ x over the mesh with explicit neighbor halo exchange."""
    nd = mesh.devices.size

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS)),
        out_specs=P(ROW_AXIS))
    def run(idx_loc, val_loc, x_loc):
        return _halo_ell_body(p, idx_loc, val_loc, x_loc, nd)

    return run(p.indices, p.values, x)


@jax.tree_util.register_pytree_node_class
class HaloEllOperator(LinearOperator):
    """LinearOperator running the distributed ELL SpMM.

    Built by ``shard_operator`` from a SparseOperator with ELL payloads
    when ``build_halo_ell`` accepts both directions; payloads are placed
    at construction so ``matmat`` runs collective-minimal inside any
    enclosing jit."""

    def __init__(self, fwd: HaloEll, mesh: Mesh,
                 bwd: Optional[HaloEll] = None, *,
                 is_symmetric=False, is_spd=False, is_hurwitz=False,
                 nnz: int = 0):
        self.fwd = fwd
        self.bwd = bwd
        self.mesh = mesh
        self.is_symmetric = is_symmetric or bwd is None
        self.is_spd = is_spd
        self.is_hurwitz = is_hurwitz
        self.nnz = nnz

    @property
    def shape(self):
        return self.fwd.shape

    @property
    def payload_dtype(self):
        return self.fwd.values.dtype

    def astype(self, dtype):
        fwd = self.fwd.astype(dtype)
        bwd = None if self.bwd is None else self.bwd.astype(dtype)
        if fwd is self.fwd and bwd is self.bwd:
            return self
        return HaloEllOperator(fwd, self.mesh, bwd,
                               is_symmetric=self.is_symmetric,
                               is_spd=self.is_spd,
                               is_hurwitz=self.is_hurwitz, nnz=self.nnz)

    def matmat(self, x):
        return halo_ell_spmm(self.fwd, x, self.mesh)

    def rmatmat(self, x):
        if self.bwd is None:
            return self.matmat(x)
        return halo_ell_spmm(self.bwd, x, self.mesh)

    def to_dense(self):
        eye = jax.device_put(
            jnp.eye(self.shape[1], dtype=self.fwd.values.dtype),
            row_sharding(self.mesh))
        return self.matmat(eye)

    def tree_flatten(self):
        return (self.fwd, self.bwd), (self.mesh, self.is_symmetric,
                                      self.is_spd, self.is_hurwitz,
                                      self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.fwd, obj.bwd = children
        (obj.mesh, obj.is_symmetric, obj.is_spd, obj.is_hurwitz,
         obj.nnz) = aux
        return obj


@jax.tree_util.register_pytree_node_class
class HaloHybOperator(LinearOperator):
    """Distributed HYB apply: the dense diagonals ride the explicit-halo
    DIA path (halo_spmm.py), the irregular remainder the ELL halo path - each with its own neighbor
    exchange, summed.  ``rmat_op``, when set, computes the whole A'x
    (used when the transpose payload is stored as a single ELL rather
    than a HYB split); otherwise the transpose is the sum of the parts'
    rmatmat."""

    def __init__(self, dia_op, ell_op, *, rmat_op=None,
                 is_symmetric=False, is_spd=False, is_hurwitz=False,
                 nnz: int = 0):
        self.dia_op = dia_op
        self.ell_op = ell_op
        self.rmat_op = rmat_op
        self.is_symmetric = is_symmetric
        self.is_spd = is_spd
        self.is_hurwitz = is_hurwitz
        self.nnz = nnz

    @property
    def shape(self):
        return self.dia_op.shape

    @property
    def payload_dtype(self):
        return self.dia_op.payload_dtype

    def astype(self, dtype):
        dia = self.dia_op.astype(dtype)
        ell = self.ell_op.astype(dtype)
        rmat = None if self.rmat_op is None else self.rmat_op.astype(dtype)
        if dia is self.dia_op and ell is self.ell_op \
                and rmat is self.rmat_op:
            return self
        return HaloHybOperator(dia, ell, rmat_op=rmat,
                               is_symmetric=self.is_symmetric,
                               is_spd=self.is_spd,
                               is_hurwitz=self.is_hurwitz, nnz=self.nnz)

    def matmat(self, x):
        return self.dia_op.matmat(x) + self.ell_op.matmat(x)

    def rmatmat(self, x):
        if self.rmat_op is not None:
            return self.rmat_op.matmat(x)
        return self.dia_op.rmatmat(x) + self.ell_op.rmatmat(x)

    def to_dense(self):
        return self.dia_op.to_dense() + self.ell_op.to_dense()

    def tree_flatten(self):
        return (self.dia_op, self.ell_op, self.rmat_op), (
            self.is_symmetric, self.is_spd, self.is_hurwitz, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.dia_op, obj.ell_op, obj.rmat_op = children
        obj.is_symmetric, obj.is_spd, obj.is_hurwitz, obj.nnz = aux
        return obj
