"""Distributed DIA SpMM with explicit halo exchange (shard_map + ppermute).

The GSPMD path (jit over sharded arrays) already parallelizes the DIA
shifts correctly, but the communication it derives is up to the
partitioner.  This module pins the pattern down the way the reference's
Epetra SpMV does (column-halo import inside Epetra_CrsMatrix::Apply,
/root/reference/src/Epetra_OperatorWrapper.cpp:87):

- each device owns a contiguous row slab of x and of the diagonal data;
- the only remote rows a device needs are the ``span_lo`` rows below and
  ``span_hi`` rows above its slab - exchanged with its two neighbors by
  ``lax.ppermute``;
- the bulk (interior) contribution depends only on local data, so XLA's
  latency-hiding scheduler can overlap it with the permutes: the code
  computes ``y = interior(x_local) + boundary(halos)`` with the first
  term collective-free.

Boundary devices receive zeros from ppermute's non-cyclic permutation,
which is exactly the Dirichlet zero-padding the dense formats use.

``LyapunovSolver(mesh=...)`` routes DIA operators through
``HaloDiaOperator`` whenever the slab geometry allows (see
``parallel.sharded.shard_operator``), so the production multi-device
path is the overlapped-halo one, not the partitioner-derived fallback.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rails_tpu.operators import LinearOperator
from rails_tpu.parallel.mesh import ROW_AXIS, col_sharding, row_sharding
from rails_tpu.sparse.formats import DiaMatrix

__all__ = ["halo_dia_spmm", "HaloDiaOperator", "halo_geometry_ok"]


def halo_geometry_ok(dia: DiaMatrix, mesh: Mesh) -> bool:
    """True when the slab decomposition supports the halo exchange:
    square, rows divisible by the mesh, stencil span within one slab."""
    m, n = dia.shape
    nd = mesh.devices.size
    if m != n or m % nd:
        return False
    m_loc = m // nd
    span_lo = max(0, -min(dia.offsets))
    span_hi = max(0, max(dia.offsets))
    return span_lo < m_loc and span_hi < m_loc


def _halo_spmm_sharded(data, x, offsets: Tuple[int, ...], mesh: Mesh):
    """shard_map body; data (d, m) sharded on cols, x (m, s) on rows."""
    m = x.shape[0]
    nd = mesh.devices.size
    m_loc = m // nd
    span_lo = max(0, -min(offsets))
    span_hi = max(0, max(offsets))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, ROW_AXIS), P(ROW_AXIS, None)),
        out_specs=P(ROW_AXIS, None))
    def run(data_loc, x_loc):
        # neighbor exchange: my bottom rows -> next device's lower halo,
        # my top rows -> previous device's upper halo
        fwd = [(i, i + 1) for i in range(nd - 1)]
        bwd = [(i + 1, i) for i in range(nd - 1)]
        dia_loc = DiaMatrix(data_loc, offsets, (m_loc, m_loc))
        halo_lo = jax.lax.ppermute(
            x_loc[-span_lo:, :], ROW_AXIS, fwd) if span_lo else None
        halo_hi = jax.lax.ppermute(
            x_loc[:span_hi, :], ROW_AXIS, bwd) if span_hi else None
        # interior contribution: no dependence on the permutes -> overlaps.
        # Per device it is exactly a local DIA SpMM with zero-extended
        # edges.
        y = dia_loc.matmat(x_loc)
        # boundary corrections once the halos arrive
        for k, off in enumerate(offsets):
            if off < 0 and halo_lo is not None:
                # rows i in [0, -off): x[i + off] lives in the lower halo
                w = -off
                contrib = data_loc[k, :w][:, None] \
                    * halo_lo[span_lo + off:span_lo + off + w, :]
                y = y.at[:w, :].add(contrib)
            elif off > 0 and halo_hi is not None:
                # rows i in [m_loc - off, m_loc): x[i + off] in upper halo
                w = off
                contrib = data_loc[k, m_loc - w:][:, None] \
                    * halo_hi[:w, :]
                y = y.at[m_loc - w:, :].add(contrib)
        return y

    return run(data, x)


def halo_dia_spmm(dia: DiaMatrix, x: jax.Array, mesh: Mesh) -> jax.Array:
    """A @ x with explicit neighbor halo exchange over the mesh.

    ``dia.data`` must be (d, m) and ``x`` (m, s) with m divisible by the
    mesh size; both are (re)sharded along rows.
    """
    m, _ = dia.shape
    nd = mesh.devices.size
    if m % nd:
        raise ValueError(f"rows {m} not divisible by mesh size {nd}")
    if not halo_geometry_ok(dia, mesh):
        raise ValueError("stencil span exceeds the per-device slab")
    data = jax.device_put(dia.data, NamedSharding(mesh, P(None, ROW_AXIS)))
    x = jax.device_put(x, NamedSharding(mesh, P(ROW_AXIS, None)))
    return _halo_spmm_sharded(data, x, dia.offsets, mesh)


@jax.tree_util.register_pytree_node_class
class HaloDiaOperator(LinearOperator):
    """LinearOperator running the explicit-halo distributed SpMM.

    Payloads are placed (data col-sharded over the mesh) at
    construction; ``matmat`` then runs collective-minimal inside any
    enclosing jit without per-call resharding."""

    def __init__(self, dia: DiaMatrix, mesh: Mesh,
                 bwd: Optional[DiaMatrix] = None, *,
                 is_symmetric=False, is_spd=False, is_hurwitz=False,
                 _placed=False):
        if not _placed:
            dia = DiaMatrix(jax.device_put(dia.data, col_sharding(mesh)),
                            dia.offsets, dia.shape)
            if bwd is not None:
                bwd = DiaMatrix(jax.device_put(bwd.data, col_sharding(mesh)),
                                bwd.offsets, bwd.shape)
        self.dia = dia
        self.bwd = bwd
        self.mesh = mesh
        self.is_symmetric = is_symmetric or bwd is None
        self.is_spd = is_spd
        self.is_hurwitz = is_hurwitz

    @property
    def shape(self):
        return self.dia.shape

    @property
    def payload_dtype(self):
        return self.dia.data.dtype

    def astype(self, dtype):
        dia = self.dia.astype(dtype)
        bwd = None if self.bwd is None else self.bwd.astype(dtype)
        if dia is self.dia and bwd is self.bwd:
            return self
        return HaloDiaOperator(dia, self.mesh, bwd,
                               is_symmetric=self.is_symmetric,
                               is_spd=self.is_spd,
                               is_hurwitz=self.is_hurwitz, _placed=True)

    def matmat(self, x):
        return _halo_spmm_sharded(self.dia.data, x, self.dia.offsets,
                                  self.mesh)

    def rmatmat(self, x):
        if self.bwd is None:
            return self.matmat(x)
        return _halo_spmm_sharded(self.bwd.data, x, self.bwd.offsets,
                                  self.mesh)

    def to_dense(self):
        eye = jax.device_put(jnp.eye(self.shape[1],
                                     dtype=self.dia.data.dtype),
                             row_sharding(self.mesh))
        return self.matmat(eye)

    def tree_flatten(self):
        return (self.dia, self.bwd), (self.mesh, self.is_symmetric,
                                      self.is_spd, self.is_hurwitz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.dia, obj.bwd = children
        obj.mesh, obj.is_symmetric, obj.is_spd, obj.is_hurwitz = aux
        return obj
