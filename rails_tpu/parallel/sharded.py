"""Sharding placement for operators and solver state.

``shard_operator`` / ``shard_state`` lay out the solve over a 1-D mesh
(see mesh.py for the design rationale).  After placement, the *same*
jitted iteration runs unchanged: GSPMD turns the Gram contractions into
local-GEMM + psum and the SpMM shifts into neighbor collectives - the
reference's entire Epetra communication inventory
(/root/reference/src/Epetra_MultiVectorWrapper.cpp:418-438,
SchurOperator.cpp:132-153) becomes sharding annotations.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

from rails_tpu.operators import (
    CallableOperator,
    DenseOperator,
    DiagonalOperator,
    IdentityOperator,
    LinearOperator,
)
from rails_tpu.parallel.mesh import col_sharding, replicated, row_sharding
from rails_tpu.sparse.formats import (
    DiaMatrix,
    EllMatrix,
    HybMatrix,
    SparseOperator,
)

__all__ = ["shard_operator", "shard_state", "shard_array_rows"]


def shard_array_rows(x, mesh: Mesh):
    return jax.device_put(x, row_sharding(mesh))


def _shard_payload(payload, mesh):
    if isinstance(payload, DiaMatrix):
        return DiaMatrix(jax.device_put(payload.data, col_sharding(mesh)),
                         payload.offsets, payload.shape)
    if isinstance(payload, EllMatrix):
        return EllMatrix(jax.device_put(payload.indices, row_sharding(mesh)),
                         jax.device_put(payload.values, row_sharding(mesh)),
                         payload.shape)
    if isinstance(payload, HybMatrix):
        return HybMatrix(_shard_payload(payload.dia, mesh),
                         _shard_payload(payload.ell, mesh), payload.shape)
    raise TypeError(type(payload))


def _try_halo_hyb(op, mesh):
    """HYB fast path: explicit-halo DIA for the dense diagonals +
    ELL halo for the remainder, summed (halo_ell.py).  Returns
    None unless every part - both directions - satisfies its slab
    geometry; the transpose may be stored as a HYB split or a single
    ELL (formats.sparse_from_scipy builds either)."""
    from rails_tpu.parallel.halo_ell import (
        HaloEllOperator, HaloHybOperator, build_halo_ell)
    from rails_tpu.parallel.halo_spmm import (
        HaloDiaOperator, halo_geometry_ok)

    fwd = op.fwd
    if not halo_geometry_ok(fwd.dia, mesh):
        return None
    ell_f = build_halo_ell(fwd.ell, mesh)
    if ell_f is None:
        return None
    tags = dict(is_symmetric=op.is_symmetric, is_spd=op.is_spd,
                is_hurwitz=op.is_hurwitz)
    if op.bwd is None:
        return HaloHybOperator(
            HaloDiaOperator(fwd.dia, mesh),
            HaloEllOperator(ell_f, mesh), nnz=op.nnz, **tags)
    if isinstance(op.bwd, HybMatrix):
        if not halo_geometry_ok(op.bwd.dia, mesh):
            return None
        ell_b = build_halo_ell(op.bwd.ell, mesh)
        if ell_b is None:
            return None
        return HaloHybOperator(
            HaloDiaOperator(fwd.dia, mesh, op.bwd.dia),
            HaloEllOperator(ell_f, mesh, ell_b), nnz=op.nnz, **tags)
    if isinstance(op.bwd, EllMatrix):
        whole_b = build_halo_ell(op.bwd, mesh)
        if whole_b is None:
            return None
        return HaloHybOperator(
            HaloDiaOperator(fwd.dia, mesh),
            HaloEllOperator(ell_f, mesh),
            rmat_op=HaloEllOperator(whole_b, mesh), nnz=op.nnz, **tags)
    return None


def shard_operator(op: LinearOperator, mesh: Mesh,
                   spmm: str = "auto") -> LinearOperator:
    """Place an operator's payload row-sharded on the mesh.

    ``spmm`` picks the distributed SpMM strategy for sparse payloads:
    'halo' routes applies through the explicit-halo shard_map operators
    (ppermute neighbor exchange + per-device apply - the reference's
    Epetra Apply pattern, /root/reference/src/Epetra_OperatorWrapper.cpp
    :75-91; DIA via halo_spmm.py, ELL/HYB via halo_ell.py), 'gspmd'
    leaves communication to the partitioner, 'auto' uses halo whenever
    the slab geometry allows.
    """
    if spmm not in ("auto", "halo", "gspmd"):
        raise ValueError(f"unknown spmm strategy {spmm!r}")
    if getattr(op, "already_placed", False):
        # DistributedSchurOperator (and anything else constructed on a
        # mesh) arrives with its payloads already laid out
        return op
    if isinstance(op, DenseOperator):
        return DenseOperator(
            jax.device_put(op.a, row_sharding(mesh)),
            is_symmetric=op.is_symmetric, is_spd=op.is_spd,
            is_hurwitz=op.is_hurwitz)
    if isinstance(op, DiagonalOperator):
        return DiagonalOperator(
            jax.device_put(op.d, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("rows"))),
            is_spd=op.is_spd)
    if isinstance(op, SparseOperator):
        if spmm != "gspmd" and isinstance(op.fwd, DiaMatrix):
            from rails_tpu.parallel.halo_spmm import (
                HaloDiaOperator, halo_geometry_ok)
            bwd_ok = op.bwd is None or isinstance(op.bwd, DiaMatrix)
            if bwd_ok and halo_geometry_ok(op.fwd, mesh) and (
                    op.bwd is None or halo_geometry_ok(op.bwd, mesh)):
                return HaloDiaOperator(
                    op.fwd, mesh, op.bwd,
                    is_symmetric=op.is_symmetric, is_spd=op.is_spd,
                    is_hurwitz=op.is_hurwitz)
            if spmm == "halo":
                raise ValueError(
                    "spmm='halo' requires a square DIA payload with rows "
                    "divisible by the mesh and stencil span within one "
                    "per-device slab")
        if spmm != "gspmd" and isinstance(op.fwd, EllMatrix):
            # distributed ELL halo path; requires both directions to
            # qualify so rmatmat stays on it too
            from rails_tpu.parallel.halo_ell import (
                HaloEllOperator, build_halo_ell)
            fwd = build_halo_ell(op.fwd, mesh)
            if fwd is not None:
                bwd = None
                if op.bwd is not None and isinstance(op.bwd, EllMatrix):
                    bwd = build_halo_ell(op.bwd, mesh)
                if op.bwd is None or bwd is not None:
                    return HaloEllOperator(
                        fwd, mesh, bwd, is_symmetric=op.is_symmetric,
                        is_spd=op.is_spd, is_hurwitz=op.is_hurwitz,
                        nnz=op.nnz)
            if spmm == "halo":
                raise ValueError(
                    "spmm='halo' requires a square ELL payload with rows "
                    "divisible by the mesh and remote references within "
                    "the adjacent slabs (both directions)")
        if spmm != "gspmd" and isinstance(op.fwd, HybMatrix):
            halo = _try_halo_hyb(op, mesh)
            if halo is not None:
                return halo
            if spmm == "halo":
                raise ValueError(
                    "spmm='halo' requires both the DIA and ELL parts of "
                    "the HYB payload (and its transpose) to satisfy the "
                    "halo slab geometry")
        bwd = None if op.bwd is None else _shard_payload(op.bwd, mesh)
        return SparseOperator(
            _shard_payload(op.fwd, mesh), bwd,
            is_symmetric=op.is_symmetric, is_spd=op.is_spd,
            is_hurwitz=op.is_hurwitz, nnz=op.nnz)
    if isinstance(op, (CallableOperator, IdentityOperator)):
        return op
    raise TypeError(f"cannot shard operator of type {type(op)}")


def shard_state(state, mesh: Mesh):
    """Row-shard the m-sized buffers; replicate everything else
    (the reference's distributed-V / replicated-T split,
    SURVEY.md section 2.7)."""
    rows = row_sharding(mesh)
    rep = replicated(mesh)

    def place(x, sh):
        return None if x is None else jax.device_put(x, sh)

    return state._replace(
        V=place(state.V, rows), AV=place(state.AV, rows),
        MV=place(state.MV, rows), q_warm=place(state.q_warm, rows),
        BV=place(state.BV, rep), VAV=place(state.VAV, rep),
        VBV=place(state.VBV, rep), VMV=place(state.VMV, rep),
        T=place(state.T, rep),
    )
