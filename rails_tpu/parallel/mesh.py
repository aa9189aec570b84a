"""Mesh and sharding helpers.

The reference's only parallel strategy is 1-D row partitioning of all
m-sized objects over MPI ranks, with every k-sized object replicated
(SURVEY.md section 2.7; Epetra_Map distribution at
/root/reference/src/main.cpp:66-74).  The equivalent here is a 1-D
``rows`` mesh axis: V/AV/MV and the sparse payloads of A/M are sharded
along rows, the small projected matrices are replicated, and XLA's SPMD
partitioner inserts the collectives the reference got from Epetra:

  V' @ W   -> local GEMM + psum       (Epetra Multiply + MPI_Allreduce)
  V @ T    -> local GEMM, no comm     (Epetra local Multiply)
  SpMM     -> halo exchange           (Epetra_CrsMatrix Import)

There is no tensor/pipeline/expert parallelism analogue in this domain -
the model *is* the row axis - so the mesh is one-dimensional by design.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "row_sharding", "col_sharding", "replicated"]

ROW_AXIS = "rows"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all available devices)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (ROW_AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """First axis sharded over rows (tall-skinny multivectors, dense A)."""
    return NamedSharding(mesh, P(ROW_AXIS))


def col_sharding(mesh: Mesh) -> NamedSharding:
    """Second axis sharded over rows (DIA data is (d, m))."""
    return NamedSharding(mesh, P(None, ROW_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
