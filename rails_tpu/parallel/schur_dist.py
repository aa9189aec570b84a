"""Distributed Schur-complement operator - the reference's production
posture on a device mesh.

The reference's production driver is an MPI program whose solve runs on
the *SchurOperator*: every A12/A21/A22 application is a distributed
Epetra SpMM (/root/reference/src/SchurOperator.cpp:201-233), with only
the KLU factorization of A11 serial (:177-186).  This module is the
equivalent of that posture over the 1-D ``rows`` mesh:

- **A22** (n2 x n2, the dynamic block) is placed through
  ``shard_operator`` - the halo-ELL/DIA fast path when the slab geometry
  allows, GSPMD otherwise - exactly like a direct (nonsingular-M)
  distributed solve.
- **A21 and A12'** are stored as ELL payloads *over the n2 row space*
  (the space the solver state lives in), row-sharded with V:

  * ``A21 @ y``   (y replicated (n1, s)) and ``A12' @ y`` are row-local
    gathers from the replicated operand - no communication, the same
    cost class as the reference's local Epetra rows.
  * ``A12 @ x``   (x row-sharded (n2, s)) and ``A21' @ x`` are
    scatter-adds of each device's row slab into an (n1, s) partial,
    combined by one ``psum`` - the transpose-SpMM + Allreduce pattern of
    Epetra's exporter.  n1-sized objects are small in the Schur regime,
    so the psum payload is a skinny block, not an m-sized array.
- **A11^{-1}** is a dense LU factored once host-side and *replicated* on
  every device - the same "redundant replicated compute" pattern as the
  k x k projected matrices (SURVEY.md section 5 names the replicated
  small dense solve as the accelerator-idiomatic stand-in for the reference's
  gather-to-serial KLU, SchurOperator.cpp:177-186).  Replication removes
  the reference's serial bottleneck from the critical path: every device
  advances the factorization locally with zero communication.

``distribute_schur(red, mesh)`` builds the operator from a host-side
``SchurReduction``; ``LyapunovSolver(op, bs, red.ms, mesh=mesh)`` then
runs the standard sharded iteration on it (``shard_operator`` passes
already-placed operators through).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from rails_tpu.operators import LinearOperator
from rails_tpu.parallel.mesh import ROW_AXIS, replicated, row_sharding

__all__ = ["DistributedSchurOperator", "distribute_schur", "pad_system"]


def _ell_arrays(a_scipy, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Row-ELL (indices, values) of a scipy matrix; padding slots carry
    index 0 with value 0 (harmless in both the gather and scatter
    applies).  Shared core lives in formats.ell_arrays_from_scipy."""
    from rails_tpu.sparse.formats import ell_arrays_from_scipy

    return ell_arrays_from_scipy(a_scipy, dtype, pad_row_local=False)


def _take_apply(idx, val, y):
    """(n2-row ELL) @ y for replicated y (n1, s): row-local gathers,
    result row-sharded with the indices."""
    out = jnp.zeros((idx.shape[0],) + y.shape[1:], dtype=y.dtype)
    for l in range(idx.shape[1]):
        out = out + val[:, l].reshape((-1,) + (1,) * (y.ndim - 1)) \
            * jnp.take(y, idx[:, l], axis=0)
    return out


def _scatter_apply_sharded(idx, val, x, n_out: int, mesh):
    """(n2-row ELL)' @ x for row-sharded x (n2, s): per-device local
    scatter-add into an (n_out, s) partial + one psum over the rows axis
    (Epetra transpose-SpMM export + MPI_Allreduce,
    /root/reference/src/Epetra_MultiVectorWrapper.cpp:418-438 pattern)."""
    s = x.shape[1]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(ROW_AXIS, None), P(ROW_AXIS, None), P(ROW_AXIS, None)),
        out_specs=P(),
        check_vma=False)
    def run(idx_l, val_l, x_l):
        contrib = val_l[:, :, None] * x_l[:, None, :]
        out = jnp.zeros((n_out, s), x.dtype)
        out = out.at[idx_l.reshape(-1)].add(
            contrib.reshape(-1, s))
        return jax.lax.psum(out, ROW_AXIS)

    return run(idx, val, x)


def pad_system(a, m, b, multiple: int):
    """Append decoupled stable dynamic rows so the DYNAMIC row count
    (nonzero diag(M)) becomes a multiple of ``multiple``.

    JAX shardings require the sharded dimension divisible by the mesh;
    the reference's Epetra maps have no such constraint, so arbitrary
    problem sizes need padding before a mesh run.  Padding rows carry
    a = -1, m = 1, b = 0: block-diagonal stable dynamics with zero
    forcing, whose Lyapunov solution block is exactly zero - the padded
    system's solution is X + 0 and the restriction to the original rows
    is the original solution.  Returns (a, m, b, n_pad)."""
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    m_sp = sp.csr_matrix(m)
    mdiag = np.asarray(m_sp.diagonal()).ravel()
    n2 = int(np.sum(np.abs(mdiag) >= 1e-12))
    pad = (-n2) % multiple
    if pad == 0:
        return a, m_sp, b, 0
    n = a.shape[0]
    a_pad = sp.block_diag(
        [a, -sp.eye(pad)], format="csr")
    m_pad = sp.block_diag([m_sp, sp.eye(pad)], format="csr")
    b_arr = np.asarray(b.todense()) if sp.issparse(b) else np.asarray(b)
    if b_arr.ndim == 1:
        b_arr = b_arr[:, None]
    b_pad = np.vstack([b_arr, np.zeros((pad, b_arr.shape[1]))])
    return a_pad, m_pad, b_pad, pad


@jax.tree_util.register_pytree_node_class
class DistributedSchurOperator(LinearOperator):
    """S = A22 - A21 A11^{-1} A12, matrix-free over a rows mesh.

    Mirrors SchurOperator::Apply pre-solution
    (/root/reference/src/SchurOperator.cpp:201-233) with the comm layout
    described in the module docstring.  ``already_placed`` makes
    ``shard_operator`` pass it through unchanged.
    """

    already_placed = True

    def __init__(self, a22_op, a21_idx, a21_val, a12t_idx, a12t_val,
                 lu, piv, n1: int, mesh, *, is_hurwitz=False,
                 _placed=False):
        if not _placed:
            rows = row_sharding(mesh)
            rep = replicated(mesh)
            a21_idx = jax.device_put(a21_idx, rows)
            a21_val = jax.device_put(a21_val, rows)
            a12t_idx = jax.device_put(a12t_idx, rows)
            a12t_val = jax.device_put(a12t_val, rows)
            lu = jax.device_put(lu, rep)
            piv = jax.device_put(piv, rep)
        self.a22 = a22_op
        self.a21_idx = a21_idx
        self.a21_val = a21_val
        self.a12t_idx = a12t_idx
        self.a12t_val = a12t_val
        self.lu = lu
        self.piv = piv
        self.n1 = n1
        self.mesh = mesh
        self.is_hurwitz = is_hurwitz

    @property
    def shape(self):
        return self.a22.shape

    @property
    def payload_dtype(self):
        return self.a21_val.dtype

    def _scatter(self, idx, val, x):
        return _scatter_apply_sharded(idx, val, x, self.n1, self.mesh)

    def _a11_solve(self, y, trans: int):
        # replicated dense LU apply on every device (redundant
        # replicated compute - the k x k pattern; no communication)
        return jax.scipy.linalg.lu_solve((self.lu, self.piv), y,
                                         trans=trans)

    def matmat(self, x):
        y1 = self._scatter(self.a12t_idx, self.a12t_val, x)   # A12 @ x
        y2 = self._a11_solve(y1, 0)                            # A11^{-1}
        y3 = _take_apply(self.a21_idx, self.a21_val, y2)       # A21 @ .
        return self.a22.matmat(x) - y3

    def rmatmat(self, x):
        # S' = A22' - A12' A11^{-T} A21'
        y1 = self._scatter(self.a21_idx, self.a21_val, x)      # A21' @ x
        y2 = self._a11_solve(y1, 1)                            # A11^{-T}
        y3 = _take_apply(self.a12t_idx, self.a12t_val, y2)     # A12' @ .
        return self.a22.rmatmat(x) - y3

    def astype(self, dtype):
        dt = jnp.dtype(dtype)
        if self.a21_val.dtype == dt:
            return self
        return DistributedSchurOperator(
            self.a22.astype(dtype), self.a21_idx,
            self.a21_val.astype(dtype), self.a12t_idx,
            self.a12t_val.astype(dtype), self.lu.astype(dtype),
            self.piv, self.n1, self.mesh, is_hurwitz=self.is_hurwitz,
            _placed=True)

    def tree_flatten(self):
        return ((self.a22, self.a21_idx, self.a21_val, self.a12t_idx,
                 self.a12t_val, self.lu, self.piv),
                (self.n1, self.mesh, self.is_hurwitz))

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        (obj.a22, obj.a21_idx, obj.a21_val, obj.a12t_idx, obj.a12t_val,
         obj.lu, obj.piv) = children
        obj.n1, obj.mesh, obj.is_hurwitz = aux
        return obj


def distribute_schur(red, mesh, *, fmt: str = "auto",
                     spmm: str = "auto") -> LinearOperator:
    """Place a host-side SchurReduction's operator on the mesh.

    ``red`` is a ``rails_tpu.schur.SchurReduction`` (built replicated on
    every process, the reference's redundant-host-work pattern); the
    returned operator runs the distributed apply described in the module
    docstring.  With an empty singular part (n1 = 0) this is just
    ``shard_operator`` on the plain A22.  The A11 factorization must be
    the dense LU (``a11_solver='dense_lu'``, the default) - the
    replicated-solve pattern needs concrete factors to place on the
    mesh; for other A11 solvers run single-controller, as the reference
    does for its serial KLU.  The dynamic row count n2 must be divisible
    by the mesh size (JAX shardings reject uneven slabs) - pad the
    system with ``pad_system`` first if it is not.
    """
    from rails_tpu.parallel.sharded import shard_operator
    from rails_tpu.sparse.formats import sparse_from_scipy

    if red.n1 == 0:
        return shard_operator(red.operator, mesh, spmm=spmm)
    nd = mesh.devices.size
    if red.n2 % nd:
        raise ValueError(
            f"dynamic row count n2={red.n2} is not divisible by the "
            f"mesh size {nd}; pad the system first "
            f"(rails_tpu.parallel.schur_dist.pad_system)")
    if red.a11_solver_kind != "dense_lu" or red._a11_lu is None:
        raise ValueError(
            "distribute_schur needs the dense-LU A11 factorization "
            "(a11_solver='dense_lu'); other A11 solvers are "
            "single-controller - run without the mesh")
    dtype = red.dtype
    a22_op = shard_operator(
        sparse_from_scipy(red._a22_scipy, fmt=fmt, dtype=dtype),
        mesh, spmm=spmm)
    a21_idx, a21_val = _ell_arrays(red._a21_scipy, dtype)
    a12t_idx, a12t_val = _ell_arrays(red._a12_scipy.T.tocsr(), dtype)
    lu, piv = red._a11_lu
    return DistributedSchurOperator(
        a22_op, a21_idx, a21_val, a12t_idx, a12t_val,
        jnp.asarray(lu, dtype=dtype), piv, red.n1, mesh,
        is_hurwitz=red.hurwitz)
