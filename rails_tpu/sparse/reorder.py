"""Bandwidth-reduction reordering.

The DIA format is the fast path for banded/stencil sparsity; a
general sparse matrix becomes DIA-friendly after a symmetric permutation
that clusters the nonzeros around the main diagonal.  Reverse Cuthill-McKee
on the symmetrized pattern is the classic choice; a Lyapunov problem is
equivariant under symmetric permutations (solve P A P', P M P', P B and
map the low-rank factor back with V = P' V_perm), so reordering is purely
a performance transform.

The reference has no analogue - Epetra's CSR SpMV is
ordering-insensitive on CPUs, but here the diagonal structure decides
whether the SpMM runs on shifted slices (DIA) or gathers (ELL), and how
wide a row slab's halo is on a mesh.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

__all__ = ["rcm_permutation", "bandwidth", "n_diagonals", "permute_system"]


def rcm_permutation(a: sp.spmatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the symmetrized pattern.

    Returns ``perm`` such that ``a[perm][:, perm]`` has (near-)minimal
    bandwidth.
    """
    a = sp.csr_matrix(a)
    pattern = ((a != 0) + (a.T != 0)).astype(np.int8)
    return np.asarray(
        sp.csgraph.reverse_cuthill_mckee(pattern.tocsr(), symmetric_mode=True),
        dtype=np.int64)


def bandwidth(a: sp.spmatrix) -> int:
    """max |i - j| over stored nonzeros."""
    coo = sp.coo_matrix(a)
    if coo.nnz == 0:
        return 0
    return int(np.max(np.abs(coo.row - coo.col)))


def n_diagonals(a: sp.spmatrix) -> int:
    """Number of distinct nonzero diagonals (the DIA payload height)."""
    coo = sp.coo_matrix(a)
    if coo.nnz == 0:
        return 0
    return len(np.unique(coo.col - coo.row))


def permute_system(a, m, b, perm) -> Tuple[sp.csr_matrix, sp.csr_matrix,
                                           np.ndarray]:
    """Apply a symmetric permutation to a Lyapunov system (A, M, B).

    Solves of the permuted system relate to the original by
    ``X = P' X_perm P``, i.e. ``V = V_perm[argsort(perm)]``.
    """
    perm = np.asarray(perm)
    a = sp.csr_matrix(a)[perm][:, perm].tocsr()
    if m is not None:
        m = sp.csr_matrix(m)[perm][:, perm].tocsr()
    if b is not None:
        b = np.asarray(b.todense() if sp.issparse(b) else b)
        b = b[perm]
    return a, m, b
