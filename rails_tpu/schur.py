"""Schur-complement preprocessing for singular mass matrices (L4).

Ocean-model Jacobians are index-2 DAEs: most fields have no time
derivative, so diag(M) is mostly zero.  The reference reduces the problem
to the nonsingular part via a matrix-free Schur complement
(C++ SchurOperator, /root/reference/src/SchurOperator.cpp; MATLAB
RAILSschur, /root/reference/matlab/RAILSschur.m):

    split by |diag(M)| < tol into parts 1 (singular) and 2 (dynamic);
    S x = A22 x - A21 A11^{-1} A12 x ;  MS = M22 ;  BS = B2 (restricted)

and RAILSsolver runs on (S, MS, BS).  The design here:

- the index split, submatrix extraction, and border augmentation happen
  host-side (scipy), once;
- A12/A21/A22 become device sparse operators (ELL), and the A11 solve -
  the reference's serial KLU bottleneck - is *pluggable*
  (``a11_solver``): 'dense_lu' (default) factors A11 densely on device
  once (jittable lu_solve applies as dense GEMMs; the right call for the
  moderate A11 sizes of the reference's problem class), 'native_lu' uses
  our C++ Gilbert-Peierls LU through a host callback (the KLU-equivalent
  for very sparse/large A11), 'iterative' runs Jacobi-preconditioned
  BiCGStab on the device SpMM kernel (the scalable O(nnz) option the
  reference lacks - its KLU gathers to one rank,
  SchurOperator.cpp:177-186), or any user callable (mirroring MATLAB's
  opts.Ainv contract).

Post-solution analysis (solution operator application for eigenvalue
extraction + trace, C++ SchurOperator::Apply(hasSolution)/Trace,
SchurOperator.cpp:235-342) is implemented on SchurReduction as well.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from rails_tpu.operators import CallableOperator, LinearOperator
from rails_tpu.sparse.formats import SparseOperator, sparse_from_scipy

__all__ = ["SchurReduction", "schur_reduce"]


class SchurReduction:
    """Holds the reduced operators; use .operator/.ms/.bs with the solver."""

    def __init__(self, a, m, b, *, a11_solver="dense_lu", singular_tol=1e-12,
                 dtype=None, fmt="ell", hurwitz=False, factorize_sinv=False,
                 a11_tol=None, a11_maxiter=500):
        self.a11_tol = a11_tol
        self.a11_maxiter = a11_maxiter
        self.hurwitz = hurwitz
        if dtype is None:
            dtype = jnp.asarray(0.0).dtype
        self.dtype = dtype
        a = sp.csr_matrix(a)
        n = a.shape[0]
        if sp.issparse(m):
            mdiag = np.asarray(m.diagonal()).ravel()
        else:
            m = np.asarray(m)
            mdiag = np.diag(m) if m.ndim == 2 else m
        # index split (RAILSschur.m:23-24; C++ SchurOperator.cpp:73-94)
        self.idx1 = np.flatnonzero(np.abs(mdiag) < singular_tol)
        self.idx2 = np.flatnonzero(np.abs(mdiag) >= singular_tol)
        self.n = n
        self.n1 = len(self.idx1)
        self.n2 = len(self.idx2)

        a11 = a[self.idx1][:, self.idx1].tocsr()
        a12 = a[self.idx1][:, self.idx2].tocsr()
        a21 = a[self.idx2][:, self.idx1].tocsr()
        a22 = a[self.idx2][:, self.idx2].tocsr()
        self._a_scipy = a
        self._a11_scipy = a11
        # kept for distribute_schur (parallel/schur_dist.py), which
        # rebuilds mesh-layout payloads from the host submatrices
        self._a12_scipy = a12
        self._a21_scipy = a21
        self._a22_scipy = a22
        self.A12 = sparse_from_scipy(a12, fmt=fmt, dtype=dtype)
        self.A21 = sparse_from_scipy(a21, fmt=fmt, dtype=dtype)
        self.A22 = sparse_from_scipy(a22, fmt=fmt, dtype=dtype)

        self._setup_a11(a11_solver)

        self.ms_diag = jnp.asarray(mdiag[self.idx2], dtype=dtype)

        b = np.asarray(b.todense()) if sp.issparse(b) else np.asarray(b)
        if b.ndim == 1:
            b = b[:, None]
        if np.abs(b[self.idx1]).max(initial=0.0) > np.sqrt(
                np.finfo(np.float64).eps):
            # BS = B2 - A21 A11^{-1} B1 (RAILSschur.m:46-49)
            warnings.warn("B is not zero in the singular part",
                          stacklevel=2)
            b1 = jnp.asarray(b[self.idx1], dtype=dtype)
            b2 = jnp.asarray(b[self.idx2], dtype=dtype)
            self.bs = np.asarray(b2 - self.A21.matmat(self.a11_solve(b1)))
        else:
            self.bs = b[self.idx2]
        self.mvps = 0
        self._sinv_factors = None
        self._sinv_native = None
        if factorize_sinv:
            # MATLAB RAILSschur(A, M, B, true) pre-factorizes the whole-A
            # LU used by Sinv at reduction time (RAILSschur.m:51-64)
            self.sinv()

    # -- A11 solver plumbing ------------------------------------------------
    def _setup_a11(self, a11_solver):
        self.a11_solver_kind = (
            a11_solver if isinstance(a11_solver, str) else "custom")
        self._a11_lu = None  # (lu, piv) when dense_lu; distribute_schur
        if callable(a11_solver):
            self.a11_solve = a11_solver
            self.a11_solve_t = getattr(a11_solver, "transpose_solve", None)
            return
        if a11_solver == "dense_lu":
            a11_dense = jnp.asarray(self._a11_scipy.toarray(),
                                    dtype=self.dtype)
            lu, piv = jax.scipy.linalg.lu_factor(a11_dense)
            self._a11_lu = (lu, piv)

            def solve(x, lu=lu, piv=piv):
                return jax.scipy.linalg.lu_solve((lu, piv), x)

            def solve_t(x, lu=lu, piv=piv):
                return jax.scipy.linalg.lu_solve((lu, piv), x, trans=1)

            self.a11_solve = solve
            self.a11_solve_t = solve_t
        elif a11_solver == "native_lu":
            from rails_tpu.native.host_lib import NativeSparseLU

            lu = NativeSparseLU(self._a11_scipy)
            n1, dtype = self.n1, self.dtype

            def solve(x, lu=lu):
                def cb(xh):
                    return lu.solve(np.asarray(xh, dtype=np.float64)).astype(xh.dtype)
                return jax.pure_callback(
                    cb, jax.ShapeDtypeStruct(x.shape, x.dtype), x,
                    vmap_method="sequential")

            def solve_t(x, lu=lu):
                def cb(xh):
                    return lu.solve(np.asarray(xh, dtype=np.float64),
                                    trans=True).astype(xh.dtype)
                return jax.pure_callback(
                    cb, jax.ShapeDtypeStruct(x.shape, x.dtype), x,
                    vmap_method="sequential")

            self.a11_solve = solve
            self.a11_solve_t = solve_t
        elif a11_solver == "iterative":
            # The scalable device-side option (SURVEY §7.5): neither the
            # dense LU (O(n1^2) memory) nor the serial host LU (the
            # reference's own KLU ceiling, SchurOperator.cpp:177-186)
            # survives large n1.  A Jacobi-preconditioned BiCGStab whose
            # matvec is the device SpMM kernel does: O(nnz) memory,
            # jittable, and row-shardable like every other operator.
            # Suited to diagonally-dominant / elliptic A11 blocks; saddle
            # -structured A11 (zero diagonals) should keep a direct
            # method or pass a preconditioned callable.
            a11_op = sparse_from_scipy(self._a11_scipy, dtype=self.dtype)
            d = np.asarray(self._a11_scipy.diagonal())
            safe = np.where(np.abs(d) > 1e-30, d, 1.0)
            dinv = jnp.asarray(1.0 / safe, dtype=self.dtype)
            tol = self.a11_tol
            if tol is None:
                # f32: 30*eps (~3.6e-6 relative) routinely stagnates in
                # BiCGStab's f32 recurrences; 1e-5 is attainable and
                # still far below the outer solver's targets (ADVICE
                # r02).  f64 keeps the tight 30*eps default.
                tol = 30 * float(jnp.finfo(self.dtype).eps)
                if jnp.dtype(self.dtype) == jnp.float32:
                    tol = max(tol, 1e-5)
            maxiter = self.a11_maxiter

            def _bicgstab(matvec, x):
                def precond(r):
                    return r * dinv.reshape((-1,) + (1,) * (r.ndim - 1))

                y, _ = jax.scipy.sparse.linalg.bicgstab(
                    matvec, x, tol=tol, maxiter=maxiter, M=precond)
                return y

            self.a11_solve = lambda x: _bicgstab(a11_op.matmat, x)
            self.a11_solve_t = lambda x: _bicgstab(a11_op.rmatmat, x)
            self._a11_op = a11_op
            self._a11_tol_eff = tol
        else:
            raise ValueError(f"unknown a11_solver {a11_solver!r}")

    def a11_residual_check(self, x=None, warn: bool = True):
        """Relative residual ||A11 y - x|| / ||x|| of one forward and one
        transpose A11 solve on a probe vector.

        The iterative A11 path (Jacobi-BiCGStab) returns its last
        iterate even when stagnated, which would otherwise surface only
        as misattributed outer-solver non-convergence (ADVICE r02).
        Call this after construction (and after any problem update) to
        confirm the solver meets its tolerance; a warning is raised when
        it does not.  Works for every a11_solver kind."""
        import warnings as _warnings

        n1 = self.n1
        if x is None:
            x = jnp.asarray(np.random.default_rng(0).uniform(-1, 1, (n1, 1)),
                            dtype=self.dtype)
        a11 = self._a11_scipy
        xh = np.asarray(x, np.float64)
        y = np.asarray(self.a11_solve(x), np.float64)
        res = float(np.linalg.norm(a11 @ y - xh) / np.linalg.norm(xh))
        res_t = None
        if self.a11_solve_t is not None:
            yt = np.asarray(self.a11_solve_t(x), np.float64)
            res_t = float(np.linalg.norm(a11.T @ yt - xh)
                          / np.linalg.norm(xh))
        tol = getattr(self, "_a11_tol_eff", None)
        if warn and tol is not None:
            worst = max(res, res_t if res_t is not None else 0.0)
            if worst > 10 * tol:
                _warnings.warn(
                    f"iterative A11 solve residual {worst:.2e} exceeds "
                    f"10x its tolerance {tol:.2e}; increase a11_maxiter, "
                    f"loosen a11_tol, or use a direct a11_solver",
                    RuntimeWarning)
        return res, res_t

    # -- the reduced operators ---------------------------------------------
    @property
    def operator(self) -> LinearOperator:
        """S = A22 - A21 A11^{-1} A12, matrix-free
        (SchurOperator::Apply pre-solution, SchurOperator.cpp:201-233).
        With an empty singular part (nonsingular M: n1 = 0) the
        correction term vanishes and S = A22 = A - returned as the
        concrete SparseOperator (payload type intact for shard_operator
        halo dispatch / payload-as-argument engines), with the hurwitz
        tag applied."""
        if self.n1 == 0:
            op = self.A22
            if self.hurwitz and not op.is_hurwitz:
                op = SparseOperator(
                    op.fwd, op.bwd, is_symmetric=op.is_symmetric,
                    is_spd=op.is_spd, is_hurwitz=True, nnz=op.nnz)
            return op

        def apply(x):
            return self.A22.matmat(x) - self.A21.matmat(
                self.a11_solve(self.A12.matmat(x)))

        def apply_t(x):
            return self.A22.rmatmat(x) - self.A12.rmatmat(
                self.a11_solve_t(self.A21.rmatmat(x)))

        return CallableOperator(apply, (self.n2, self.n2), rfn=apply_t,
                                is_hurwitz=self.hurwitz)

    @property
    def ms(self):
        from rails_tpu.operators import DiagonalOperator

        return DiagonalOperator(self.ms_diag)

    def sinv(self, method: str = "dense_lu") -> Callable:
        """x -> S^{-1} x via a full-A solve with the reorder trick
        (RAILSschur.m:57-64): solve A z = P' [0; x], return z[idx2].

        ``method='dense_lu'`` factors A densely on device (cached; GEMM
        applies).  ``method='native_lu'`` uses the C++ Gilbert-Peierls
        sparse LU via a host callback - the scalable choice when A is
        large and sparse (the role of MATLAB's sparse ``lu`` at
        RAILSschur.m:31-33)."""
        if method == "native_lu":
            if self._sinv_native is None:
                from rails_tpu.native.host_lib import NativeSparseLU

                self._sinv_native = NativeSparseLU(self._a_scipy.tocsr())
            lu = self._sinv_native
            idx2_np = self.idx2
            n = self.n

            def solve_native(x, lu=lu, idx2_np=idx2_np, n=n):
                def cb(xh):
                    rhs = np.zeros((n,) + xh.shape[1:], dtype=np.float64)
                    rhs[idx2_np] = np.asarray(xh, dtype=np.float64)
                    return lu.solve(rhs)[idx2_np].astype(xh.dtype)

                return jax.pure_callback(
                    cb, jax.ShapeDtypeStruct(x.shape, x.dtype), x,
                    vmap_method="sequential")

            return solve_native
        if method != "dense_lu":
            raise ValueError(f"unknown sinv method {method!r}")
        if self._sinv_factors is None:
            a_dense = jnp.asarray(self._a_scipy.toarray(), dtype=self.dtype)
            self._sinv_factors = jax.scipy.linalg.lu_factor(a_dense)
        lu, piv = self._sinv_factors
        idx2 = jnp.asarray(self.idx2)

        def solve(x):
            rhs = jnp.zeros((self.n,) + x.shape[1:], dtype=x.dtype)
            rhs = rhs.at[idx2].set(x)
            z = jax.scipy.linalg.lu_solve((lu, piv), rhs)
            return z[idx2]

        return solve

    # -- full-space transforms ---------------------------------------------
    def restrict(self, x):
        """Full space -> reduced: x2 - A21 A11^{-1} x1 (RAILSschur.m:68-70)."""
        x = jnp.asarray(x, dtype=self.dtype)
        x1 = x[jnp.asarray(self.idx1)]
        x2 = x[jnp.asarray(self.idx2)]
        return x2 - self.A21.matmat(self.a11_solve(x1))

    def prolongate(self, x):
        """Reduced -> full space: reorder([-A11^{-1} A12 x; x])
        (RAILSschur.m:72-74)."""
        x = jnp.asarray(x, dtype=self.dtype)
        x1 = -self.a11_solve(self.A12.matmat(x))
        out = jnp.zeros((self.n,) + x.shape[1:], dtype=x.dtype)
        out = out.at[jnp.asarray(self.idx1)].set(x1)
        out = out.at[jnp.asarray(self.idx2)].set(x)
        return out

    def vtrans(self, v):
        """MATLAB Vtrans: restrict or prolongate by row count."""
        v = jnp.asarray(v)
        if v.shape[0] == self.n:
            return self.restrict(v)
        if v.shape[0] == self.n2:
            return self.prolongate(v)
        raise ValueError(f"size of v = {v.shape[0]}")

    # -- post-solution analysis --------------------------------------------
    def solution_operator(self, v, t) -> LinearOperator:
        """The full-space solution operator X_full reconstructed from
        X22 ~= V T V' (SchurOperator::Apply with hasSolution_,
        SchurOperator.cpp:235-296), for eigenvalue analysis:

          X22 = V T V',  X12 = -A11^{-1} A12 X22,  X21 = X12',
          X11 = A11^{-1} A12 X22 A12' A11^{-T}.
        """
        v = jnp.asarray(v, dtype=self.dtype)
        t = jnp.asarray(t, dtype=self.dtype)
        idx1 = jnp.asarray(self.idx1)
        idx2 = jnp.asarray(self.idx2)

        def x22(x2):
            return v @ (t @ (v.T @ x2))

        if self.n1 == 0:
            # nonsingular M: the full space IS the reduced space
            return CallableOperator(x22, (self.n, self.n),
                                    is_symmetric=True)

        def apply(x):
            x = jnp.asarray(x)
            x1 = x[idx1]
            x2 = x[idx2]
            x22x = x22(x2)
            x12x = -self.a11_solve(self.A12.matmat(x22x))
            x21x = -x22(self.A12.rmatmat(self.a11_solve_t(x1)))
            x11x = -self.a11_solve(self.A12.matmat(x21x))
            out = jnp.zeros_like(x)
            out = out.at[idx1].set(x11x + x12x)
            out = out.at[idx2].set(x22x + x21x)
            return out

        return CallableOperator(apply, (self.n, self.n), is_symmetric=True)

    def trace(self, v, t) -> jax.Array:
        """tr(X_full) = tr(T) + tr(T V' A12' A11^{-T} A11^{-1} A12 V)
        (SchurOperator::Trace, SchurOperator.cpp:298-342)."""
        v = jnp.asarray(v, dtype=self.dtype)
        t = jnp.asarray(t, dtype=self.dtype)
        if self.n1 == 0:  # nonsingular M: tr(X_full) = tr(T)
            return jnp.trace(t)
        w = self.a11_solve(self.A12.matmat(v))
        g = v.T @ self.A12.rmatmat(self.a11_solve_t(w))
        return jnp.trace(t) + jnp.trace(t @ g)


def schur_reduce(a, m, b, **kw) -> SchurReduction:
    """RAILSschur equivalent: returns a SchurReduction; solve with
    ``rails_tpu.solve(red.operator, red.bs, red.ms, ...)`` and map the
    basis back with ``red.vtrans(V)``."""
    return SchurReduction(a, m, b, **kw)
