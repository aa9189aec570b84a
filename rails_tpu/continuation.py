"""Continuation runs: solve a sequence of similar Lyapunov problems.

The driving application of the reference is continuation of probability
density functions for ocean models (README.md:1-23): a sequence of
Jacobians A(theta_i) along a bifurcation branch, each Lyapunov solve warm
started from the previous one.  The reference supports this through the
MATLAB ``restart_data`` export/import (RAILSsolver.m:174-197,428-443) and
the C++ "Restart from solution" parameter; this module packages the loop:

    cont = ContinuationSolver(b, m=..., options)
    for a in jacobians:
        v, t, info = cont.step(a)

Each step reuses the previous step's converged subspace {V} as the
initial space (AV/VAV are recomputed against the *new* A, which is what
the warm start needs when A changes - matching the semantics of
restart_from_solution, tested at
/root/reference/test/LyapunovSolver_test.cpp:312-352).

Wall-clock design (warm starts must win on wall time, not only on
iterations): the carried basis is

1. **truncated to the dominant ``reduced_size`` eigenvectors of T**
   before re-entry (the compute_restart_vectors rotation,
   /root/reference/src/LyapunovSolver.hpp:449-482, applied host-side
   between steps).  Warm iterations then run at k ~ reduced_size
   instead of the full converged rank, and every warm step enters at
   the SAME k0, so the engine's capacity bucket - and the persistent
   compile cache - is shared across all warm steps;
2. **marked ``space_is_orthogonalized``**: it is a unitary rotation of
   an orthonormal converged basis, so the O(k0^2) per-column host
   re-orthonormalization (~10^4 eager device round-trips at k0~100)
   is skipped entirely.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from rails_tpu.core.options import SolverOptions
from rails_tpu.core.solver import LyapunovSolver

__all__ = ["ContinuationSolver"]


class ContinuationSolver:
    def __init__(self, b, m=None, options: Optional[SolverOptions] = None,
                 mesh=None, **opt_kwargs):
        self.b = b
        self.m = m
        self.mesh = mesh
        self.options = options or SolverOptions(**opt_kwargs)
        self._prev_space = None
        self.history = []
        # shared across steps: engines take payloads as jit arguments,
        # so step i+1 replays step i's compiled while_loop against the
        # new Jacobian with no retrace (see LyapunovSolver engine_cache)
        self._engine_cache = {}

    @staticmethod
    def _truncate_basis(v, t, reduced_size: int):
        """Rotate V onto the dominant-|lambda| eigenvectors of T and
        keep at most ``reduced_size`` columns (the restart rotation,
        LyapunovSolver.hpp:449-482, applied between steps).  Runs at
        highest matmul precision: a reduced-precision rotation of the
        basis would seed the next step's Gram blocks with noise that
        stalls the warm solve (core/solver.py _init_state)."""
        import jax
        import jax.numpy as jnp

        v = jnp.asarray(v)
        t = jnp.asarray(t)
        k = v.shape[1]
        if reduced_size <= 0 or k <= reduced_size:
            return np.asarray(v)
        with jax.default_matmul_precision("highest"):
            evals, evecs = jnp.linalg.eigh(0.5 * (t + t.T))
            order = jnp.argsort(-jnp.abs(evals))
            keep = evecs[:, order[:reduced_size]]
            return np.asarray(v @ keep)

    def step(self, a, b=None, m=None, compiled: bool = False):
        """Solve with the given operator, warm started from the last step."""
        import dataclasses

        warm = self._prev_space is not None
        # the carried basis is a unitary rotation of an orthonormal
        # converged basis: skip the per-column re-orthonormalization.
        # EXCEPT under M-orthogonalization with a per-step mass matrix:
        # the basis is orthonormal in the PREVIOUS M's inner product,
        # and feeding it through the skip path would leave the Gram
        # data inconsistent (round-5 review finding)
        basis_still_orthonormal = warm and not (
            self.options.ortho == "M" and m is not None)
        opts = dataclasses.replace(
            self.options,
            space=self._prev_space if warm else self.options.space,
            space_is_orthogonalized=basis_still_orthonormal
            or self.options.space_is_orthogonalized,
            restart_upon_start=warm or self.options.restart_upon_start,
        )
        solver = LyapunovSolver(a, b if b is not None else self.b,
                                m if m is not None else self.m,
                                options=opts, mesh=self.mesh,
                                engine_cache=self._engine_cache)
        v, t, info = solver.solve(compiled=compiled)
        self._prev_space = self._truncate_basis(
            v, t, self.options.reduced_size)
        self.history.append(info)
        return v, t, info

    def save(self, path: str) -> None:
        """Persist the continuation state (the last converged subspace)
        so a later process can resume the sequence - the on-disk form
        of MATLAB's in-memory restart_data (RAILSsolver.m:174-197)."""
        if self._prev_space is None:
            raise ValueError("no step has completed; nothing to save")
        from rails_tpu.io import save_restart_data

        save_restart_data(path, {"V": self._prev_space})

    def load(self, path: str) -> None:
        """Resume from a state written by ``save``: the next ``step``
        warm starts from the stored subspace."""
        from rails_tpu.io import load_restart_data

        self._prev_space = np.asarray(load_restart_data(path)["V"])
