"""Continuation sequence with warm starts and on-disk checkpointing.

The driving application of the reference is continuation of probability
density functions along a bifurcation branch (README.md:1-23): a
sequence of Jacobians A(theta_i), each Lyapunov solve warm started from
the previous converged subspace (MATLAB restart_data,
/root/reference/matlab/RAILSsolver.m:174-197).

This example solves a 3-step sequence on a generalized 2D-Laplacian
problem, prints the cold-vs-warm iteration counts, then demonstrates
resuming the sequence in a "fresh process" from a checkpoint file.

Run:  python examples/continuation_sequence.py  (CPU or GPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run as python examples/<name>.py
import os
import tempfile
import time

import numpy as np
import scipy.sparse as sp

import jax

jax.config.update("jax_enable_x64", True)  # f64 is native on CPU and GPU

import jax.numpy as jnp

import rails_tpu
from rails_tpu.continuation import ContinuationSolver
from rails_tpu.sparse.formats import sparse_from_scipy

dtype = jnp.float64
n = 1024
side = int(np.sqrt(n))
rng = np.random.default_rng(0)
md = jnp.asarray(rng.uniform(0.5, 1.5, n), dtype=dtype)
b = jnp.asarray(rng.uniform(0, 1, (n, 8)), dtype=dtype)


def jacobian(theta):
    """A(theta): reaction-term sweep over the same sparsity."""
    lap = sp.kron(sp.eye(side),
                  sp.diags([1.0, -4.0 - theta, 1.0], [-1, 0, 1],
                           (side, side))) \
        + sp.kron(sp.diags([1.0, 1.0], [-1, 1], (side, side)),
                  sp.eye(side))
    return sparse_from_scipy(lap.tocsr(), fmt="dia", dtype=dtype,
                             is_symmetric=True)


cont = ContinuationSolver(b, rails_tpu.DiagonalOperator(md),
                          tol=1e-4, dtype=dtype, expand=6,
                          restart_size=120, reduced_size=60, maxit=200)

print(f"{'theta':>8}{'iters':>8}{'residual':>12}{'wall':>8}")
for theta in (0.0, 0.05, 0.1):
    t0 = time.perf_counter()
    v, t, info = cont.step(jacobian(theta), compiled=True)
    print(f"{theta:>8.2f}{info.iter:>8}{info.res:>12.2e}"
          f"{time.perf_counter() - t0:>7.1f}s")

# checkpoint the converged subspace and resume in a fresh solver (a new
# process would do exactly the same - the on-disk restart_data)
with tempfile.TemporaryDirectory() as d:
    ckpt = os.path.join(d, "continuation.npz")
    cont.save(ckpt)
    cont2 = ContinuationSolver(b, rails_tpu.DiagonalOperator(md),
                               tol=1e-4, dtype=dtype, expand=6,
                               restart_size=120, reduced_size=60,
                               maxit=200)
    cont2.load(ckpt)
    v, t, info = cont2.step(jacobian(0.15), compiled=True)
    print(f"resumed theta=0.15 from checkpoint: {info.iter} iterations "
          f"(warm), residual {info.res:.2e}")
