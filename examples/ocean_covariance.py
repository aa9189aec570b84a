"""End-to-end ocean-model covariance workflow (the reference's driving
application): load the DataErik MOC Jacobian, add the nullspace border,
Schur-reduce the singular mass matrix, solve the generalized Lyapunov
equation for the stationary covariance, and analyze its dominant modes.

Mirrors matlab/test/test_MOC.m + src/main.cpp of the reference.

Run (CPU):   python examples/ocean_covariance.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run as python examples/<name>.py

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import rails_tpu
from rails_tpu import io as rio
from rails_tpu.eigs import eigs
from rails_tpu.schur import schur_reduce


def main():
    print("Loading the MOC ocean problem (DataErik)...")
    a, m, b = rio.load_moc_problem()
    a2, m2, b2 = rio.add_border(a, m, b, rio.moc_border(a.shape[0]))

    print("Schur-reducing the singular mass matrix...")
    # the MOC Schur pencil is stable -> sign-iteration projected solves
    red = schur_reduce(a2, m2, b2, hurwitz=True)
    print(f"  dynamic dofs: {red.n2} of {red.n}")

    print("Solving A X M' + M X A' + B B' = 0 ...")
    v, t, info = rails_tpu.solve(
        red.operator, jnp.asarray(red.bs), red.ms, maxit=1000, tol=1e-3)
    print(f"  {'converged' if info.converged else 'NOT converged'} in "
          f"{info.iter} iterations, rank {v.shape[1]}, res {info.res:.2e}")

    print("Dominant covariance modes (eigenvalue / trace):")
    sop = red.solution_operator(v, t)
    evals, evecs = eigs(sop, num=6, tol=1e-6)
    trace = float(red.trace(v, t))
    for lam in np.asarray(evals):
        print(f"  {lam:14.6g}   {lam / trace:8.4f}")

    print("Lifting the basis to the full space...")
    v_full = red.vtrans(v)
    print(f"  V_full: {v_full.shape}")


if __name__ == "__main__":
    main()
