"""Distributed Schur-complement solve - the reference's production
configuration (an MPI solve on the SchurOperator,
/root/reference/src/main.cpp:78-98) on a JAX device mesh.

Builds a random index-1 DAE (singular diagonal mass matrix), pads it to
the mesh geometry, reduces it to the dynamic block with a matrix-free
Schur complement whose A12/A21/A22 applies run DISTRIBUTED over the
rows mesh (A11's dense LU replicated on every device - the reference's
serial KLU as redundant replicated compute), solves the projected
Lyapunov equation, and checks the solve against the single-controller
path.

Run:  python examples/distributed_schur.py     (CPU: simulates 8
devices; on a pod slice the same code spans the real chips)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run as python examples/<name>.py

if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"
                               ).strip()

import jax

# default to the simulated-device CPU mesh (f64 oracle-grade); set
# RAILS_EXAMPLE_DEVICES=native to span the ambient accelerator devices
if os.environ.get("RAILS_EXAMPLE_DEVICES", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

import rails_tpu
from rails_tpu.parallel.mesh import make_mesh
from rails_tpu.parallel.schur_dist import distribute_schur, pad_system
from rails_tpu.schur import schur_reduce


def main():
    nd = len(jax.devices())
    print(f"devices: {nd} ({jax.default_backend()})")
    rng = np.random.default_rng(0)
    n = 240
    a = rng.uniform(-1, 1, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.2)
    a = sp.csr_matrix(a - 3.0 * np.eye(n))
    mdiag = rng.uniform(0.5, 1.5, n)
    mdiag[rng.permutation(n)[: n // 3]] = 0.0   # index-1 DAE structure
    m = sp.diags(mdiag).tocsr()
    b = rng.uniform(-1, 1, (n, 2))
    b[mdiag == 0] = 0.0

    # pad the dynamic row count to a mesh multiple (JAX shardings
    # reject uneven slabs; padding rows are decoupled, stable, and
    # zero-forced, so the padded solution block is exactly zero)
    a_p, m_p, b_p, n_pad = pad_system(a, m, b, nd)
    print(f"padded with {n_pad} rows for the {nd}-device mesh")

    red = schur_reduce(a_p, m_p, b_p)       # replicated host work
    print(f"Schur split: n1={red.n1} (algebraic), n2={red.n2} (dynamic)")

    mesh = make_mesh()
    s_dist = distribute_schur(red, mesh)
    print(f"distributed operator: {type(s_dist).__name__}")
    solver = rails_tpu.LyapunovSolver(
        s_dist, jnp.asarray(red.bs), red.ms, mesh=mesh,
        tol=1e-8, maxit=150)
    v, t, info = solver.solve()
    print(f"distributed solve: {info.iter} iterations, "
          f"residual {info.res:.2e}, rank {v.shape[1]}")

    # single-controller oracle
    v1, t1, info1 = rails_tpu.solve(
        red.operator, jnp.asarray(red.bs), red.ms, tol=1e-8, maxit=150)
    print(f"single-controller:  {info1.iter} iterations, "
          f"residual {info1.res:.2e}")
    assert info.iter == info1.iter

    # true residual of the distributed solve in the reduced space
    s_dense = np.asarray(red.operator.matmat(jnp.eye(red.n2)))
    msd = np.diag(np.asarray(red.ms_diag))
    x = np.asarray(v) @ np.asarray(t) @ np.asarray(v).T
    r = s_dense @ x @ msd + msd @ x @ s_dense.T \
        + np.asarray(red.bs) @ np.asarray(red.bs).T
    rel = np.linalg.norm(r, 2) / np.linalg.norm(
        np.asarray(red.bs).T @ np.asarray(red.bs), 2)
    print(f"true relative residual: {rel:.2e}")
    assert rel < 1e-7
    print("ok")


if __name__ == "__main__":
    main()
