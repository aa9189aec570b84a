"""Command-line driver - the reference's MPI driver (src/main.cpp)
re-imagined for single-controller JAX.

Usage:
    python -m rails_tpu.cli [--params params.xml|json] [--platform cpu|gpu]
                            [--only-eigenvalues] [--distributed] [directory]

Reads A.mtx / B.mtx / M.mtx from the directory (main.cpp:62-72), builds
the Schur reduction for the singular mass matrix (main.cpp:78-88), solves
the Lyapunov equation (main.cpp:118), checkpoints V.mtx / T.mtx
(main.cpp:123-126; reloadable with --only-eigenvalues, :128-138), then
computes the dominant eigenpairs of the full-space solution operator and
the trace-normalized spectrum table (main.cpp:140-170), and dumps the
profiler (main.cpp:172-173).

``--distributed`` is the multi-process production posture of the
reference's MPI driver (mpirun + Epetra maps, main.cpp:43-50): one
process per host, ``jax.distributed`` wiring the global device view
(parallel/multihost.py).  Every process parses the MatrixMarket files
(the replicated-host-work pattern of the reference's redundant k x k
compute); the solver state and operator payloads are placed row-sharded
over the global mesh, B through per-process row slabs
(``make_global_array``).  Singular-M (DAE/Schur) problems run the
distributed SchurOperator (parallel/schur_dist.py) - the reference
driver's production configuration (main.cpp:78-98) - with the A11
dense LU replicated on every device.  Post-processing: the direct
(nonsingular-M) path runs eigs over the row-sharded V with no host
gather (the reference's distributed Anasazi posture, main.cpp:140-170);
the Schur path's FULL-SPACE solution operator mixes the replicated
algebraic block with the sharded dynamic block, so its eigenanalysis
still runs replicated on the gathered V - quadratic-in-k, linear-in-m
host work, acceptable to production k (~100).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="rails-tpu",
        description="Low-rank Lyapunov solver in JAX (RAILS equivalent)")
    ap.add_argument("directory", nargs="?", default=".",
                    help="directory with A.mtx, B.mtx, M.mtx")
    ap.add_argument("--params", help="XML (Teuchos) or JSON parameter file")
    ap.add_argument("--platform", default=None,
                    help="force a JAX platform (cpu or gpu; default: "
                         "JAX's default backend)")
    ap.add_argument("--only-eigenvalues", action="store_true",
                    help="skip the solve; reload V.mtx/T.mtx")
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--maxit", type=int, default=None)
    ap.add_argument("--num-eigenvalues", type=int, default=None)
    ap.add_argument("--x64", action="store_true",
                    help="enable float64 (native on CPU and GPU)")
    ap.add_argument("--reorder", choices=["none", "rcm"], default="none",
                    help="symmetric bandwidth-reduction reordering before "
                         "the solve (DIA friendly; deterministic, "
                         "so --only-eigenvalues reloads stay consistent)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process SPMD run (one process per host); "
                         "see module docstring")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port (--distributed; "
                         "default $RAILS_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="process count (--distributed; default "
                         "$RAILS_NUM_PROCESSES)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's id (--distributed; default "
                         "$RAILS_PROCESS_ID)")
    ap.add_argument("--fmt", choices=["dia", "ell", "hyb"], default="ell",
                    help="sparse operator format for the direct "
                         "(non-Schur) distributed path")
    args = ap.parse_args(argv)

    import jax

    from rails_tpu.device import enable_compile_cache

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()

    mesh = None
    if args.distributed:
        from rails_tpu.parallel import multihost
        from rails_tpu.parallel.mesh import make_mesh

        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id)
        mesh = make_mesh()
        print(f"Distributed run: {jax.process_count()} processes, "
              f"{len(jax.devices())} global devices")

    import jax.numpy as jnp
    import numpy as np

    import rails_tpu
    from rails_tpu import io as rio
    from rails_tpu.config import (
        ParameterList,
        load_json_parameters,
        load_xml_parameters,
        solver_options_from_params,
    )
    from rails_tpu.eigs import eigs
    from rails_tpu.schur import schur_reduce
    from rails_tpu.timer import enable_profiling, save_profiles, timer

    enable_profiling()
    params = ParameterList()
    if args.params:
        loader = load_xml_parameters if args.params.endswith(".xml") \
            else load_json_parameters
        params = loader(args.params)

    d = args.directory
    print("Loading matrices")
    with timer("Driver", "load"):
        a = rio.read_matrix_market(os.path.join(d, "A.mtx"))
        b = rio.read_matrix_market(os.path.join(d, "B.mtx"))
        m = rio.read_matrix_market(os.path.join(d, "M.mtx"))

    if args.reorder == "rcm":
        from rails_tpu.sparse.reorder import (
            bandwidth, permute_system, rcm_permutation)

        bw0 = bandwidth(a)
        perm = rcm_permutation(a)
        a, m, b = permute_system(a, m, b, perm)
        print(f"RCM reordering: bandwidth {bw0} -> {bandwidth(a)}")

    red = None
    if mesh is not None:
        import scipy.sparse as sp_sparse

        from rails_tpu.parallel.schur_dist import pad_system
        from rails_tpu.sparse.formats import sparse_from_scipy

        # JAX shardings need the dynamic row count divisible by the
        # mesh; pad with decoupled stable zero-forced rows when it is
        # not (deterministic, so --only-eigenvalues reloads stay
        # consistent; the padded solution block is exactly zero)
        a, m, b, n_pad = pad_system(a, m, b, len(jax.devices()))
        if n_pad:
            print(f"Padded system with {n_pad} decoupled rows for the "
                  f"{len(jax.devices())}-device mesh")
        m_sp = sp_sparse.csr_matrix(m)
        mdiag = np.asarray(m_sp.diagonal()).ravel()
        if np.any(np.abs(mdiag) < 1e-12):
            # distributed Schur path - the reference driver's actual
            # production configuration (MPI solve on the SchurOperator,
            # /root/reference/src/main.cpp:78-98): the reduction is
            # built replicated on every process (redundant host work,
            # the k x k pattern), A12/A21/A22 applies are distributed,
            # and the A11 dense LU is replicated on every device (the
            # serial KLU of SchurOperator.cpp:177-186 as redundant
            # replicated compute)
            from rails_tpu.parallel.schur_dist import distribute_schur

            print("Computing Schur complement")
            with timer("Driver", "schur"):
                red = schur_reduce(a, m, b)
            if not args.only_eigenvalues:
                aop = distribute_schur(red, mesh, fmt=args.fmt)
                msop = red.ms
                bs = np.asarray(red.bs)
        else:
            # direct (non-Schur) distributed path: requires a DIAGONAL
            # M (the path builds a DiagonalOperator - silently dropping
            # off-diagonals would solve the wrong equation)
            off_diag = m_sp - sp_sparse.diags(mdiag)
            if off_diag.nnz and abs(off_diag).max() > 1e-14:
                raise SystemExit(
                    "--distributed currently supports diagonal mass "
                    "matrices only (M has off-diagonal entries; run "
                    "without --distributed)")
            if not args.only_eigenvalues:
                aop = sparse_from_scipy(sp_sparse.csr_matrix(a),
                                        fmt=args.fmt)
                msop = rails_tpu.DiagonalOperator(
                    jnp.asarray(mdiag), is_spd=bool(np.all(mdiag > 0)))
                bs = np.asarray(b.todense()) if sp_sparse.issparse(b) \
                    else np.asarray(b)
                if bs.ndim == 1:
                    bs = bs[:, None]
    else:
        print("Computing Schur complement")
        with timer("Driver", "schur"):
            red = schur_reduce(a, m, b)

    overrides = {}
    if args.tol is not None:
        overrides["tol"] = args.tol
    if args.maxit is not None:
        overrides["maxit"] = args.maxit
    opts = solver_options_from_params(
        params.sublist("Lyapunov Solver"), **overrides)

    v_path = os.path.join(d, "V.mtx")
    t_path = os.path.join(d, "T.mtx")
    proc0 = jax.process_index() == 0
    if not args.only_eigenvalues:
        print("Creating solver")
        if mesh is not None:
            from rails_tpu.parallel import multihost

            # per-process row-slab placement of B (the Epetra distributed
            # MatrixMarket-load pattern, /root/reference/src/main.cpp:66-68):
            # each process contributes only its slab of rows
            nproc = jax.process_count()
            rows = bs.shape[0]
            if nproc > 1 and rows % nproc == 0:
                slab = rows // nproc
                pid = jax.process_index()
                b_arr = multihost.make_global_array(
                    jnp.asarray(bs[pid * slab:(pid + 1) * slab]), mesh)
            else:
                b_arr = jnp.asarray(bs)
            solver = rails_tpu.LyapunovSolver(
                aop, b_arr, msop, options=opts, mesh=mesh)
            # narrate the distributed dispatch (halo fast path vs GSPMD)
            print(f"Distributed operator: {type(solver.A).__name__}")
        else:
            solver = rails_tpu.LyapunovSolver(
                red.operator, jnp.asarray(red.bs), red.ms, options=opts)
        print("Performing solve")
        if red is not None:
            print(f"Amount of matrix-vector products before the solve: "
                  f"{red.mvps}")
        v, t, info = solver.solve()
        print(f"Amount of matrix-vector products after the solve: "
              f"{info.mvps}")
        outcome = "converged" if info.converged else "did not converge"
        print(f"Solver {outcome} in {info.iter} iterations, "
              f"relative residual {info.res:.3e}, space size {v.shape[1]}")
        v_dev = v  # keep the (possibly row-sharded) device V: the
        # eigenvalue phase runs on it WITHOUT a host gather (the gather
        # below serves only the rank-0 checkpoint write)
        if mesh is not None and jax.process_count() > 1:
            from jax.experimental import multihost_utils

            v = jnp.asarray(
                multihost_utils.process_allgather(v, tiled=True))
        with timer("Driver", "checkpoint"):
            if proc0:  # rank-0 write, like the reference's profile dump
                rio.write_matrix_market(v_path, np.asarray(v))
                rio.write_matrix_market(t_path, np.asarray(t))
    else:
        print("Reloading V.mtx / T.mtx")
        v = jnp.asarray(rio.read_matrix_market(v_path))
        t = jnp.asarray(rio.read_matrix_market(t_path))
        v_dev = None  # reloaded host-side; post-processing runs replicated

    eig_params = params.sublist("Eigenvalue Solver")
    num = args.num_eigenvalues or int(
        eig_params.get("Number of Eigenvalues", 10))

    print("Computing eigenvalues of the solution operator")
    with timer("Driver", "eigenvalues"):
        eig_mesh = None
        if red is None and mesh is not None and v_dev is not None:
            # distributed post-processing: the reference's Anasazi
            # eigensolve runs on the distributed solution operator
            # across all ranks (/root/reference/src/main.cpp:140-170).
            # X = (V T) V' as a LowRankOperator over the row-sharded V -
            # the apply is local GEMM + psum under GSPMD, the Krylov
            # basis is row-sharded inside eigs, and V is never gathered
            # for this phase.
            from rails_tpu.operators import LowRankOperator

            sop = LowRankOperator(v_dev @ jnp.asarray(t), v_dev)
            eig_mesh = mesh
        elif red is None:
            # direct path, single-controller (or V reloaded from disk):
            # X = V T V', applied factored (replicated small compute on
            # every process, the reference's k x k pattern)
            from rails_tpu.operators import CallableOperator

            v_h, t_h = jnp.asarray(v), jnp.asarray(t)
            sop = CallableOperator(
                lambda x: v_h @ (t_h @ (v_h.T @ x)),
                (v_h.shape[0], v_h.shape[0]), is_symmetric=True)
        else:
            sop = red.solution_operator(v, t)
        # Anasazi BlockKrylovSchurSolMgr parameter names pass through
        # (the reference forwards the whole "Eigenvalue Solver" sublist,
        # /root/reference/src/Epetra_OperatorWrapper.cpp:163-186)
        bsz = int(eig_params.get("Block Size", 1))
        nblocks = eig_params.get("Num Blocks")  # subspace = bsz * blocks
        evals, _ = eigs(
            sop, num=num,
            tol=float(eig_params.get("Convergence Tolerance", 1e-6)),
            block_size=bsz,
            max_restarts=int(eig_params.get("Maximum Restarts", 100)),
            subspace=None if nblocks is None else bsz * int(nblocks),
            mesh=eig_mesh)

    with timer("Driver", "trace"):
        # direct path: tr(V T V') = tr(T) for orthonormal V
        trace = float(jnp.trace(t)) if red is None else float(
            red.trace(v, t))

    print(f"{'eigenvalue':>20}{'eigenvalue/trace':>20}")
    for lam in np.asarray(evals):
        print(f"{lam:>20.12g}{lam / trace:>20.12g}")

    if proc0:  # rank-0 only, /root/reference/src/main.cpp:172-173
        save_profiles()
    return 0


if __name__ == "__main__":
    sys.exit(main())
