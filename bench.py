"""Benchmark harness for one GPU (or the CPU, for rehearsal).

Prints JSON lines; the LAST stdout line is a compact headline
{"metric", "value", "unit", "vs_baseline", ...}.  Every result line
names the platform, device kind, device count and power limit it was
measured on.

Headline metric: DIA SpMM throughput (nnz/s) on a large 2D-Laplacian
operator - the hot operation of the solver (the reference's Epetra
SpMM).  ``vs_baseline`` is the fraction of the device's published
memory-bandwidth roofline (rails_tpu.device.PEAKS); ``vs_stream`` the
fraction of the *measured* stream bandwidth (an XLA elementwise pass
over the same bytes).

Phases (each in its own subprocess, so one process holds the card):
    python bench.py --phase spmm
    python bench.py --phase solve       # n=4096 generalized solve, f32
    python bench.py --phase accuracy    # refined f32 solve to 1e-8
    python bench.py --phase ell         # unstructured SpMM + MOC solve
    python bench.py --phase hub         # power-law hub split vs COO
    python bench.py --phase continuation  # warm-start sequence
    python bench.py --phase scale       # n=65536 refined solve
    python bench.py --mesh              # multi-device halo comm artifact
    (add --cpu to any of the above for the 8-virtual-device CPU run;
    without it a device missing from the peaks table is an error)

The orchestrator (``python bench.py``) stays off JAX, runs the phases
most-important-first under a total wall-clock budget
(RAILS_BENCH_BUDGET_S, default 1380 s), prints the cumulative
consolidated line after every phase plus a compact (< ~1,500 chars)
headline line LAST, records per-phase errors in a "phases" field, and
exits non-zero if any phase failed.
"""

import json
import os
import subprocess
import sys
import time

_DEVICE = {}


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else None


def _jax_setup():
    """Initialize JAX for a phase.  Returns (jax, on_device, dev_kind,
    peak_bytes_per_s); also fills the device fields every result line
    carries.  Off the GPU only ``--cpu`` is accepted."""
    cpu = "--cpu" in sys.argv
    if cpu:
        # reproducible multi-device run on 8 virtual CPU devices
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from rails_tpu.device import device_peaks, enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    peaks = device_peaks(dev.device_kind, allow_cpu=cpu)
    _DEVICE.update(platform=dev.platform, device_kind=dev.device_kind,
                   device_count=len(jax.devices()),
                   power_limit=_power_limit(), peaks_source=peaks["source"])
    return jax, dev.platform != "cpu", dev.device_kind, \
        peaks["hbm_bytes_per_s"]


def _emit(out):
    """Print one result line with the device fields."""
    print(json.dumps(dict(out, **_DEVICE)), flush=True)


def _chain_time(fn, x0, total_fn, lo, hi, repeats=3):
    """Differenced chain timing (chain closes with a data-dependent
    readback; differencing removes fixed overhead).  Each chain length
    is min'd over repeats SEPARATELY, then differenced: min-of-
    differences is biased low whenever noise inflates a d_lo sample,
    while the min of each length strips outliers from both before the
    subtraction."""
    def chain(reps):
        y = x0
        t0 = time.perf_counter()
        for _ in range(reps):
            y = fn(y)
        float(total_fn(y))
        return time.perf_counter() - t0

    chain(lo)  # warm
    d_los, d_his = [], []
    for _ in range(repeats):
        d_los.append(chain(lo))
        d_his.append(chain(hi))
    return max(min(d_his) - min(d_los), 1e-9) / (hi - lo)


def phase_spmm() -> None:
    import numpy as np

    jax, on_device, dev_kind, bw = _jax_setup()
    import jax.numpy as jnp

    from rails_tpu.sparse.formats import DiaMatrix

    dtype = jnp.float32 if on_device else jnp.float64
    side = 1536 if on_device else 128
    m = side * side
    s = 16
    offsets = (-side, -1, 0, 1, side)
    rng = np.random.default_rng(0)
    # scaled so chained applies stay bounded; identical memory traffic
    data = jnp.asarray(rng.uniform(-1, 1, (len(offsets), m)),
                       dtype=dtype) * 0.12
    dia = DiaMatrix(data, offsets, (m, m))
    v = jnp.asarray(rng.uniform(-1, 1, (m, s)), dtype=dtype)

    apply_fn = jax.jit(dia.matmat)
    total_fn = jax.jit(lambda x: jnp.sum(jnp.abs(x)))
    print("spmm: compiling...", file=sys.stderr, flush=True)
    float(total_fn(apply_fn(v)))  # warm up (compile + run)
    print("spmm: timing...", file=sys.stderr, flush=True)
    lo, hi = (10, 60) if on_device else (2, 10)
    dt = _chain_time(apply_fn, v, total_fn, lo, hi, repeats=6)

    # measured stream ceiling: XLA elementwise over the same array
    stream_fn = jax.jit(lambda x: x * 0.999)
    float(total_fn(stream_fn(v)))
    dt_stream = _chain_time(stream_fn, v, total_fn, lo, hi, repeats=6)
    stream_gbs = 2 * m * s * jnp.dtype(dtype).itemsize / dt_stream / 1e9

    nnz = len(offsets) * m
    itemsize = jnp.dtype(dtype).itemsize
    bytes_ideal = (len(offsets) * m + 2 * m * s) * itemsize
    roofline = nnz * bw / bytes_ideal
    kernel_gbs = bytes_ideal / dt / 1e9
    _emit({
        "value": nnz / dt, "vs_baseline": (nnz / dt) / roofline,
        "spmm_rows": m, "spmm_cols": s, "spmm_ms": dt * 1e3,
        "roofline_nnz_per_s": roofline,
        "kernel_gbs": kernel_gbs, "stream_gbs": stream_gbs,
        "vs_stream": kernel_gbs / stream_gbs,
    })


def phase_ell() -> None:
    """Unstructured-sparsity SpMM (ELL gather) + the real-data MOC Schur
    solve, both on the live device.

    The banded-unstructured geometry (random per-row column picks within
    a +-64 band, L=8 slots) is the post-RCM shape of general matrices.
    MOC: the n=1536 DataErik ocean problem end-to-end
    (border, Schur reduction, solve to the reference's 1e-3 target,
    matlab/test/test_MOC.m:26-35)."""
    import numpy as np
    import scipy.sparse as sp

    jax, on_device, dev_kind, bw = _jax_setup()
    import jax.numpy as jnp

    from rails_tpu.sparse.formats import sparse_from_scipy

    dtype = jnp.float32 if on_device else jnp.float64
    m, ell_l, band, s = (1 << 21 if on_device else 1 << 14), 8, 64, 16
    rng = np.random.default_rng(0)
    base = np.arange(m)
    idx = np.clip(base[:, None] + rng.integers(-band, band + 1, (m, ell_l)),
                  0, m - 1)
    val = rng.uniform(-1, 1, (m, ell_l)) * 0.2
    a = sp.coo_matrix((val.ravel(), (np.repeat(base, ell_l), idx.ravel())),
                      shape=(m, m)).tocsr()
    op = sparse_from_scipy(a, fmt="ell", dtype=dtype)
    nnz = int(a.nnz)
    vt = jnp.asarray(rng.uniform(-1, 1, (m, s)), dtype=dtype)
    total_fn = jax.jit(lambda x: jnp.sum(jnp.abs(x)))

    out = {"ell_rows": m, "ell_slots": ell_l, "ell_nnz": nnz}
    kern_fn = jax.jit(lambda x: op.matmat(x))
    print("ell: compiling...", file=sys.stderr, flush=True)
    float(total_fn(kern_fn(vt)))
    lo, hi = (10, 60) if on_device else (2, 10)
    dt = _chain_time(kern_fn, vt, total_fn, lo, hi)
    out["ell_spmm_nnz_per_s"] = nnz / dt
    itemsize = jnp.dtype(dtype).itemsize
    bytes_ideal = (2 * ell_l * m + 2 * m * s) * itemsize
    out["ell_roofline_frac"] = (bytes_ideal / dt / 1e9) / (bw / 1e9)
    _emit(out)  # partial result survives a kill

    # MOC end-to-end (reference target: residual < 1e-3, test_MOC.m)
    try:
        import rails_tpu
        import rails_tpu.io as rio
        from rails_tpu.schur import schur_reduce

        a, mm, b = rio.load_moc_problem()
        a2, m2, b2 = rio.add_border(a, mm, b, rio.moc_border(a.shape[0]))
        t0 = time.perf_counter()
        red = schur_reduce(a2, m2, b2)
        v, t, info = rails_tpu.solve(
            red.operator, jnp.asarray(red.bs, dtype=dtype), red.ms,
            maxit=1000, tol=1e-3, dtype=dtype)
        moc_wall = time.perf_counter() - t0
        sv = np.asarray(red.operator.matmat(v))
        msd = np.asarray(red.ms_diag)
        vn, tn = np.asarray(v), np.asarray(t)
        bs = np.asarray(red.bs)
        svt = sv @ tn
        r = svt @ (vn * msd[:, None]).T
        r = r + r.T + bs @ bs.T
        out.update({
            "moc_wall_s": moc_wall, "moc_iters": int(info.iter),
            "moc_converged": bool(info.converged),
            "moc_res_fro": float(np.linalg.norm(r, "fro")),
            "moc_res_target": 1e-3,
        })
    except FileNotFoundError:
        out["moc_wall_s"] = None  # DataErik not mounted
    except Exception as e:  # noqa: BLE001 - keep the SpMM numbers
        out["moc_error"] = f"{type(e).__name__}: {e}"[:200]
    _emit(out)


def phase_solve() -> None:
    import numpy as np
    import scipy.sparse as sp

    jax, on_device, dev_kind, bw = _jax_setup()
    import jax.numpy as jnp

    import rails_tpu
    from rails_tpu.sparse.formats import sparse_from_scipy

    dtype = jnp.float32 if on_device else jnp.float64
    n = 4096 if on_device else 1024
    side = int(np.sqrt(n))
    rng = np.random.default_rng(0)
    lap = sp.kron(sp.eye(side),
                  sp.diags([1.0, -4.0, 1.0], [-1, 0, 1], (side, side))) \
        + sp.kron(sp.diags([1.0, 1.0], [-1, 1], (side, side)), sp.eye(side))
    aop = sparse_from_scipy(lap.tocsr(), fmt="dia", dtype=dtype,
                            is_symmetric=True)
    md = jnp.asarray(rng.uniform(0.5, 1.5, n), dtype=dtype)
    b = jnp.asarray(rng.uniform(0, 1, (n, 8)), dtype=dtype)
    # maxit 200 leaves >= 40% headroom over the ~120 iterations this
    # problem needs (converging on the last permitted iteration is one
    # seed away from a failed headline)
    solver = rails_tpu.LyapunovSolver(
        aop, b, rails_tpu.DiagonalOperator(md),
        tol=1e-4, dtype=dtype, expand=6,
        restart_size=120, reduced_size=60, maxit=200)

    def run():
        t0 = time.perf_counter()
        _, _, info = solver.solve(compiled=True)
        return time.perf_counter() - t0, info

    print("solve: compiling + first run...", file=sys.stderr, flush=True)
    warm, info = run()
    # partial line first: a phase timeout during the steady-state rerun
    # must not erase the converged first run
    out = {
        "solve_n": n, "solve_compile_wall_s": warm,
        "solve_iters": info.iter, "solve_converged": bool(info.converged),
        "solve_res": info.res, "solve_maxit": 200,
        "solve_iter_margin": (200 - info.iter) / 200,
    }
    _emit(out)
    print("solve: steady state...", file=sys.stderr, flush=True)
    wall, info = run()
    out.update({"solve_wall_s": wall, "solve_iters": info.iter,
                "solve_res": info.res})
    _emit(out)


def _steady_drop(n, n_drop_frac=0.25, chunk=8):
    """Leading entries to exclude from a cumulative wall vector: at
    least the whole first timevec chunk PLUS one entry.  Compile cost
    lands inside the first chunk and the per-iteration timevec is
    interpolated between chunk marks, so any entry before the second
    mark carries smeared compile time - a fraction-only drop leaves a
    short refined stage's fresh-compile wall inside its 'steady' tail."""
    return max(1, int(n * n_drop_frac), min(chunk + 1, n - 2))


def _steady_rate(timevec, n_drop_frac=0.25):
    """Steady-state seconds per RECORDED iteration from a cumulative
    wall vector, excluding the leading entries (see _steady_drop).
    Note SolveInfo.timevec is recvec-filtered (the iteration after a
    restart is unrecorded), so this is per recorded entry, not per
    info.iter iteration - use ``_steady_wall`` for whole-solve
    comparisons (multiplying this rate by info.iter inflates
    restart-heavy solves by their restart fraction)."""
    import numpy as np

    tv = np.asarray(timevec, dtype=float)
    n = len(tv)
    if n < 4:
        return tv[-1] / max(n, 1) if n else 0.0
    k0 = _steady_drop(n, n_drop_frac)
    return float((tv[-1] - tv[k0]) / (n - 1 - k0))


def _steady_wall(timevec, n_drop_frac=0.25):
    """Compile-separated whole-solve wall: the steady tail rate of the
    cumulative wall vector extrapolated over the full recorded span.
    Entry counts cancel, so the recvec filtering (restart iterations
    unrecorded) introduces no bias - the elapsed time of unrecorded
    iterations is inside the cumulative entries either way, and compile
    noise stays out of the acc_overhead headline."""
    import numpy as np

    tv = np.asarray(timevec, dtype=float)
    n = len(tv)
    if n < 4:
        return float(tv[-1]) if n else 0.0
    k0 = _steady_drop(n, n_drop_frac)
    rate = (tv[-1] - tv[k0]) / (n - 1 - k0)
    return float(rate * (n - 1))


def phase_accuracy() -> None:
    """The BASELINE 1e-8 target in float32 via residual-corrected
    solves (rails_tpu.refine): reference-suite-style stable tridiagonal
    problem, f32 storage end to end, f64 verification on the host
    against the composed factors."""
    import numpy as np
    import scipy.sparse as sp

    jax, on_device, dev_kind, bw = _jax_setup()
    import jax.numpy as jnp

    import rails_tpu
    from rails_tpu.sparse.formats import sparse_from_scipy

    dtype = jnp.float32
    # 8192: 5x the reference's real problem
    n = 8192 if on_device else 1024
    rng = np.random.default_rng(0)
    q = lambda x: np.round(x * 1024) / 1024  # exactly f32-representable
    main = q(-2.0 - rng.uniform(0, 1, n))
    up = q(0.4 * rng.uniform(-1, 1, n - 1))
    lo = q(0.4 * rng.uniform(-1, 1, n - 1))
    a_sp = sp.diags([lo, main, up], [-1, 0, 1]).tocsr()
    b32 = np.asarray(rng.uniform(-1, 1, (n, 4)), np.float32)
    # is_hurwitz: diagonally dominant negative by construction -> the
    # projected solve takes the sign path instead of the serial
    # QR-iteration Schur fallback (see dense_lyap.lyap docstring)
    aop = sparse_from_scipy(a_sp, fmt="dia", dtype=dtype, is_hurwitz=True)

    def true_rel(v, t):
        """||A X + X A' + B B'||_2 / ||B'B||_2 in f64 on the host via
        power iteration on the factored residual (no dense n x n)."""
        v64 = np.asarray(v, np.float64)
        t64 = np.asarray(t, np.float64)
        b64 = b32.astype(np.float64)
        av = a_sp @ v64

        def r_apply(x):
            y = b64 @ (b64.T @ x)
            y += av @ (t64 @ (v64.T @ x))
            y += v64 @ (t64 @ (av.T @ x))
            return y

        x = rng.standard_normal((n, 1))
        x /= np.linalg.norm(x)
        lam = 0.0
        for _ in range(200):
            y = r_apply(x)
            lam = float(np.linalg.norm(y))
            if lam == 0.0:
                break
            x = y / lam
        r0 = np.linalg.norm(b64.T @ b64, 2)
        return lam / r0

    # heartbeat BEFORE the first solve: a phase cap during the first
    # solve still leaves the phase geometry on record
    _emit({"acc_n": n, "acc_tol": 1e-8,
           "acc_heartbeat": "setup complete, solving"})
    # single f32 solve (the floor) vs refined (the target)
    print("accuracy: single f32 solve...", file=sys.stderr, flush=True)
    t0 = time.perf_counter()

    def heartbeat(it, wall, res):
        # one JSON line per timevec_chunk sync: a run past the phase
        # cap still leaves the latest estimated residual and iteration
        # count on record
        _emit({"acc_n": n, "acc_tol": 1e-8, "acc_heartbeat_iter": it,
               "acc_heartbeat_wall_s": round(wall, 1),
               "acc_heartbeat_res_est": res})

    v1, t1, info1 = rails_tpu.solve(
        aop, jnp.asarray(b32), tol=1e-8, dtype=dtype, maxit=100, expand=4,
        compiled=True, progress=heartbeat)
    wall_single = time.perf_counter() - t0
    single_true = true_rel(v1, t1)
    # partial line: keep the f32 floor on record even if the refined
    # stage runs past the phase cap
    _emit({
        "acc_n": n, "acc_tol": 1e-8,
        "acc_single_res_est": float(info1.res),
        "acc_single_res_true": single_true,
        "acc_single_wall_s": wall_single,
    })
    print("accuracy: refined solve...", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    # compensated reductions keep the residual estimator honest at this
    # m (plain f32 Lanczos scalars carry ~sqrt(m)*eps noise)
    v2, t2, info2 = rails_tpu.solve_refined(
        aop, jnp.asarray(b32), tol=1e-8, dtype=dtype, maxit=100, expand=4,
        precision="compensated", compiled=True, progress=heartbeat)
    wall_refined = time.perf_counter() - t0
    refined_true = true_rel(v2, t2)
    # acc_overhead_x: compile-separated.  Both sides are steady-tail walls extrapolated over the whole
    # solve (leading quarter - compile + first dispatch - excluded);
    # the raw wall ratio is kept as acc_overhead_wall_x.
    rate1 = _steady_rate(info1.timevec)
    steady_single = _steady_wall(info1.timevec)
    steady_refined = sum(_steady_wall(s.timevec) for s in info2.stages)
    _emit({
        "acc_n": n, "acc_tol": 1e-8,
        "acc_single_res_est": float(info1.res),
        "acc_single_res_true": single_true,
        "acc_single_wall_s": wall_single,
        "acc_refined_res_est": float(info2.res),
        "acc_refined_res_true": refined_true,
        "acc_refined_converged": bool(info2.converged),
        "acc_refined_stages": len(info2.stages),
        "acc_refined_iters": info2.iter,
        "acc_refined_wall_s": wall_refined,
        "acc_single_steady_s_per_iter": rate1,
        "acc_overhead_x": steady_refined / max(steady_single, 1e-9),
        "acc_overhead_wall_x": wall_refined / max(wall_single, 1e-9),
        "acc_target_met": bool(refined_true <= 1.1e-8),
    })


def phase_continuation() -> None:
    """BASELINE configs #5: a 3-step Jacobian continuation sequence at
    the phase_solve geometry (n=4096 generalized Laplacian), warm
    starting each step from the previous converged subspace via
    ContinuationSolver.  Records cold vs warm iteration counts and wall
    - the production-scale proof of the restart_data machinery
    (/root/reference/matlab/RAILSsolver.m:174-197).  Geometry and solver
    options match phase_solve exactly so the persistent compile cache
    is shared."""
    import numpy as np
    import scipy.sparse as sp

    jax, on_device, dev_kind, bw = _jax_setup()
    import jax.numpy as jnp

    import rails_tpu
    from rails_tpu.continuation import ContinuationSolver
    from rails_tpu.sparse.formats import sparse_from_scipy

    dtype = jnp.float32 if on_device else jnp.float64
    n = 4096 if on_device else 1024
    side = int(np.sqrt(n))
    rng = np.random.default_rng(0)
    md = jnp.asarray(rng.uniform(0.5, 1.5, n), dtype=dtype)
    b = jnp.asarray(rng.uniform(0, 1, (n, 8)), dtype=dtype)

    def jac(theta):
        # continuation parameter perturbs the diagonal (a reaction-term
        # sweep): same sparsity, nearby spectrum - the regime the warm
        # start is designed for
        lap = sp.kron(sp.eye(side),
                      sp.diags([1.0, -4.0 - theta, 1.0], [-1, 0, 1],
                               (side, side))) \
            + sp.kron(sp.diags([1.0, 1.0], [-1, 1], (side, side)),
                      sp.eye(side))
        return sparse_from_scipy(lap.tocsr(), fmt="dia", dtype=dtype,
                                 is_symmetric=True)

    cont = ContinuationSolver(
        b, rails_tpu.DiagonalOperator(md),
        tol=1e-4, dtype=dtype, expand=6,
        restart_size=120, reduced_size=60, maxit=200)
    out = {"cont_n": n, "cont_steps": [], "cont_thetas": [0.0, 0.05, 0.1]}
    for i, theta in enumerate(out["cont_thetas"]):
        print(f"continuation: step {i} (theta={theta})...",
              file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        _, _, info = cont.step(jac(theta), compiled=True)
        out["cont_steps"].append({
            "theta": theta, "wall_s": time.perf_counter() - t0,
            "iters": int(info.iter), "converged": bool(info.converged),
            "res": float(info.res)})
        _emit(out)  # survive a phase cap
    cold = out["cont_steps"][0]["iters"]
    warm = [s["iters"] for s in out["cont_steps"][1:]]
    out["cont_cold_iters"] = cold
    out["cont_warm_iters_mean"] = sum(warm) / len(warm)
    out["cont_warm_speedup_iters"] = cold / max(min(warm), 1)
    # wall speedup - the metric warm starts must win: cold wall over
    # the mean warm wall.  The warm basis is pre-truncated to
    # reduced_size (stable k0 -> shared engine bucket across warm steps)
    # and enters marked orthonormal (no per-column host
    # re-orthonormalization).
    cold_wall = out["cont_steps"][0]["wall_s"]
    warm_walls = [s["wall_s"] for s in out["cont_steps"][1:]]
    out["cont_cold_wall_s"] = cold_wall
    out["cont_warm_wall_mean_s"] = sum(warm_walls) / len(warm_walls)
    out["cont_warm_speedup_wall"] = cold_wall / max(
        out["cont_warm_wall_mean_s"], 1e-9)
    _emit(out)


def phase_hub() -> None:
    """Power-law sparsity: hub-split operator vs the COO gather +
    segment-sum apply on a superhub-with-locality matrix - banded bulk
    plus high-degree hub rows/columns spanning the whole index space
    (which alone would pad a plain ELL to the hub degree)."""
    import numpy as np
    import scipy.sparse as sp

    jax, on_device, dev_kind, bw = _jax_setup()
    import jax.numpy as jnp

    from rails_tpu.sparse.hub import hub_operator

    dtype = jnp.float32 if on_device else jnp.float64
    m, ell_l, band = (1 << 19 if on_device else 1 << 13), 8, 64
    n_hubs, hub_deg = 64, (4096 if on_device else 512)
    rng = np.random.default_rng(0)
    base = np.arange(m)
    idx = np.clip(base[:, None] + rng.integers(-band, band + 1, (m, ell_l)),
                  0, m - 1)
    val = rng.uniform(-1, 1, (m, ell_l)) * 0.2
    rows = np.repeat(base, ell_l)
    cols = idx.ravel()
    vals = val.ravel()
    hubs = rng.choice(m, n_hubs, replace=False)
    h_rows, h_cols, h_vals = [], [], []
    for hb in hubs:
        c = rng.choice(m, hub_deg, replace=False)
        v = rng.uniform(-1, 1, hub_deg) * 0.1
        h_rows.append(np.full(hub_deg, hb)); h_cols.append(c)
        h_vals.append(v)
        # symmetric partners (hub columns)
        h_rows.append(c); h_cols.append(np.full(hub_deg, hb))
        h_vals.append(v * 0.5)
    a = sp.coo_matrix(
        (np.concatenate([vals] + h_vals),
         (np.concatenate([rows] + h_rows),
          np.concatenate([cols] + h_cols))), shape=(m, m)).tocsr()
    nnz = int(a.nnz)
    s = 16
    x = jnp.asarray(rng.uniform(-1, 1, (m, s)), dtype=dtype)
    total = jax.jit(lambda z: jnp.sum(jnp.abs(z)))

    out = {"hub_m": m, "hub_nnz": nnz, "hub_count": n_hubs,
           "hub_deg": hub_deg, "device": dev_kind}
    op = hub_operator(a, max_hubs=n_hubs, degree_factor=8.0,
                      dtype=dtype)
    # correctness on the live payloads
    y = np.asarray(op.matmat(x), np.float64)
    ref = a @ np.asarray(x, np.float64)
    out["hub_rel_err"] = float(
        np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30))
    _emit(out)

    import functools

    # operator rides as a jit ARGUMENT (closure constants would embed
    # the payload in the compiled program)
    hub_jit = jax.jit(lambda o, z: o.matmat(z))
    hub_fn = functools.partial(hub_jit, op)
    print("hub: timing split...", file=sys.stderr, flush=True)
    float(total(hub_fn(x)))
    lo, hi = (10, 40) if on_device else (2, 8)
    dt_h = _chain_time(hub_fn, x, total, lo, hi)
    out["hub_spmm_nnz_per_s"] = nnz / dt_h
    _emit(out)

    # the fallback this matrix class would otherwise get: plain ELL
    # pads every row to the hub degree (~8 GB here - itself infeasible),
    # so the honest general-sparsity XLA baseline is the COO
    # gather + segment-sum apply (nnz-proportional memory, the
    # reference's CrsMatrix::Apply shape)
    coo = a.tocoo()
    cols_j = jnp.asarray(coo.col.astype(np.int32))
    rows_j = jnp.asarray(coo.row.astype(np.int32))
    vals_j = jnp.asarray(coo.data, dtype=dtype)

    xla_jit = jax.jit(lambda c, r, v, z: jax.ops.segment_sum(
        v[:, None] * z[c], r, num_segments=m))
    xla_fn = functools.partial(xla_jit, cols_j, rows_j, vals_j)
    out["hub_baseline"] = "coo gather + segment_sum (nnz-proportional)"
    print("hub: timing take path...", file=sys.stderr, flush=True)
    y_b = np.asarray(xla_fn(x), np.float64)
    out["hub_baseline_rel_err"] = float(
        np.abs(y_b - ref).max() / max(np.abs(ref).max(), 1e-30))
    dt_x = _chain_time(xla_fn, x, total, 2, 4)
    out["hub_xla_nnz_per_s"] = nnz / dt_x
    out["hub_speedup_vs_xla"] = dt_x / dt_h
    _emit(out)


def phase_scale() -> None:
    """Production-scale refined solve: n=65536 generalized
    2D-Laplacian, f32 storage, staged defect correction (plain f32
    plateaus at its projected-solve floor).  The small restart ladder
    (restart_size 160) keeps the phase inside a budget slice; heartbeat
    JSON lines land partial fields even under a phase cap."""
    import numpy as np
    import scipy.sparse as sp

    jax, on_device, dev_kind, bw = _jax_setup()
    import jax.numpy as jnp

    import rails_tpu
    from rails_tpu.sparse.formats import sparse_from_scipy

    dtype = jnp.float32
    side = 256 if on_device else 32
    n = side * side
    rng = np.random.default_rng(0)
    lap = sp.kron(sp.eye(side),
                  sp.diags([1.0, -4.0, 1.0], [-1, 0, 1], (side, side))) \
        + sp.kron(sp.diags([1.0, 1.0], [-1, 1], (side, side)), sp.eye(side))
    aop = sparse_from_scipy(lap.tocsr(), fmt="dia", dtype=dtype,
                            is_symmetric=True)
    md = jnp.asarray(rng.uniform(0.5, 1.5, n), dtype=dtype)
    mop = rails_tpu.DiagonalOperator(md)
    b32 = np.asarray(rng.uniform(0, 1, (n, 8)), np.float32)
    tol = 1e-4
    _emit({"scale_n": n, "scale_tol": tol,
           "scale_heartbeat": "setup complete, solving"})

    def heartbeat(it, wall, res):
        _emit({"scale_n": n, "scale_heartbeat_iter": it,
               "scale_heartbeat_wall_s": round(wall, 1),
               "scale_heartbeat_res_est": res})

    t0 = time.perf_counter()
    v, t, info = rails_tpu.solve_refined(
        aop, jnp.asarray(b32), mop, tol=tol, stage_tol=5e-3,
        dtype=dtype, maxit=1500, expand=8,
        restart_size=160, reduced_size=80, timevec_chunk=50,
        precision="compensated", compiled=True, progress=heartbeat)
    wall = time.perf_counter() - t0
    out = {
        "scale_n": n, "scale_tol": tol,
        "scale_res_est": float(info.res),
        "scale_converged": bool(info.converged),
        "scale_stages": len(info.stages),
        "scale_iters": info.iter,
        "scale_rank": int(v.shape[1]),
        "scale_wall_s": wall,
        # per RECORDED iteration (restart iterations are unrecorded in
        # timevec; ~8% of iterations at this restart ladder)
        "scale_steady_s_per_recorded_iter": _steady_rate(
            info.stages[0].timevec),
    }
    _emit(out)  # before the host verification
    # f64 true residual via factored power iteration (host; few iters -
    # the estimate stabilizes to ~1% in ~40 and this phase only needs
    # the order of magnitude vs tol)
    v64 = np.asarray(v, np.float64)
    t64 = np.asarray(t, np.float64)
    b64 = b32.astype(np.float64)
    md64 = np.asarray(md, np.float64)
    av = lap.tocsr() @ v64
    mv = md64[:, None] * v64

    def r_apply(x):
        y = b64 @ (b64.T @ x)
        y += av @ (t64 @ (mv.T @ x))
        y += mv @ (t64 @ (av.T @ x))
        return y

    x = rng.standard_normal((n, 1))
    x /= np.linalg.norm(x)
    lam = 0.0
    for _ in range(60):
        y = r_apply(x)
        lam = float(np.linalg.norm(y))
        if lam == 0.0:
            break
        x = y / lam
    out["scale_res_true"] = lam / np.linalg.norm(b64.T @ b64, 2)
    out["scale_target_met"] = bool(out["scale_res_true"] <= 2 * tol)
    _emit(out)


def mesh_scaling_bench():
    """Multi-device halo-SpMM artifact.

    On virtual CPU devices throughput-vs-devices timing is NOT a scaling
    measurement and is labeled as such.  What this phase records that
    carries over to a multi-card host:

    - ``comm`` — per-device communication volume of one apply, read out
      of the compiled HLO (collective-permute operand shapes), compared
      with the analytic minimal halo (span_lo+span_hi rows x s columns).
      ratio == 1.0 means the compiled program moves exactly the
      neighbor halo and nothing else, independent of device count - the
      property that gives the reference its parallel efficiency
      (/root/reference/src/Epetra_OperatorWrapper.cpp:75-91).
    - ``halo_overhead_vs_plain`` — time of the mesh path at nd=1 over
      the plain single-device apply: the cost of the shard_map wrapper.
    """
    import re

    import numpy as np

    jax, on_device, dev_kind, bw = _jax_setup()
    import jax.numpy as jnp

    from rails_tpu.parallel.halo_spmm import halo_dia_spmm
    from rails_tpu.parallel.mesh import make_mesh
    from rails_tpu.sparse.formats import DiaMatrix

    if not on_device:
        jax.config.update("jax_enable_x64", True)
    nd = len(jax.devices())
    dtype = jnp.float32 if on_device else jnp.float64
    itemsize = jnp.dtype(dtype).itemsize
    side = 1536 if on_device else 512
    m = (side * side // (nd * 128)) * nd * 128
    s = 16
    offsets = (-side, -1, 0, 1, side)
    span = 2 * side  # span_lo + span_hi
    rng = np.random.default_rng(0)
    data = jnp.asarray(rng.uniform(-1, 1, (len(offsets), m)),
                       dtype=dtype) * 0.12
    dia = DiaMatrix(data, offsets, (m, m))
    v = jnp.asarray(rng.uniform(-1, 1, (m, s)), dtype=dtype)
    real_parallel = on_device
    results = {"metric": "halo_dia_spmm_nnz_per_s", "unit": "nnz/s",
               "rows": m, "device": dev_kind, "devices": nd,
               "timing_is_scaling": bool(real_parallel and nd > 1),
               "per_devices": {}, "comm": {}}
    nnz = len(offsets) * m
    total = jax.jit(lambda x: jnp.sum(jnp.abs(x)))
    analytic = span * s * itemsize
    for nd_i in sorted({1, 2, nd // 2, nd} - {0}):
        if nd_i > nd or m % (nd_i * 128):
            continue
        mesh = make_mesh(nd_i)
        fn = jax.jit(lambda x, mesh=mesh: halo_dia_spmm(dia, x, mesh))
        try:
            compiled = fn.lower(v).compile()
            float(total(fn(v)))
        except ValueError:
            continue  # slab too small for the stencil
        # communication volume: every collective-permute operand in the
        # compiled module, bytes per device per apply
        hlo = compiled.as_text()
        moved = 0
        for shape in re.findall(
                r"=\s*\(?(?:f32|f64|bf16)\[([\d,]*)\][^=\n]*"
                r"collective-permute", hlo):
            dims = [int(d) for d in shape.split(",") if d]
            moved += int(np.prod(dims)) * itemsize if dims else itemsize
        if nd_i > 1:
            results["comm"][str(nd_i)] = {
                "permute_bytes_per_device": moved,
                "analytic_halo_bytes": analytic,
                "ratio": moved / analytic if analytic else 0.0,
            }
        lo, hi = (10, 60) if on_device else (2, 10)
        dt = _chain_time(fn, v, total, lo, hi)
        results["per_devices"][str(nd_i)] = nnz / dt
        _emit(results)  # survive a phase cap

    base = results["per_devices"].get("1")
    if base:
        plain = jax.jit(dia.matmat)
        float(total(plain(v)))
        dt_plain = _chain_time(plain, v, total,
                               *((10, 60) if on_device else (2, 10)))
        results["halo_overhead_vs_plain"] = (nnz / base) / dt_plain
    full = results["per_devices"].get(str(nd))
    results["value"] = full or 0.0
    ratios = [c["ratio"] for c in results["comm"].values()]
    # comm_minimality: 1.0 = the compiled program moves exactly the
    # analytic halo and nothing else.  Throughput scaling efficiency is
    # emitted as scaling_efficiency when the devices are physical.  With
    # a single device there is no
    # collective to audit: emit null, not 0.0 (a zero would read as
    # "no minimality" instead of "not measurable").
    results["comm_minimality"] = (
        min(min(analytic / c["permute_bytes_per_device"], 1.0)
            for c in results["comm"].values())
        if ratios and all(r > 0 for r in ratios) else None)
    if not results["comm"]:
        results["comm"] = None
    if real_parallel and base and full and nd > 1:
        results["scaling_efficiency"] = full / (base * nd)
    _emit(results)

    # distributed-ELL wrapper overhead at the current device count:
    # halo_ell_spmm (shard_map + halo permutes + extended-slab gather)
    # vs the single-device apply on the same payload
    import scipy.sparse as sp

    from rails_tpu.parallel.halo_ell import build_halo_ell, halo_ell_spmm
    from rails_tpu.sparse.formats import sparse_from_scipy

    m_e, ell_l, band = (1 << 20 if on_device else 1 << 14), 8, 64
    base_r = np.arange(m_e)
    idx = np.clip(base_r[:, None]
                  + rng.integers(-band, band + 1, (m_e, ell_l)),
                  0, m_e - 1)
    val = rng.uniform(-1, 1, (m_e, ell_l)) * 0.2
    a_e = sp.coo_matrix(
        (val.ravel(), (np.repeat(base_r, ell_l), idx.ravel())),
        shape=(m_e, m_e)).tocsr()
    op_e = sparse_from_scipy(a_e, fmt="ell", dtype=dtype)
    mesh1 = make_mesh(nd)
    p = build_halo_ell(op_e.fwd, mesh1)
    if p is not None:
        x_e = jnp.asarray(rng.uniform(-1, 1, (m_e, s)), dtype=dtype)
        halo_fn = jax.jit(lambda x: halo_ell_spmm(p, x, mesh1))
        if nd > 1:
            # ELL comm audit (mirrors the DIA one above): the compiled
            # program should ppermute exactly the (halo_lo + halo_hi) x s
            # neighbor rows per device
            hlo_e = halo_fn.lower(x_e).compile().as_text()
            moved_e = 0
            for shape in re.findall(
                    r"=\s*\(?(?:f32|f64|bf16)\[([\d,]*)\][^=\n]*"
                    r"collective-permute", hlo_e):
                dims = [int(x) for x in shape.split(",") if x]
                moved_e += (int(np.prod(dims)) * itemsize
                            if dims else itemsize)
            analytic_e = (p.halo_lo + p.halo_hi) * s * itemsize
            results["ell_comm"] = {
                "permute_bytes_per_device": moved_e,
                "analytic_halo_bytes": analytic_e,
                "ratio": moved_e / analytic_e if analytic_e else None,
            }
            results["ell_comm_minimality"] = (
                min(analytic_e / moved_e, 1.0) if moved_e else None)
        float(total(halo_fn(x_e)))
        lo, hi = (10, 60) if on_device else (2, 10)
        dt_h = _chain_time(halo_fn, x_e, total, lo, hi)
        bare_fn = jax.jit(op_e.fwd.matmat)
        float(total(bare_fn(x_e)))
        dt_b = _chain_time(bare_fn, x_e, total, lo, hi)
        results["ell_halo_devices"] = nd
        results["ell_halo_overhead_vs_plain"] = dt_h / dt_b
        results["ell_halo_nnz_per_s"] = int(a_e.nnz) / dt_h
    _emit(results)


# Compact headline: the orchestrator prints the FULL consolidated line
# first, then this compact (< ~1,500 chars) headline line LAST - a
# reader of the output's tail takes the last JSON line, so the
# machine-readable channel stays intact while the full record rides
# just above it.
COMPACT_KEYS = (
    "metric", "value", "unit", "vs_baseline", "vs_stream",
    "kernel_gbs", "stream_gbs",
    "platform", "device_kind", "device_count", "power_limit",
    "acc_single_res_true", "acc_refined_res_true", "acc_target_met",
    "acc_overhead_x", "acc_refined_wall_s",
    "ell_spmm_nnz_per_s", "ell_roofline_frac",
    "hub_speedup_vs_xla", "hub_spmm_nnz_per_s",
    "moc_res_fro", "moc_iters", "moc_converged",
    "solve_wall_s", "solve_iters", "solve_converged",
    "cont_cold_iters", "cont_warm_iters_mean",
    "cont_warm_speedup_iters", "cont_warm_speedup_wall",
    "scale_n", "scale_res_true", "scale_converged", "scale_wall_s",
    "mesh_comm_minimality", "ell_comm_minimality",
    "mesh_halo_overhead_vs_plain", "ell_halo_overhead_vs_plain",
)
COMPACT_LIMIT = 1500


def build_compact_line(out) -> str:
    """The final-stdout-line headline: guaranteed under COMPACT_LIMIT
    chars (floats at 6 significant digits; drops its trailing sections
    if ever needed)."""
    def r6(v):
        if isinstance(v, float):
            return float(f"{v:.6g}")
        return v

    compact = {k: r6(out[k]) for k in COMPACT_KEYS if k in out}
    compact["phase_walls"] = {
        k: r6(v.get("wall_s")) for k, v in out.get("phases", {}).items()}
    errs = {k: v["error"][:60] for k, v in out.get("phases", {}).items()
            if "error" in v}
    if errs:
        compact["phase_errors"] = errs
    compact["provenance"] = (
        "compact headline of the full consolidated line directly "
        "above (same single orchestrated run)")
    line = json.dumps(compact)
    if len(line) > COMPACT_LIMIT:  # defensive: the headline must parse
        for k in ("provenance", "phase_errors", "phase_walls"):
            compact.pop(k, None)
            line = json.dumps(compact)
            if len(line) <= COMPACT_LIMIT:
                break
    return line


def _extract_json(text):
    """Last parseable JSON line of a phase's stdout (phases may print
    intermediate lines; the final full dict wins)."""
    for line in reversed((text or "").strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def _run_phase(args, timeout):
    """Run one phase subprocess.  Returns (result_dict_or_None, meta):
    meta records wall time and, on failure, the error kind plus the last
    stderr lines - a timed-out phase still yields any intermediate JSON
    it printed before the kill."""
    if "--cpu" in sys.argv and "--cpu" not in args:
        args = args + ["--cpu"]
    meta = {}
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__)] + args,
            capture_output=True, text=True, timeout=timeout,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        meta["wall_s"] = round(time.monotonic() - t0, 1)
        if proc.returncode != 0:
            meta["error"] = f"rc={proc.returncode}: " + "; ".join(
                proc.stderr.strip().splitlines()[-3:])[:500]
        return _extract_json(proc.stdout), meta
    except subprocess.TimeoutExpired as e:
        meta["wall_s"] = round(time.monotonic() - t0, 1)
        meta["error"] = f"timeout after {timeout:.0f}s"
        stdout = e.stdout
        if isinstance(stdout, bytes):
            stdout = stdout.decode("utf-8", "replace")
        return _extract_json(stdout), meta
    except Exception as e:  # noqa: BLE001 - record, never drop the round
        meta["wall_s"] = round(time.monotonic() - t0, 1)
        meta["error"] = f"{type(e).__name__}: {e}"[:500]
        return None, meta


def main():
    if "--mesh" in sys.argv:
        return mesh_scaling_bench()
    if "--phase" in sys.argv:
        phase = sys.argv[sys.argv.index("--phase") + 1]
        phases = {"spmm": phase_spmm, "solve": phase_solve,
                  "accuracy": phase_accuracy, "ell": phase_ell,
                  "continuation": phase_continuation,
                  "scale": phase_scale, "hub": phase_hub}
        if phase not in phases:
            raise SystemExit(f"unknown phase {phase}")
        return phases[phase]()

    # Orchestrate phases in subprocesses (one JAX process holds the card
    # at a time), most-important-first, under a total budget; print the
    # cumulative consolidated line after every phase so nothing is lost.
    # Each phase's cap is min(static_cap, remaining - sum(reserves of
    # later phases)): no phase can eat another's minimum slice, and a
    # phase that needs less than its reserve hands the slack down the
    # list.
    budget = float(os.environ.get("RAILS_BENCH_BUDGET_S", 1380))
    deadline = time.monotonic() + budget
    out = {"metric": "dia_spmm_nnz_per_s", "value": 0.0, "unit": "nnz/s",
           "vs_baseline": 0.0, "phases": {},
           "provenance": ("single orchestrated `python bench.py` run; "
                          "every field below comes from this run's own "
                          "phase subprocesses (per-phase wall times in "
                          "'phases'), budget "
                          f"{budget:.0f}s")}
    print(json.dumps(out), flush=True)  # never leave an empty tail

    def emit():
        print(json.dumps(out), flush=True)
        print(build_compact_line(out), flush=True)

    # (static_cap, reserve) per phase, in run order.  Reserves are the
    # floor a later phase is guaranteed; statics are the ceiling any
    # phase may take while others still wait.
    plan = {"spmm": (480, 0), "accuracy": (480, 180), "ell": (600, 150),
            "hub": (240, 60), "solve": (360, 100),
            "continuation": (300, 70), "scale": (420, 100),
            "mesh": (300, 80)}
    order = list(plan)

    def run(name, args, merge=None):
        later = order[order.index(name) + 1:]
        reserve_later = sum(plan[p][1] for p in later)
        remaining = deadline - time.monotonic()
        cap = min(plan[name][0], remaining - reserve_later)
        if cap < 45:
            out["phases"][name] = {"error": "skipped (budget exhausted)"}
            emit()
            return None
        res, meta = _run_phase(args, cap)
        out["phases"][name] = meta
        if res:
            if merge:
                merge(res)
            else:
                out.update(res)
        emit()
        return res

    def merge_quiet(r):
        out.update({k: v for k, v in r.items() if k != "device"})

    def merge_mesh(r):
        out["mesh_halo_overhead_vs_plain"] = r.get("halo_overhead_vs_plain")
        out["mesh_devices"] = r.get("devices")
        out["mesh_comm"] = r.get("comm")
        out["mesh_comm_minimality"] = r.get("comm_minimality")
        for k in ("ell_halo_devices", "ell_halo_overhead_vs_plain",
                  "ell_halo_nnz_per_s", "ell_comm", "ell_comm_minimality"):
            if k in r:
                out[k] = r[k]

    run("spmm", ["--phase", "spmm"])
    run("accuracy", ["--phase", "accuracy"])
    run("ell", ["--phase", "ell"], merge=merge_quiet)
    run("hub", ["--phase", "hub"], merge=merge_quiet)
    run("solve", ["--phase", "solve"])
    run("continuation", ["--phase", "continuation"])
    run("scale", ["--phase", "scale"])
    run("mesh", ["--mesh"], merge=merge_mesh)
    failed = sorted(k for k, v in out["phases"].items() if "error" in v)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
