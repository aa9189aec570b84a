"""End-to-end proof that the solver runs on the GPU.

    python chip_smoke.py [--seed N]        # one card: phases 1-5
    python chip_smoke.py --four [--seed N]  # four cards: the mesh paths only

Drives the main path through the entry points a user calls, at a state
size that exceeds the card's L2 many times over, and checks every result
against an independent host reference in float64:

1. ``rails_tpu.solve`` in f64 on the generalized 2-D Laplacian (DIA A,
   diagonal M, 8-column B), side 512 (m = 262,144);
2. ``rails_tpu.solve_refined`` in f32 with compensated reductions on the
   same problem, once as is and once under a global "highest" matmul
   precision (a gap between the two exposes a TF32 product);
3. the ELL apply on banded-unstructured sparsity at m = 2^21 against
   scipy, and a full solve at m = 2^18;
4. the CLI, in-process, on a Laplace problem (n = 262,144) and on a DAE
   problem (n = 2,048) that runs the Schur reduction, the nonsymmetric
   projected solve, ``eigs`` and the trace table;
5. the DIA apply at m = 1536^2, s = 16 in f32 in two formulations, timed
   against a copy over the same bytes.

``--four`` runs only what exists across cards, each against the one-card
run in the same process: the halo-DIA solve of phase 1's problem, the
halo-ELL apply and solve at m = 2^18, and the distributed Schur solve of
phase 4's DAE problem.

The script exits non-zero, and prints no result line, when JAX finds no
GPU or any phase fails.  Its last stdout line is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_s = [0.0]


def _on_duration(event, secs, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += secs


def card_line() -> str:
    """``nvidia-smi`` name and power limit, read without importing JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class Phase:
    """Times a phase, splitting JAX compile time from the rest, and
    prints one line per check plus a summary."""

    def __init__(self, name: str):
        self.name = name
        self.rec = {"phase": name}

    def __enter__(self):
        print(f"[{self.name}] start", flush=True)
        self._c0 = _compile_s[0]
        self._t0 = time.perf_counter()
        return self

    def check(self, what: str, value: float, limit: float) -> None:
        ok = bool(np.isfinite(value) and value <= limit)
        print(f"[{self.name}] {what} = {value:.6e} (limit {limit:.1e}) "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        self.rec[what] = value
        if not ok:
            raise AssertionError(f"{self.name}: {what} = {value:.3e} > "
                                 f"{limit:.1e}")

    def __exit__(self, *exc):
        wall = time.perf_counter() - self._t0
        comp = _compile_s[0] - self._c0
        self.rec.update(wall_s=wall, compile_s=comp,
                        steady_s=max(wall - comp, 0.0),
                        peak_bytes_in_use=peak_bytes())
        if exc[0] is None:
            print(f"[{self.name}] done {json.dumps(self.rec)}", flush=True)
        return False


# --------------------------------------------------------------------------
# problems and host references

def laplace_problem(side: int, n_rhs: int, seed: int, dtype):
    """Phase 1's generalized 2-D Laplacian: DIA A, M ~ U[0.5, 1.5],
    B ~ U[0, 1] with ``n_rhs`` columns, all from ``seed``."""
    import jax.numpy as jnp

    import rails_tpu
    from rails_tpu.models.problems import laplacian2_sparse
    from rails_tpu.sparse.formats import sparse_from_scipy

    m = side * side
    rng = np.random.default_rng(seed)
    lap = laplacian2_sparse(m)
    md = rng.uniform(0.5, 1.5, m)
    b = rng.uniform(0.0, 1.0, (m, n_rhs))
    aop = sparse_from_scipy(lap, fmt="dia", dtype=dtype)
    mop = rails_tpu.DiagonalOperator(jnp.asarray(md, dtype=dtype))
    return lap, md, b, aop, mop


def banded_unstructured(rng, m, band=20, per_row=6):
    """Random banded-unstructured matrix (the post-RCM shape of general
    sparsity): per-row random column picks within +-band, shifted
    diagonally dominant, so A is Hurwitz by Gershgorin."""
    import scipy.sparse as sp

    base = np.arange(m)
    idx = np.clip(base[:, None] + rng.integers(-band, band + 1,
                                               (m, per_row)), 0, m - 1)
    val = rng.uniform(-1, 1, (m, per_row))
    a = sp.coo_matrix((val.ravel(), (np.repeat(base, per_row),
                                     idx.ravel())), shape=(m, m)).tocsr()
    a = a + sp.eye(m) * (np.abs(a).sum(axis=1).max() + 1.0) * -1.0
    return a.tocsr()


def true_residual(a, md, b, v, t, seed: int = 0, iters: int = 60) -> float:
    """||A X M' + M X A' + B B'||_2 / ||B'B||_2 for X = V T V', in f64 on
    the host, by power iteration on the factored (symmetric) residual."""
    v = np.asarray(v, np.float64)
    t = np.asarray(t, np.float64)
    b = np.asarray(b, np.float64)
    av = a @ v
    mv = v if md is None else np.asarray(md, np.float64)[:, None] * v

    def r_apply(x):
        return (b @ (b.T @ x) + av @ (t @ (mv.T @ x))
                + mv @ (t @ (av.T @ x)))

    x = np.random.default_rng(seed).standard_normal((v.shape[0], 1))
    x /= np.linalg.norm(x)
    lam = 0.0
    for _ in range(iters):
        y = r_apply(x)
        lam = float(np.linalg.norm(y))
        if lam == 0.0:
            break
        x = y / lam
    return lam / np.linalg.norm(b.T @ b, 2)


def probe_gap(v1, t1, v2, t2, seed: int = 0, n_probe: int = 8) -> float:
    """max relative difference of V T V' applied to random probes."""
    v1, t1, v2, t2 = (np.asarray(z, np.float64) for z in (v1, t1, v2, t2))
    p = np.random.default_rng(seed).standard_normal((v1.shape[0], n_probe))
    y1 = v1 @ (t1 @ (v1.T @ p))
    y2 = v2 @ (t2 @ (v2.T @ p))
    return float(np.abs(y1 - y2).max() / np.abs(y1).max())


# --------------------------------------------------------------------------
# phases

def phase_f64(side: int = 512, seed: int = 0, tol: float = 1e-5,
              maxit: int = 8000) -> dict:
    import jax.numpy as jnp

    import rails_tpu

    with Phase("1 f64 solve") as ph:
        lap, md, b, aop, mop = laplace_problem(side, 8, seed, jnp.float64)
        v, t, info = rails_tpu.solve(
            aop, jnp.asarray(b), mop, tol=tol, maxit=maxit, expand=8,
            restart_size=160, reduced_size=80, dtype=jnp.float64,
            compiled=True)
        ph.rec.update(m=side * side, iters=int(info.iter),
                      rank=int(v.shape[1]), res_est=float(info.res))
        ph.check("true_residual", true_residual(lap, md, b, v, t), 2 * tol)
    return ph.rec


def _refined(aop, mop, b, tol, maxit):
    import jax.numpy as jnp

    import rails_tpu

    return rails_tpu.solve_refined(
        aop, jnp.asarray(b, jnp.float32), mop, tol=tol, stage_tol=5e-3,
        dtype=jnp.float32, maxit=maxit, expand=8, restart_size=160,
        reduced_size=80, timevec_chunk=50, precision="compensated",
        compiled=True)


def phase_f32_refined(side: int = 512, seed: int = 0, tol: float = 1e-4,
                      maxit: int = 8000) -> dict:
    import jax
    import jax.numpy as jnp

    with Phase("2 f32 refined") as ph:
        lap, md, b, aop, mop = laplace_problem(side, 8, seed, jnp.float32)
        v, t, info = _refined(aop, mop, b, tol, maxit)
        res = true_residual(lap, md, b, v, t)
        ph.rec.update(m=side * side, iters=int(info.iter),
                      stages=len(info.stages), res_est=float(info.res))
        ph.check("true_residual", res, 2 * tol)
        with jax.default_matmul_precision("highest"):
            v_h, t_h, info_h = _refined(aop, mop, b, tol, maxit)
        res_h = true_residual(lap, md, b, v_h, t_h)
        ph.rec.update(iters_highest=int(info_h.iter))
        ph.check("true_residual_highest", res_h, 2 * tol)
        # a TF32 product in an m-sized contraction would show as a
        # residual gap between the default and the "highest" run
        ph.check("residual_ratio_default_vs_highest",
                 max(res, res_h) / min(res, res_h), 2.0)
    return ph.rec


def _time_apply(fn, x, reps: int = 20) -> float:
    """Median seconds per call over ``reps`` back-to-back calls, each
    batch closed by ``block_until_ready``."""
    fn(x).block_until_ready()
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            y = fn(x)
        y.block_until_ready()
        samples.append((time.perf_counter() - t0) / reps)
    return float(np.median(samples))


def phase_ell(m_apply: int = 1 << 21, m_solve: int = 1 << 18, s: int = 16,
              seed: int = 0, tol: float = 1e-6, maxit: int = 200) -> dict:
    import jax
    import jax.numpy as jnp

    import rails_tpu
    from rails_tpu.sparse.formats import sparse_from_scipy

    rng = np.random.default_rng(seed)
    with Phase("3 ELL") as ph:
        a = banded_unstructured(rng, m_apply)
        op = sparse_from_scipy(a, fmt="ell", dtype=jnp.float32)
        x = rng.uniform(-1, 1, (m_apply, s)).astype(np.float32)
        xd = jnp.asarray(x)
        apply = jax.jit(lambda o, z: o.matmat(z))
        y = np.asarray(apply(op, xd), np.float64)
        ref = a @ x.astype(np.float64)
        ph.check("apply_rel_err",
                 float(np.abs(y - ref).max() / np.abs(ref).max()), 1e-5)
        dt = _time_apply(lambda z: apply(op, z), xd)
        ell_l = op.fwd.values.shape[1]
        ph.rec.update(m_apply=m_apply, s=s, slots=ell_l, apply_s=dt,
                      apply_gbs=(2 * ell_l * m_apply + 2 * m_apply * s)
                      * 4 / dt / 1e9)
        # full solve at m_solve; A is Hurwitz by construction, and the tag
        # lets the projected solves take the sign iteration
        a2 = banded_unstructured(rng, m_solve)
        b = rng.uniform(0, 1, (m_solve, 2))
        v, t, info = rails_tpu.solve(
            sparse_from_scipy(a2, fmt="ell", is_hurwitz=True),
            jnp.asarray(b), tol=tol, maxit=maxit, dtype=jnp.float64,
            compiled=True)
        ph.rec.update(m_solve=m_solve, iters=int(info.iter),
                      res_est=float(info.res))
        ph.check("true_residual", true_residual(a2, None, b, v, t), 2 * tol)
    return ph.rec


def _cli(directory: str, *extra: str) -> str:
    """Run the CLI in this process (a second JAX process could not get
    the card's memory) and return what it printed."""
    from rails_tpu.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([directory, "--x64", *extra])
    out = buf.getvalue()
    print(out, end="", flush=True)
    if rc != 0:
        raise AssertionError(f"cli exited with {rc}")
    return out


def _cli_residual(out: str) -> float:
    mt = re.search(r"Solver converged in (\d+) iterations, relative "
                   r"residual ([0-9.eE+-]+)", out)
    if mt is None:
        raise AssertionError("the CLI solve did not converge")
    return float(mt.group(2))


def phase_cli(workdir: str, n_laplace: int = 262144, n_dae: int = 2048,
              seed: int = 0) -> dict:
    import scipy.io

    from rails_tpu.models.make_problem import make

    with Phase("4 CLI") as ph:
        tol = 1e-4
        d1 = os.path.join(workdir, "laplace")
        make("laplace", d1, n=n_laplace, seed=seed)
        params = os.path.join(d1, "params.json")
        with open(params, "w") as f:
            json.dump({"Lyapunov Solver": {
                "Restart size": 160, "Reduced size": 80}}, f)
        out = _cli(d1, "--params", params, "--tol", str(tol),
                   "--maxit", "8000", "--num-eigenvalues", "5")
        ph.check("laplace_res_est", _cli_residual(out), tol)
        a = scipy.io.mmread(os.path.join(d1, "A.mtx")).tocsr()
        md = scipy.io.mmread(os.path.join(d1, "M.mtx")).diagonal()
        b = np.asarray(scipy.io.mmread(os.path.join(d1, "B.mtx")).todense())
        v = scipy.io.mmread(os.path.join(d1, "V.mtx"))
        t = scipy.io.mmread(os.path.join(d1, "T.mtx"))
        ph.rec.update(n_laplace=n_laplace, laplace_rank=int(v.shape[1]))
        ph.check("laplace_true_residual", true_residual(a, md, b, v, t),
                 2 * tol)

        d2 = os.path.join(workdir, "dae")
        make("dae", d2, n=n_dae, seed=seed)
        out = _cli(d2, "--tol", str(tol), "--maxit", "500",
                   "--num-eigenvalues", "5")
        ph.check("dae_res_est", _cli_residual(out), tol)
        for name in ("V.mtx", "T.mtx"):
            if not os.path.getsize(os.path.join(d2, name)):
                raise AssertionError(f"dae: {name} is empty")
        if "eigenvalue/trace" not in out:
            raise AssertionError("dae: no eigenvalue/trace table")
        ph.rec.update(n_dae=n_dae)
    return ph.rec


def dia_chain(data, offsets, x):
    """The DIA apply as a chain of d slice-update passes over y."""
    import jax.numpy as jnp

    m = x.shape[0]
    y = jnp.zeros_like(x)
    for k, off in enumerate(offsets):
        lo, hi = max(0, -off), min(m, m - off)
        y = y.at[lo:hi].add(data[k, lo:hi, None] * x[lo + off:hi + off])
    return y


def phase_dia(side: int = 1536, s: int = 16, seed: int = 0,
              card: str = "") -> dict:
    import jax
    import jax.numpy as jnp

    from rails_tpu.sparse.formats import DiaMatrix

    with Phase("5 DIA apply") as ph:
        m = side * side
        offsets = (-side, -1, 0, 1, side)
        rng = np.random.default_rng(seed)
        data = jnp.asarray(rng.uniform(-1, 1, (len(offsets), m)) * 0.12,
                           jnp.float32)
        dia = DiaMatrix(data, offsets, (m, m))
        x = jnp.asarray(rng.uniform(-1, 1, (m, s)), jnp.float32)
        fused = jax.jit(lambda z: dia.matmat(z))
        chain = jax.jit(lambda z: dia_chain(data, offsets, z))
        copy = jax.jit(lambda z: z * 0.999)
        ref = np.asarray(chain(x), np.float64)
        err = np.abs(np.asarray(fused(x), np.float64) - ref).max()
        ph.check("fused_vs_chain_rel_err", float(err / np.abs(ref).max()),
                 1e-6)
        dia_bytes = (len(offsets) * m + 2 * m * s) * 4
        copy_bytes = 2 * m * s * 4
        # interleaved, so a clock change touches all three alike
        t_f, t_c, t_k = [], [], []
        for _ in range(3):
            t_f.append(_time_apply(fused, x))
            t_c.append(_time_apply(chain, x))
            t_k.append(_time_apply(copy, x))
        gbs = {"fused_gbs": dia_bytes / min(t_f) / 1e9,
               "chain_gbs": dia_bytes / min(t_c) / 1e9,
               "copy_gbs": copy_bytes / min(t_k) / 1e9}
        ph.rec.update(m=m, s=s, card=card, fused_s=min(t_f),
                      chain_s=min(t_c), copy_s=min(t_k), **gbs)
        print(f"[5 DIA apply] {card}: fused {gbs['fused_gbs']:.1f} GB/s, "
              f"chain {gbs['chain_gbs']:.1f} GB/s, copy "
              f"{gbs['copy_gbs']:.1f} GB/s", flush=True)
    return ph.rec


def _devices_of(tree) -> set:
    import jax

    devs = set()
    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "sharding"):
            devs |= set(leaf.sharding.device_set)
    return devs


def phase_four(n_devices: int = 4, side: int = 512, m_ell: int = 1 << 18,
               n_dae: int = 2048, seed: int = 0, workdir: str = "",
               ell_maxit: int = 200, prefix_iters: int = 12) -> dict:
    """The mesh paths against the one-card run in the same process."""
    import jax
    import jax.numpy as jnp
    import scipy.io

    import rails_tpu
    from rails_tpu.models.make_problem import make
    from rails_tpu.parallel.mesh import make_mesh
    from rails_tpu.sparse.formats import sparse_from_scipy

    mesh = make_mesh(n_devices)
    want = set(mesh.devices.flat)

    def placed(what, tree):
        devs = _devices_of(tree)
        print(f"[four] {what}: {sorted(str(d) for d in devs)}", flush=True)
        if devs != want:
            raise AssertionError(f"{what} sits on {devs}, not {want}")

    def compare(ph, what, one, many):
        """Same iteration count, and V T V' on probes to rounding."""
        (v1, t1, i1), (v4, t4, i4) = one, many
        ph.rec[f"{what}_iters"] = [int(i1.iter), int(i4.iter)]
        placed(f"{what} V", v4)
        ph.check(f"{what}_iteration_difference",
                 abs(int(i1.iter) - int(i4.iter)), 0)
        ph.check(f"{what}_probe_gap", probe_gap(v1, t1, v4, t4, seed), 1e-8)

    def apply_gap(op_mesh, ref, m):
        x = jax.device_put(jnp.asarray(rng.uniform(-1, 1, (m, 16))),
                           jax.sharding.NamedSharding(
                               mesh, jax.sharding.PartitionSpec("rows")))
        y = np.asarray(jax.jit(lambda o, z: o.matmat(z))(op_mesh, x))
        want = ref(np.asarray(x))
        return float(np.abs(y - want).max() / np.abs(want).max())

    rng = np.random.default_rng(seed)
    with Phase(f"four x{n_devices}") as ph:
        # halo DIA on phase 1's problem
        lap, md, b, aop, mop = laplace_problem(side, 8, seed, jnp.float64)
        b = jnp.asarray(b)
        kw = dict(tol=1e-5, expand=8, restart_size=160, reduced_size=80,
                  dtype=jnp.float64)
        solver = rails_tpu.LyapunovSolver(aop, b, mop, mesh=mesh, maxit=8000,
                                          **kw)
        ph.rec["dia_operator"] = type(solver.A).__name__
        placed("halo DIA payload", solver.A)
        ph.check("dia_apply_rel_err",
                 apply_gap(solver.A, lambda z: lap @ z, side * side), 1e-12)
        # Up to the first restart (8 columns per iteration from 8, restart
        # at 160) both runs take the same path, so they agree to rounding.
        # A restart truncates the basis by eigenvalue thresholds: rounding
        # differences then change which directions survive, and the full
        # solves take different (equally valid) paths - each is verified
        # on its own by its f64 residual, and both counts are reported.
        one = rails_tpu.solve(aop, b, mop, maxit=prefix_iters,
                              compiled=True, **kw)
        many = rails_tpu.LyapunovSolver(
            aop, b, mop, mesh=mesh, maxit=prefix_iters, **kw).solve(
                compiled=True)
        compare(ph, "dia_prefix", one, many)
        one = rails_tpu.solve(aop, b, mop, maxit=8000, compiled=True, **kw)
        many = solver.solve(compiled=True)
        placed("dia V", many[0])
        ph.rec["dia_iters"] = [int(one[2].iter), int(many[2].iter)]
        ph.rec["dia_probe_gap"] = probe_gap(one[0], one[1], many[0],
                                            many[1], seed)
        print(f"[four] dia full solve: iterations {ph.rec['dia_iters']} "
              f"(one card, {n_devices} cards), V T V' probe gap "
              f"{ph.rec['dia_probe_gap']:.3e}", flush=True)
        if not many[2].converged:
            raise AssertionError("dia: the mesh solve did not converge")
        ph.check("dia_mesh_true_residual",
                 true_residual(lap, md, b, many[0], many[1]),
                 2 * kw["tol"])

        # halo ELL: apply and solve (no restart: agreement to rounding)
        a = banded_unstructured(rng, m_ell)
        op = sparse_from_scipy(a, fmt="ell", is_hurwitz=True)
        b2 = jnp.asarray(rng.uniform(0, 1, (m_ell, 2)))
        one = rails_tpu.solve(op, b2, tol=1e-6, maxit=ell_maxit,
                              compiled=True)
        solver = rails_tpu.LyapunovSolver(op, b2, mesh=mesh, tol=1e-6,
                                          maxit=ell_maxit)
        ph.rec["ell_operator"] = type(solver.A).__name__
        placed("halo ELL payload", solver.A)
        ph.check("ell_apply_rel_err",
                 apply_gap(solver.A, lambda z: a @ z, m_ell), 1e-12)
        compare(ph, "ell", one, solver.solve(compiled=True))

        # distributed Schur on the DAE problem
        from rails_tpu.parallel.schur_dist import distribute_schur, pad_system
        from rails_tpu.schur import schur_reduce

        d = os.path.join(workdir, "dae_four")
        make("dae", d, n=n_dae, seed=seed)
        a3, m3, b3 = (scipy.io.mmread(os.path.join(d, f)).tocsr()
                      for f in ("A.mtx", "M.mtx", "B.mtx"))
        a3, m3, b3, _ = pad_system(a3, m3, b3, n_devices)
        red = schur_reduce(a3, m3, b3)
        bs = jnp.asarray(red.bs)
        one = rails_tpu.solve(red.operator, bs, red.ms, tol=1e-4,
                              maxit=500)
        dop = distribute_schur(red, mesh)
        placed("distributed Schur operator", dop)
        solver = rails_tpu.LyapunovSolver(dop, bs, red.ms, mesh=mesh,
                                          tol=1e-4, maxit=500)
        compare(ph, "schur", one, solver.solve())
    return ph.rec


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh paths")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    card = card_line()
    import jax

    devices = jax.devices()
    print(f"devices: {devices}", flush=True)
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX platform is {dev.platform!r}", file=sys.stderr)
        return 1
    count = 4 if args.four else 1
    if len(devices) < count:
        print(f"need {count} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        return 1
    from rails_tpu.device import enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    workdir = os.path.join(HERE, "chiprun_out", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    print(f"card: {card}", flush=True)

    if args.four:
        phase_four(seed=args.seed, workdir=workdir)
    else:
        phase_f64(seed=args.seed)
        phase_f32_refined(seed=args.seed)
        phase_ell(seed=args.seed)
        phase_cli(workdir, seed=args.seed)
        phase_dia(seed=args.seed, card=card)
    shutil.rmtree(workdir)  # the CLI's V.mtx alone is hundreds of MB
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
