"""Residual-corrected (iteratively refined) low-rank Lyapunov solves.

A float32 solve moves half the bytes of a float64 one, but a single f32
RAILS solve floors at a relative residual of ~1e-6: the stored V/T factors only carry
~7 significant digits, so no amount of careful arithmetic inside one
solve can push the *represented* solution past that (measured: an f64
solve reaches 7e-9 at k=24 on a problem where f32 stalls at 8e-7 with
k=237, standard or compensated).  The reference never faces this - it
leans on f64 BLAS throughout (/root/reference/src/BlasWrapper.hpp:21-40).

The fix that keeps f32 storage is defect correction at the *equation*
level (on the GPU a plain float64 solve is the other route):

1. solve  A X0 M' + M X0 A' + B B' = 0  to a loose tol (~1e-5);
2. the residual of the stored factors is exactly representable as a
   signed low-rank form
       R(X0) = U S U',  U = [A V0, W0, B],  W0 = M V0 (or V0),
       S = [[0, T0, 0], [T0, 0, 0], [0, 0, I]];
   compress it (CholQR2 + eigendecomposition of the projected S);
3. solve the correction equation  A X1 M' + M X1 A' + U2 S2 U2' = 0
   with the solver's signed-RHS mode (LyapunovSolver(b_sign=...)) to a
   loose *relative* tol - its absolute scale is already ~1e-5 smaller;
4. return the composed factors: X = V0 T0 V0' + V1 T1 V1', packaged as
   one (V, blockdiag(T)) pair with V = [V0 V1] (not orthonormal - the
   quadratic form X = V T V' does not require it).

Each stage works comfortably inside f32; the *composition* carries
~1e-10 relative residuals because the correction is stored separately
instead of being rounded into X0.  Verification must evaluate the
composed residual in f64 (host-side) - recombining in f32 would
reintroduce the floor this module exists to beat.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from rails_tpu.core.solver import LyapunovSolver, SolveInfo
from rails_tpu.core.options import SolverOptions
from rails_tpu.operators import LinearOperator, as_operator

__all__ = ["solve_refined", "RefineInfo", "residual_factor", "cholqr2"]


@dataclasses.dataclass
class RefineInfo:
    stages: list              # per-stage SolveInfo
    stage_res: list           # per-stage relative residual estimates
    res: float                # composed relative residual bound estimate
    converged: bool

    @property
    def iter(self) -> int:
        return sum(s.iter for s in self.stages)


def cholqr2(u: jax.Array, eps_rel: float = 0.0):
    """CholeskyQR2 orthonormalization of a tall-skinny block (GEMM-shaped:
    two Gram GEMMs + two tiny Cholesky factorizations).  Returns (q, r)
    with u = q r; rank deficiency is regularized by a relative shift."""
    def _one(w):
        g = w.T @ w
        g = 0.5 * (g + g.T)
        shift = (eps_rel if eps_rel > 0.0 else
                 10 * float(jnp.finfo(w.dtype).eps)) * jnp.trace(g)
        g = g + shift * jnp.eye(g.shape[0], dtype=w.dtype)
        c = jnp.linalg.cholesky(g)
        qw = jax.scipy.linalg.solve_triangular(
            c, w.T, lower=True).T
        return qw, c.T

    q1, r1 = _one(u)
    q2, r2 = _one(q1)
    return q2, r2 @ r1


def residual_factor(A: LinearOperator, M: Optional[LinearOperator],
                    b_arr: jax.Array, b_sign, v: jax.Array, t: jax.Array,
                    drop_rel: float = 1e-9):
    """Compress R(X0) = A V T V' M' + M V T V' A' + B S B' into (U2, S2)
    with U2 orthonormal and S2 diagonal (signed).

    Everything runs in f64 ON THE HOST (one O(m * nu) pull of the factor
    blocks per stage - same cost class as one SpMM; the refined driver
    targets accuracy-critical solves).  Two precision-critical moves:

    1. A V / M V are taken ERROR-FREE on device (``matmat2``: hi + lo =
       exact product) and recombined in f64.  A plain f32 A V rounds at
       eps * ||A V||, which is larger than the entire residual.
    2. Every stored matrix is a NUMERICALLY EVALUATED piece of R0 at
       R0's own scale: S_VV = V'R0V, Z = P_perp R0 V, and the
       perp-perp coefficients over an orthonormal complement basis Q.
       Any formulation that stores ||T||*||A||-sized blocks whose
       cancellation encodes the (1e5x smaller) residual hides real mass
       in Gram eigenvalues ~1e-14 that no f64 eigendecomposition can
       resolve - measured as an n-growing ~1e-2-relative floor.

    The f32 rounding of the returned basis is then *refit*: S2 is
    recomputed by f64 normal equations against the basis exactly as
    stored, so the reported rep_err is measured, not modeled."""
    k = v.shape[1]
    p = b_arr.shape[1]
    dtype = v.dtype

    def apply64(op):
        if op is None:
            return None
        if hasattr(op, "matmat2"):
            hi, lo = op.matmat2(v)
            return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        # no error-free apply: f32 rounding of this product becomes the
        # accuracy floor (~eps32 * ||op V|| / ||B B'||)
        return np.asarray(op.matmat(v), np.float64)

    import scipy.linalg as sla

    v64 = np.asarray(v, np.float64)
    b64 = np.asarray(b_arr, np.float64)
    t64 = np.asarray(t, np.float64)
    av64 = apply64(A)
    w64 = apply64(M) if M is not None else None
    # re-orthonormalize V in f64 (the f32-stored V is orthonormal only
    # to ~eps32, and the projector algebra below needs 1e-15):
    # V = Vq Rv, X0 = Vq (Rv T Rv') Vq' is an exact transformation
    vq, rv = np.linalg.qr(v64)
    tq = rv @ t64 @ rv.T
    avq = sla.solve_triangular(rv.T, av64.T, lower=True).T   # A @ Vq
    ga = vq.T @ avq
    ca = avq - vq @ ga                     # P_perp A Vq (exact to 1e-15)
    if M is not None:
        wq = sla.solve_triangular(rv.T, w64.T, lower=True).T
        gw = vq.T @ wq
        cw = wq - vq @ gw
    else:
        gw = np.eye(k)
        cw = None
    sp0 = np.eye(p) if b_sign is None else np.asarray(b_sign, np.float64)
    bv = vq.T @ b64
    bperp = b64 - vq @ bv
    # Every stored coefficient below is a NUMERICALLY EVALUATED piece of
    # R0 at R0's own scale (||S_VV||, ||Z|| <= ||R0||): the earlier
    # symbolic-S formulation kept ||T||*||A||-sized blocks (1e5 x ||R0||)
    # whose cancellation hid residual mass in Gram eigenvalues ~1e-14,
    # below what any f64 eigendecomposition resolves - measured as an
    # n-growing 1e-2-relative compression floor.
    s_vv = ga @ tq @ gw.T + gw @ tq @ ga.T + bv @ sp0 @ bv.T
    z = ca @ (tq @ gw.T) + bperp @ (sp0 @ bv.T)
    if cw is not None:
        z = z + cw @ (tq @ ga.T)
    # orthonormal complement basis Q spanning [Z, Ca, Cw, Bperp] via
    # rank-revealing QR of column-normalized blocks
    pool = [z, ca, bperp] if cw is None else [z, ca, cw, bperp]
    pool = np.concatenate(pool, axis=1)
    nrm = np.linalg.norm(pool, axis=0)
    pool = pool / np.where(nrm > 0, nrm, 1.0)[None, :]
    qq, rr, _ = sla.qr(pool, mode="economic", pivoting=True)
    rdiag = np.abs(np.diag(rr))
    qrank = int((rdiag > 1e-12 * max(rdiag[0], np.finfo(float).tiny)).sum())
    qmat = qq[:, :qrank]
    # coefficient matrix over the orthonormal X = [Vq, Q]
    cz = qmat.T @ z
    c_bp = qmat.T @ bperp
    nx = k + qrank
    s_x = np.zeros((nx, nx))
    s_x[:k, :k] = 0.5 * (s_vv + s_vv.T)
    s_x[k:, :k] = cz
    s_x[:k, k:] = cz.T
    s_perp = c_bp @ sp0 @ c_bp.T
    if cw is not None:
        c_ca = qmat.T @ ca
        c_cw = qmat.T @ cw
        cross = c_ca @ tq @ c_cw.T
        s_perp = s_perp + cross + cross.T
    s_x[k:, k:] = 0.5 * (s_perp + s_perp.T)
    x64 = np.concatenate([vq, qmat], axis=1)
    lam, w = np.linalg.eigh(s_x)
    order = np.argsort(-np.abs(lam))
    lam = lam[order]
    w = w[:, order]
    scale = max(abs(lam[0]), np.finfo(np.float64).tiny)
    keep = np.abs(lam) > drop_rel * scale
    u2_64 = x64 @ w[:, keep]               # f64 basis, THEN round once
    u2_32 = u2_64.astype(np.float32)
    # refit S2 to the rounded basis: Lam = H^-1 (U2' R0 U2) H^-1 with
    # U2' R0 U2 = K' S_X K, K = X' U2 - all intermediates at R0 scale
    u2r = u2_32.astype(np.float64)
    h = u2r.T @ u2r
    kmat = x64.T @ u2r
    core2 = kmat.T @ s_x @ kmat
    hinv = np.linalg.inv(h)
    lam2 = hinv @ core2 @ hinv
    lam2 = 0.5 * (lam2 + lam2.T)
    # measured representation error ||R0 - U2 Lam2 U2'||_F, evaluated
    # term by term at each term's own scale (any formula that cancels
    # large intermediates - e.g. tr(S G S G) - returns f64 noise here):
    #   - drop tail: exactly sqrt(sum of dropped core eigenvalues^2)
    #   - refit-vs-eigenweights drift: ||Lam2 - diag(lam_keep)||_F
    #   - f32 basis rounding delta (known explicitly): cross + square
    delta = u2r - u2_64
    drop_tail = float(np.sqrt((lam[~keep] ** 2).sum()))
    t_fit = float(np.linalg.norm(lam2 - np.diag(lam[keep])))
    c1 = u2_64 @ lam2
    dtd = delta.T @ delta
    t2 = np.sqrt(max(np.trace((c1.T @ c1) @ dtd), 0.0))
    t3 = np.sqrt(max(np.trace(lam2 @ dtd @ lam2 @ dtd), 0.0))
    rep_err = float(drop_tail + t_fit + 2.0 * t2 + t3)
    u2 = jnp.asarray(u2_32)
    r_norm2 = float(abs(lam[0])) if len(lam) else 0.0   # ||R0||_2
    return u2, jnp.asarray(lam2, dtype=dtype), rep_err, r_norm2


def solve_refined(a, b, m=None, *, tol: float = 1e-8,
                  stage_tol: float = 1e-5, max_stages: int = 3,
                  drop_rel: float = 1e-9, compiled: bool = False,
                  progress=None,
                  options: Optional[SolverOptions] = None, **opt_kwargs):
    """Solve A X M' + M X A' + B B' = 0 to ``tol`` relative residual via
    staged defect correction (see module docstring).

    Returns (V, T, RefineInfo) with X = V T V' where V concatenates the
    per-stage bases (NOT orthonormal) and T is block-diagonal.
    """
    A = as_operator(a)
    Mop = as_operator(m) if m is not None else None
    base = dataclasses.asdict(options) if options is not None else {}
    base.update(opt_kwargs)
    base.pop("tol", None)

    b_arr = jnp.asarray(b)
    if b_arr.ndim == 1:
        b_arr = b_arr[:, None]
    if "dtype" in base and base["dtype"] is not None:
        b_arr = b_arr.astype(base["dtype"])

    # normalization of the ORIGINAL equation, reused across stages
    solver0 = LyapunovSolver(A, b_arr, Mop,
                             tol=min(stage_tol, tol), **base)
    r0sq = float(solver0._b_norm2sq())

    vs, ts = [], []
    stages, stage_res = [], []
    cur_b, cur_sign = b_arr, None
    cur_scale = 1.0          # ||current RHS|| / ||B B'||
    drop_abs = 0.0           # accumulated compression-drop bound (rel)
    total = 1.0              # composed relative residual bound
    converged = False
    for stage in range(max_stages):
        # run at the looser of (stage_tol, what the composition needs):
        # early stages stay above the single-solve f32 floor, the last
        # stage only closes the remaining 1e-3-ish relative gap
        want = tol / max(cur_scale, np.finfo(np.float32).tiny)
        stage_tol_i = max(stage_tol, min(want, 0.5))
        solver = LyapunovSolver(A, cur_b, Mop, b_sign=cur_sign,
                                tol=stage_tol_i, **base)
        v_i, t_i, info = solver.solve(compiled=compiled,
                                      progress=progress)
        stages.append(info)
        vs.append(v_i)
        ts.append(t_i)
        total = float(info.res) * cur_scale + drop_abs
        stage_res.append(total)
        if total <= tol or not np.isfinite(total):
            converged = total <= tol
            break
        if stage == max_stages - 1:
            break
        # build the next stage's RHS: the residual of THIS stage's
        # equation (defect correction telescopes: summing the stage
        # solutions cancels each previous residual exactly, up to the
        # compression drop accounted in drop_abs)
        u2, s2, rep_err, r_norm = residual_factor(
            solver.A, solver.M, jnp.asarray(cur_b, dtype=v_i.dtype),
            cur_sign, v_i, t_i, drop_rel=drop_rel)
        cur_b, cur_sign = u2, s2
        drop_abs += rep_err / r0sq   # measured, not a bound
        cur_scale = r_norm / r0sq

    k_tot = sum(v.shape[1] for v in vs)
    dtype = vs[0].dtype
    v_cat = jnp.concatenate(vs, axis=1)
    t_cat = jnp.zeros((k_tot, k_tot), dtype=dtype)
    at = 0
    for t_i in ts:
        k_i = t_i.shape[0]
        t_cat = t_cat.at[at:at + k_i, at:at + k_i].set(t_i)
        at += k_i
    info = RefineInfo(stages=stages, stage_res=stage_res,
                      res=stage_res[-1], converged=converged)
    return v_cat, t_cat, info
