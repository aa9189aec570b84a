"""Schur path + IO + MOC end-to-end (test_MOC.m mirror) + eigs tests."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import rails_tpu
from rails_tpu import io as rio
from rails_tpu.eigs import eigs
from rails_tpu.schur import schur_reduce

HAVE_DATA = os.path.isdir(rio.REFERENCE_DATAERIK)


def small_dae(rng, n=40, nsing=15):
    """Random index-1-ish DAE: A with SPD-ish structure, M singular diag."""
    a = rng.uniform(-1, 1, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.2)
    a = a - 3.0 * np.eye(n)
    mdiag = rng.uniform(0.5, 1.5, n)
    sing = rng.permutation(n)[:nsing]
    mdiag[sing] = 0.0
    b = rng.uniform(-1, 1, (n, 2))
    b[sing] = 0.0
    return sp.csr_matrix(a), mdiag, b


class TestSchurReduction:
    @pytest.mark.parametrize("a11_solver,atol", [
        ("dense_lu", 1e-10), ("native_lu", 1e-10),
        # iterative: Jacobi-BiCGStab to ~30*eps relative; the Schur apply
        # then matches to a looser but still tight tolerance
        ("iterative", 1e-7),
    ])
    def test_operator_matches_dense(self, rng, a11_solver, atol):
        a, mdiag, b = small_dae(rng)
        red = schur_reduce(a, mdiag, b, a11_solver=a11_solver)
        ad = a.toarray()
        i1, i2 = red.idx1, red.idx2
        s_dense = ad[np.ix_(i2, i2)] - ad[np.ix_(i2, i1)] @ np.linalg.solve(
            ad[np.ix_(i1, i1)], ad[np.ix_(i1, i2)])
        x = jnp.asarray(rng.uniform(-1, 1, (red.n2, 3)))
        y = np.asarray(red.operator.matmat(x))
        assert np.allclose(y, s_dense @ np.asarray(x), atol=atol)
        yt = np.asarray(red.operator.rmatmat(x))
        assert np.allclose(yt, s_dense.T @ np.asarray(x), atol=atol)

    def test_iterative_a11_is_jittable(self, rng):
        # the whole point: the iterative Schur apply stays on device and
        # compiles (no host callback, no dense factor)
        import jax
        a, mdiag, b = small_dae(rng)
        red = schur_reduce(a, mdiag, b, a11_solver="iterative")
        x = jnp.asarray(rng.uniform(-1, 1, (red.n2, 2)))
        op = red.operator
        y = jax.jit(lambda v: op.matmat(v))(x)
        y2 = red.operator.matmat(x)
        assert np.allclose(np.asarray(y), np.asarray(y2), atol=1e-9)

    def test_a11_residual_check(self, rng):
        # the iterative path's post-hoc convergence diagnostic (ADVICE
        # r02): a converged BiCGStab reports a residual within its
        # tolerance; the check also covers the transpose solve
        a, mdiag, b = small_dae(rng)
        red = schur_reduce(a, mdiag, b, a11_solver="iterative")
        res, res_t = red.a11_residual_check()
        assert res < 10 * red._a11_tol_eff
        assert res_t < 10 * red._a11_tol_eff
        # direct path: exact to working precision
        red_d = schur_reduce(a, mdiag, b, a11_solver="dense_lu")
        res_d, _ = red_d.a11_residual_check()
        assert res_d < 1e-10

    def test_b_restriction_warning(self, rng):
        a, mdiag, b = small_dae(rng)
        b2 = b.copy()
        b2[red_idx1_first(a, mdiag)] = 1.0
        with pytest.warns(UserWarning, match="singular part"):
            red = schur_reduce(a, mdiag, b2)
        # restricted BS = B2 - A21 A11^{-1} B1
        ad = a.toarray()
        i1, i2 = red.idx1, red.idx2
        expected = b2[i2] - ad[np.ix_(i2, i1)] @ np.linalg.solve(
            ad[np.ix_(i1, i1)], b2[i1])
        assert np.allclose(np.asarray(red.bs), expected, atol=1e-10)

    def test_sinv(self, rng):
        a, mdiag, b = small_dae(rng)
        red = schur_reduce(a, mdiag, b)
        sinv = red.sinv()
        x = jnp.asarray(rng.uniform(-1, 1, (red.n2, 2)))
        y = sinv(x)
        # S @ y == x
        assert np.allclose(np.asarray(red.operator.matmat(y)),
                           np.asarray(x), atol=1e-8)

    def test_vtrans_roundtrip(self, rng):
        a, mdiag, b = small_dae(rng)
        red = schur_reduce(a, mdiag, b)
        v = jnp.asarray(rng.uniform(-1, 1, (red.n2, 3)))
        vfull = red.vtrans(v)
        assert vfull.shape == (red.n, 3)
        # prolongate puts v on the dynamic rows
        assert np.allclose(np.asarray(vfull)[red.idx2], np.asarray(v))
        # restrict(prolongate(v)) == v + A21 A11^{-1} A11^{-1}... no:
        # restrict uses x2 - A21 A11^{-1} x1; with x1 = -A11^{-1} A12 v:
        # = v + A21 A11^{-1} A11^{-1}?  Just check against dense algebra:
        ad = a.toarray()
        i1, i2 = red.idx1, red.idx2
        x1 = -np.linalg.solve(ad[np.ix_(i1, i1)],
                              ad[np.ix_(i1, i2)] @ np.asarray(v))
        r = np.asarray(v) - ad[np.ix_(i2, i1)] @ np.linalg.solve(
            ad[np.ix_(i1, i1)], x1)
        assert np.allclose(np.asarray(red.restrict(vfull)), r, atol=1e-10)

    def test_trace_and_solution_operator(self, rng):
        a, mdiag, b = small_dae(rng)
        red = schur_reduce(a, mdiag, b)
        k = 4
        v = np.linalg.qr(rng.uniform(-1, 1, (red.n2, k)))[0]
        t = rng.uniform(-1, 1, (k, k))
        t = t + t.T
        ad = a.toarray()
        i1, i2 = red.idx1, red.idx2
        a11i = np.linalg.inv(ad[np.ix_(i1, i1)])
        x22 = v @ t @ v.T
        x12 = -a11i @ ad[np.ix_(i1, i2)] @ x22
        x11 = -(-a11i @ ad[np.ix_(i1, i2)]) @ x22 @ \
            (ad[np.ix_(i1, i2)].T @ a11i.T)
        xfull = np.zeros((red.n, red.n))
        xfull[np.ix_(i2, i2)] = x22
        xfull[np.ix_(i1, i2)] = x12
        xfull[np.ix_(i2, i1)] = x12.T
        xfull[np.ix_(i1, i1)] = x11  # X11 = +A11^{-1}A12 X22 A12' A11^{-T}
        assert np.allclose(float(red.trace(jnp.asarray(v), jnp.asarray(t))),
                           np.trace(xfull), atol=1e-8)
        sop = red.solution_operator(jnp.asarray(v), jnp.asarray(t))
        x = rng.uniform(-1, 1, (red.n, 2))
        assert np.allclose(np.asarray(sop.matmat(jnp.asarray(x))),
                           xfull @ x, atol=1e-8)


def red_idx1_first(a, mdiag):
    return np.flatnonzero(np.abs(mdiag) < 1e-12)[0]


class TestEigs:
    def test_dense_symmetric(self, rng):
        n = 100
        a = rng.uniform(-1, 1, (n, n))
        a = a + a.T
        op = rails_tpu.DenseOperator(jnp.asarray(a), is_symmetric=True)
        evals, evecs = eigs(op, num=5, tol=1e-10)
        true = np.linalg.eigvalsh(a)
        true = true[np.argsort(-np.abs(true))][:5]
        assert np.allclose(np.sort(np.asarray(evals)), np.sort(true),
                           atol=1e-7)
        r = a @ np.asarray(evecs) - np.asarray(evecs) * np.asarray(evals)
        assert np.abs(r).max() < 1e-6

    def test_low_rank_operator(self, rng):
        # eigenvalues of V T V' (the solution-operator analysis use case)
        n, k = 200, 6
        v = np.linalg.qr(rng.uniform(-1, 1, (n, k)))[0]
        t = np.diag([5.0, -3.0, 2.0, 1.0, 0.5, 0.1])
        op = rails_tpu.CallableOperator(
            lambda x: jnp.asarray(v) @ (jnp.asarray(t) @ (jnp.asarray(v).T @ x)),
            (n, n), is_symmetric=True)
        evals, evecs = eigs(op, num=4, tol=1e-9)
        assert np.allclose(np.sort(np.abs(np.asarray(evals)))[::-1],
                           [5.0, 3.0, 2.0, 1.0], atol=1e-7)

    def test_drop_tol(self, rng):
        n = 80
        d = np.concatenate([[10.0, 5.0], np.full(n - 2, 1e-6)])
        op = rails_tpu.DiagonalOperator(jnp.asarray(d))
        evals, evecs = eigs(op, num=6, tol=1e-8, drop_tol=1e-4)
        assert len(np.asarray(evals)) == 2


class TestIO:
    def test_matrix_market_roundtrip(self, rng, tmp_path):
        a = sp.random(30, 20, density=0.2, random_state=3, format="csr")
        path = str(tmp_path / "a.mtx")
        rio.write_matrix_market(path, a)
        a2 = rio.read_matrix_market(path)
        assert np.allclose(a2.toarray(), a.toarray())

    def test_dense_roundtrip(self, rng, tmp_path):
        v = rng.uniform(-1, 1, (12, 4))
        path = str(tmp_path / "v.mtx")
        rio.write_matrix_market(path, v)
        v2 = rio.read_matrix_market(path)
        assert np.allclose(np.asarray(v2), v)

    @pytest.mark.skipif(not HAVE_DATA, reason="DataErik not mounted")
    def test_dataerik_load(self):
        a, mdiag, f = rio.load_dataerik()
        assert a.shape == (1536, 1536)
        assert a.nnz == 17364
        assert len(mdiag) == 1536

    @pytest.mark.skipif(not HAVE_DATA, reason="DataErik not mounted")
    def test_moc_preprocessing(self):
        a, m, b = rio.load_moc_problem()
        n = a.shape[0]
        assert n == 8 * 8 * 4 * 6
        j = np.arange(n)
        md = np.asarray(m.diagonal()).ravel()
        assert (md[(j % 6) <= 3] == 0).all()
        assert (b[(j % 6) <= 4] == 0).all()


@pytest.mark.skipif(not HAVE_DATA, reason="DataErik not mounted")
class TestMOC:
    """test_MOC.m mirror: the real ocean problem through the Schur path."""

    def setup_method(self, method):
        a, m, b = rio.load_moc_problem()
        border = rio.moc_border(a.shape[0])
        self.a2, self.m2, self.b2 = rio.add_border(a, m, b, border)
        self.a, self.m, self.b = a, m, b

    def run_moc(self, **solver_kw):
        red = schur_reduce(self.a2, self.m2, self.b2)
        v, t, info = rails_tpu.solve(
            red.operator, jnp.asarray(red.bs), red.ms,
            maxit=1000, tol=1e-3, **solver_kw)
        # reduced-space true residual (Frobenius), test_MOC.m:27-28
        sv = np.asarray(red.operator.matmat(v))
        ms = np.diag(np.asarray(red.ms_diag))
        vn, tn = np.asarray(v), np.asarray(t)
        bs = np.asarray(red.bs)
        r = sv @ tn @ (vn.T @ ms.T) + (ms @ vn) @ (sv @ tn).T + bs @ bs.T
        assert np.linalg.norm(r, "fro") < 1e-3
        # full-space residual (test_MOC.m:30-35)
        vfull = np.asarray(red.vtrans(v))
        n = self.a.shape[0]
        vfull = vfull[:n]
        ad = self.a.toarray()
        md = self.m.toarray()
        bb = np.asarray(self.b)
        x = vfull @ tn @ vfull.T
        rfull = ad @ x @ md.T + md @ x @ ad.T + bb @ bb.T
        assert np.linalg.norm(rfull, "fro") < 1e-3
        return red, v, t, info

    def test_moc_erik(self):
        self.run_moc()

    def test_moc_inv(self):
        # test_MOC.m test_MOC_inv: projection_method 2.2 with Sinv
        red0 = schur_reduce(self.a2, self.m2, self.b2)
        self.run_moc(projection_method=2.2, inv_a=red0.sinv())

    def test_moc_factorize(self):
        # test_MOC.m test_MOC_factorize: RAILSschur(A, M, B, true)
        # pre-factorizes the Sinv LU at reduction time
        red0 = schur_reduce(self.a2, self.m2, self.b2, factorize_sinv=True)
        assert red0._sinv_factors is not None
        self.run_moc(projection_method=2.2, inv_a=red0.sinv())

    def test_moc_sinv_native(self):
        # native sparse-LU Sinv matches the dense-LU Sinv
        red0 = schur_reduce(self.a2, self.m2, self.b2)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.uniform(-1, 1, (red0.n2, 3)))
        y_dense = np.asarray(red0.sinv()(x))
        y_native = np.asarray(red0.sinv(method="native_lu")(x))
        np.testing.assert_allclose(y_native, y_dense, rtol=1e-8, atol=1e-10)


class TestEigsGeneral:
    def test_nonsymmetric(self, rng):
        from rails_tpu.eigs import eigs_general
        n = 80
        a = rng.uniform(-1, 1, (n, n))
        op = rails_tpu.DenseOperator(jnp.asarray(a))
        evals, evecs = eigs_general(op, num=3)
        true = np.linalg.eigvals(a)
        true = true[np.argsort(-np.abs(true))][:3]
        d = np.abs(np.asarray(evals)[:, None] - true[None, :])
        assert d.min(axis=1).max() < 1e-6
        # residual check
        av = a @ np.asarray(evecs)
        r = av - np.asarray(evecs) * np.asarray(evals)[None, :]
        assert np.linalg.norm(r, axis=0).max() < 1e-5

    def test_dominant_eigenvector_use_case(self, rng):
        # the test_random.m B = eigs(A, 1) use case
        from rails_tpu.eigs import eigs_general
        from rails_tpu.models.problems import random_sparse
        n = 64
        a = random_sparse(rng, n)
        op = rails_tpu.DenseOperator(jnp.asarray(a))
        evals, evecs = eigs_general(op, num=1)
        b = np.real(np.asarray(evecs[:, 0])).copy()
        b /= np.linalg.norm(b)
        v, t, info = rails_tpu.solve(jnp.asarray(a), jnp.asarray(b[:, None]),
                                     maxit=64)
        assert info.converged
        assert info.iter < 10


@pytest.mark.skipif(not HAVE_DATA, reason="DataErik not mounted")
def test_moc_hurwitz_sign_path(rng):
    """The MOC Schur pencil is stable (verified: max Re(lambda) ~ -0.0054),
    so the hurwitz tag routes the projected solves through the Newton sign
    iteration - the fast path for this nonsymmetric problem."""
    a, m, b = rio.load_moc_problem()
    a2, m2, b2 = rio.add_border(a, m, b, rio.moc_border(a.shape[0]))
    red = schur_reduce(a2, m2, b2, hurwitz=True)
    assert red.operator.is_hurwitz
    solver = rails_tpu.LyapunovSolver(
        red.operator, jnp.asarray(red.bs), red.ms, maxit=1000, tol=1e-3)
    assert solver._resolve_lyap_method()[0] == "sign"
    v, t, info = solver.solve()
    assert info.converged
