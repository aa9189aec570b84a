"""Compensated f32 reductions (utils/compensated.py) + solver wiring.

The reference attains its tolerances through float64 BLAS
(/root/reference/src/BlasWrapper.hpp:21-40); in a float32 solve the
``precision='compensated'`` option recovers the accuracy from f32
storage via error-free transforms.  These tests pin the accuracy gain
at the kernel level against a float64 oracle and check the solver-level
wiring preserves results and the masked-state invariants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rails_tpu.utils.compensated import dot2, gram2, sum2, two_prod, two_sum


@pytest.fixture
def rng():
    return np.random.default_rng(4634)


class TestPrimitives:
    def test_two_sum_exact(self, rng):
        a = jnp.float32(1.0)
        b = jnp.float32(1e-9)
        s, e = two_sum(a, b)
        # a + b is not representable in f32; s + e recovers it exactly
        assert float(s) == 1.0
        assert float(e) == pytest.approx(1e-9, rel=1e-6)

    def test_two_prod_exact(self, rng):
        a = jnp.asarray(rng.standard_normal(128), jnp.float32)
        b = jnp.asarray(rng.standard_normal(128), jnp.float32)
        p, e = two_prod(a, b)
        exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
        err = np.asarray(p, np.float64) + np.asarray(e, np.float64) - exact
        assert np.abs(err).max() == 0.0

    def test_sum2_cancellation(self):
        # alternating large/small terms: plain f32 sum loses everything
        n = 1 << 16
        big = np.full(n, 1.0e7, np.float32)
        x = np.empty(2 * n + 1, np.float32)
        x[0:2 * n:2] = big
        x[1:2 * n:2] = -big
        x[-1] = 1.0
        ref = 1.0
        comp = float(sum2(jnp.asarray(x)))
        assert comp == pytest.approx(ref, rel=1e-6)


class TestDotGram:
    def test_dot2_accuracy(self, rng):
        m = 1 << 18
        x = (rng.standard_normal(m) * np.exp(rng.standard_normal(m)))
        y = (rng.standard_normal(m) * np.exp(rng.standard_normal(m)))
        x32, y32 = x.astype(np.float32), y.astype(np.float32)
        ref = np.dot(x32.astype(np.float64), y32.astype(np.float64))
        comp = float(dot2(jnp.asarray(x32), jnp.asarray(y32)))
        # full working-precision accuracy (a few ulps)
        assert abs(comp - ref) / abs(ref) < 1e-6

    def test_gram2_beats_plain(self, rng):
        m, a, b = 1 << 18, 4, 6
        scale = np.exp(rng.standard_normal((m, 1)))
        x = (rng.standard_normal((m, a)) * scale).astype(np.float32)
        w = (rng.standard_normal((m, b)) * scale).astype(np.float32)
        ref = x.astype(np.float64).T @ w.astype(np.float64)
        nref = np.abs(ref).max()
        plain = np.asarray(jnp.asarray(x).T @ jnp.asarray(w), np.float64)
        comp = np.asarray(gram2(jnp.asarray(x), jnp.asarray(w)), np.float64)
        err_plain = np.abs(plain - ref).max() / nref
        err_comp = np.abs(comp - ref).max() / nref
        assert err_comp < 5e-6
        assert err_comp <= err_plain

    def test_gram2_matches_shapes(self, rng):
        # odd m exercises the zero-padding path
        x = jnp.asarray(rng.standard_normal((1537, 3)), jnp.float32)
        w = jnp.asarray(rng.standard_normal((1537, 5)), jnp.float32)
        ref = np.asarray(x, np.float64).T @ np.asarray(w, np.float64)
        comp = np.asarray(gram2(x, w, chunk=256), np.float64)
        assert np.abs(comp - ref).max() < 1e-4

    def test_zero_columns_stay_exactly_zero(self, rng):
        # the solver's masked-buffer invariant: inactive (zero) columns
        # must produce exactly-zero Gram rows/cols
        x = jnp.asarray(rng.standard_normal((2048, 4)), jnp.float32)
        x = x.at[:, 2:].set(0.0)
        g = np.asarray(gram2(x, x))
        assert np.all(g[2:, :] == 0.0) and np.all(g[:, 2:] == 0.0)
        d = np.asarray(dot2(x, x[:, 3]))
        assert np.all(d == 0.0)


class TestSolverWiring:
    def test_compensated_solver_f32(self, rng):
        # 1D Laplacian, f32: compensated must converge to the same
        # solution as standard (and not break the masked invariants)
        import scipy.sparse as sps

        from rails_tpu import solve
        from rails_tpu.sparse.formats import sparse_from_scipy

        n = 256
        lap = sps.diags([1.0, -2.0, 1.0], [-1, 0, 1],
                        shape=(n, n)).tocsr() * (n + 1) ** 2 / 1e4
        a = sparse_from_scipy(lap, is_symmetric=True, is_hurwitz=True)
        b = jnp.asarray(rng.standard_normal((n, 1)), jnp.float32)
        # this problem needs ~218 iterations even at float64
        v1, t1, info1 = solve(a, b, tol=1e-3, dtype=jnp.float32, maxit=300,
                              precision="compensated")
        assert info1.converged
        v64 = np.asarray(v1, np.float64)
        t64 = np.asarray(t1, np.float64)
        x = v64 @ t64 @ v64.T
        r = lap.toarray() @ x + x @ lap.toarray().T \
            + np.asarray(b, np.float64) @ np.asarray(b, np.float64).T
        bb = float((b.T @ b)[0, 0])
        assert np.linalg.norm(r, 2) / bb < 5e-3

    def test_invalid_precision_rejected(self):
        from rails_tpu.core.options import InvalidOption, SolverOptions
        with pytest.raises(InvalidOption):
            SolverOptions(precision="double")
