"""Sparse format tests + the backend contract suite.

The contract tests play the role of the reference's generic typed-test
suites (GenericOperatorWrapper_test.cpp / GenericMultiVectorWrapper_test
.cpp): every operator backend must behave identically on the same
matrix, which is what guarantees the solver can host any backend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import rails_tpu
from rails_tpu.models.problems import laplacian2, random_sparse
from rails_tpu.sparse.formats import (
    sparse_from_dense,
    sparse_from_scipy,
    sparse_from_csr,
)


def make_backends(a_dense, **tags):
    """The same matrix as every operator backend."""
    return {
        "dense": rails_tpu.DenseOperator(jnp.asarray(a_dense), **tags),
        "dia": sparse_from_dense(a_dense, fmt="dia", **tags),
        "ell": sparse_from_dense(a_dense, fmt="ell", **tags),
        "callable": rails_tpu.CallableOperator(
            lambda x, a=jnp.asarray(a_dense): a @ x,
            a_dense.shape,
            rfn=lambda x, a=jnp.asarray(a_dense): a.T @ x, **tags),
    }


class TestFormatCorrectness:
    @pytest.mark.parametrize("kind", ["tridiag", "laplace", "random",
                                      "rect_tall", "rect_wide"])
    def test_matmat_matches_dense(self, rng, kind):
        if kind == "tridiag":
            a = np.diag(rng.uniform(-1, 1, 30)) \
                + np.diag(rng.uniform(-1, 1, 29), 1) \
                + np.diag(rng.uniform(-1, 1, 29), -1)
        elif kind == "laplace":
            a = laplacian2(64)
        elif kind == "random":
            a = random_sparse(rng, 50)
        elif kind == "rect_tall":
            a = np.zeros((40, 25))
            a[rng.integers(0, 40, 60), rng.integers(0, 25, 60)] = \
                rng.uniform(-1, 1, 60)
        else:
            a = np.zeros((25, 40))
            a[rng.integers(0, 25, 60), rng.integers(0, 40, 60)] = \
                rng.uniform(-1, 1, 60)
        x = rng.uniform(-1, 1, (a.shape[1], 3))
        xt = rng.uniform(-1, 1, (a.shape[0], 3))
        for fmt in ("dia", "ell"):
            op = sparse_from_dense(a, fmt=fmt)
            assert np.allclose(np.asarray(op.matmat(jnp.asarray(x))),
                               a @ x, atol=1e-12), fmt
            assert np.allclose(np.asarray(op.rmatmat(jnp.asarray(xt))),
                               a.T @ xt, atol=1e-12), fmt

    def test_auto_format_selection(self, rng):
        lap = sparse_from_dense(laplacian2(64))
        assert lap.format == "dia"
        rnd = sparse_from_dense(random_sparse(rng, 100))
        assert rnd.format == "ell"

    def test_symmetric_detection(self):
        lap = sparse_from_dense(laplacian2(64))
        assert lap.is_symmetric
        assert lap.bwd is None

    def test_from_csr(self, rng):
        a = sp.random(37, 37, density=0.1, random_state=42, format="csr")
        op = sparse_from_csr(a.indptr, a.indices, a.data)
        x = rng.uniform(-1, 1, (37, 2))
        assert np.allclose(np.asarray(op.matmat(jnp.asarray(x))),
                           a @ x, atol=1e-12)
        assert op.nnz == a.nnz

    def test_under_jit(self, rng):
        """Sparse operators are pytrees: pass through jit as arguments."""
        a = laplacian2(64)
        op = sparse_from_dense(a)

        @jnp.vectorize
        def _noop(x):
            return x

        import jax

        @jax.jit
        def apply(op, x):
            return op.matmat(x)

        x = jnp.asarray(rng.uniform(-1, 1, (64, 2)))
        assert np.allclose(np.asarray(apply(op, x)), a @ np.asarray(x),
                           atol=1e-12)


class TestBackendContract:
    """Identical behavior across all operator backends on one matrix
    (GenericOperatorWrapper_test role)."""

    @pytest.fixture
    def problem(self, rng):
        a = laplacian2(64) + np.diag(rng.uniform(0, 0.1, 64))
        x = rng.uniform(-1, 1, (64, 4))
        return a, x

    def test_matmat_agree(self, problem):
        a, x = problem
        results = {name: np.asarray(op.matmat(jnp.asarray(x)))
                   for name, op in make_backends(a).items()}
        ref = results.pop("dense")
        for name, r in results.items():
            assert np.allclose(r, ref, atol=1e-12), name

    def test_rmatmat_agree(self, problem):
        a, x = problem
        results = {name: np.asarray(op.rmatmat(jnp.asarray(x)))
                   for name, op in make_backends(a).items()}
        ref = results.pop("dense")
        for name, r in results.items():
            assert np.allclose(r, ref, atol=1e-12), name

    def test_norm_agree(self, problem):
        a, _ = problem
        true = np.linalg.norm(a, 2)
        for name, op in make_backends(a).items():
            est = float(rails_tpu.operator_norm2(op, iters=100))
            assert abs(est - true) / true < 1e-6, name

    def test_astype_casts_payloads(self, problem):
        """Operators built at float64 (scipy default) must cast cleanly
        to the solve dtype (f32 solves of f64-built operators)."""
        a, x = problem
        x32 = jnp.asarray(x, jnp.float32)
        for name, op in make_backends(a).items():
            op32 = op.astype(jnp.float32)
            y = op32.matmat(x32)
            yr = op32.rmatmat(x32)
            if name != "callable":  # matrix-free output follows operand
                assert y.dtype == jnp.float32, name
                assert yr.dtype == jnp.float32, name
            assert np.allclose(np.asarray(y, np.float64), a @ x,
                               atol=1e-3), name
            assert np.allclose(np.asarray(yr, np.float64), a.T @ x,
                               atol=1e-3), name
            # idempotent: casting to the same dtype returns self
            assert op32.astype(jnp.float32) is op32, name

    def test_solver_casts_f64_operator_to_f32(self, rng):
        """solve(dtype=f32) of an operator built at f64 must not carry
        mixed-dtype contractions (the f32 deployment shape)."""
        import warnings as _warnings

        a = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], (64, 64)).tocsr()
        aop = sparse_from_scipy(a, is_symmetric=True)  # f64 payload
        b = jnp.asarray(rng.standard_normal((64, 1)), jnp.float32)
        with _warnings.catch_warnings():
            _warnings.simplefilter("error", FutureWarning)
            v, t, info = rails_tpu.solve(aop, b, tol=1e-5,
                                         dtype=jnp.float32, maxit=80)
        assert info.converged
        assert v.dtype == jnp.float32

    def test_solver_hosts_every_backend(self, rng, problem):
        """The solver converges identically on every backend - the
        reference's core architectural guarantee (same Solver template,
        any wrapper; LyapunovSolver_test + LyapunovSolverEpetra_test)."""
        a, _ = problem
        a = a - 0.2 * np.eye(64)
        b = jnp.asarray(rng.uniform(0, 1, (64, 1)))
        results = {}
        for name, op in make_backends(a, is_symmetric=True).items():
            v, t, info = rails_tpu.solve(op, b, tol=1e-6, seed=7)
            assert info.converged, name
            results[name] = (info.iter, np.asarray(v) @ np.asarray(t)
                             @ np.asarray(v).T)
        iters = {name: r[0] for name, r in results.items()}
        assert len(set(iters.values())) == 1, iters
        xs = [r[1] for r in results.values()]
        for xo in xs[1:]:
            assert np.allclose(xs[0], xo, atol=1e-8)


def _banded_random(rng, m, ell_l, band, n=None):
    """Random banded matrix: ``ell_l`` column picks per row within
    +-band of the (scaled) diagonal."""
    n = m if n is None else n
    base = np.arange(m)
    idx = base[:, None] * (n / m) + rng.integers(
        -band, band + 1, size=(m, ell_l))
    idx = np.clip(idx, 0, n - 1).astype(np.int64)
    val = rng.uniform(-1, 1, size=(m, ell_l))
    rows = np.repeat(base, ell_l)
    return sp.coo_matrix((val.ravel(), (rows, idx.ravel())),
                         shape=(m, n)).tocsr()


def _jittered_stencil(rng, m, offsets, jitter=4):
    """Stencil with per-entry index jitter - the post-RCM mesh shape."""
    base = np.arange(m)
    idx = base[:, None] + np.asarray(offsets)[None, :] + rng.integers(
        -jitter, jitter + 1, size=(m, len(offsets)))
    idx = np.clip(idx, 0, m - 1)
    val = rng.uniform(-1, 1, size=idx.shape)
    rows = np.repeat(base, len(offsets))
    return sp.coo_matrix((val.ravel(), (rows, idx.ravel())),
                         shape=(m, m)).tocsr()


def _dia_dense(data, offsets, shape):
    """Dense oracle of a DIA payload: A[i, i + off_k] = data[k, i] for
    the in-range entries (entries outside the matrix are ignored)."""
    m, n = shape
    a = np.zeros(shape)
    for k, off in enumerate(offsets):
        for i in range(max(0, -off), min(m, n - off)):
            a[i, i + off] = data[k, i]
    return a


class TestDiaApply:
    """The plain DIA apply (one fused expression over a padded operand)
    against a dense oracle, across the shapes the solver produces."""

    @pytest.mark.parametrize("m,n,offsets,s", [
        (2048, 2048, (-33, -1, 0, 1, 33), 1),     # Lanczos vector width
        (2048, 2048, (-33, -1, 0, 1, 33), 6),     # expand block
        (2048, 2048, (-33, -1, 0, 1, 33), 13),    # odd width
        (1100, 1100, (-40, -1, 0, 2, 33), 3),     # asymmetric stencil
        (1024, 1024, (-130, -1, 0, 2, 130), 5),   # span > 128 rows
        (500, 500, (0, 1, 7), 4),                 # upper-only offsets
        (500, 500, (-9, -2), 4),                  # lower-only offsets
        (600, 400, (-250, -3, 0, 5), 3),          # tall rectangular
        (400, 600, (0, 3, 150), 3),               # wide rectangular
    ])
    def test_matches_dense(self, rng, m, n, offsets, s):
        from rails_tpu.sparse.formats import DiaMatrix

        data = rng.uniform(-1, 1, (len(offsets), m))
        x = rng.uniform(-1, 1, (n, s))
        y = DiaMatrix(jnp.asarray(data), offsets, (m, n)).matmat(
            jnp.asarray(x))
        assert y.shape == (m, s)
        np.testing.assert_allclose(np.asarray(y),
                                   _dia_dense(data, offsets, (m, n)) @ x,
                                   atol=1e-12)

    def test_vector_operand(self, rng):
        from rails_tpu.sparse.formats import DiaMatrix

        offsets = (-5, 0, 3)
        data = rng.uniform(-1, 1, (3, 64))
        x = rng.uniform(-1, 1, 64)
        y = DiaMatrix(jnp.asarray(data), offsets, (64, 64)).matmat(
            jnp.asarray(x))
        assert y.shape == (64,)
        np.testing.assert_allclose(np.asarray(y),
                                   _dia_dense(data, offsets, (64, 64)) @ x,
                                   atol=1e-12)

    def test_out_of_range_data_is_ignored(self, rng):
        """Data rows whose column falls outside the matrix multiply the
        zero padding, exactly as if they were absent."""
        from rails_tpu.sparse.formats import DiaMatrix

        offsets = (-7, 0, 7)
        data = rng.uniform(-1, 1, (3, 100))
        clean = data.copy()
        clean[0, :7] = 0.0
        clean[2, -7:] = 0.0
        x = jnp.asarray(rng.uniform(-1, 1, (100, 2)))
        y = DiaMatrix(jnp.asarray(data), offsets, (100, 100)).matmat(x)
        y0 = DiaMatrix(jnp.asarray(clean), offsets, (100, 100)).matmat(x)
        np.testing.assert_array_equal(np.asarray(y), np.asarray(y0))

    def test_output_follows_operand_dtype(self, rng):
        from rails_tpu.sparse.formats import DiaMatrix

        data = jnp.asarray(rng.uniform(-1, 1, (3, 64)))  # float64
        x = jnp.asarray(rng.uniform(-1, 1, (64, 2)), jnp.float32)
        y = DiaMatrix(data, (-1, 0, 1), (64, 64)).matmat(x)
        assert y.dtype == jnp.float32

    def test_from_scipy_roundtrip(self, rng):
        """sparse_from_scipy's vectorized DIA packing inverts exactly
        through payload_to_scipy, both orientations."""
        from rails_tpu.sparse.formats import payload_to_scipy

        for shape in ((300, 200), (200, 300)):
            a = sp.random(*shape, density=0.02, random_state=3,
                          format="csr")
            a = a + sp.eye(*shape, k=5) * 0.5
            op = sparse_from_scipy(a.tocsr(), fmt="dia")
            back = payload_to_scipy(op.fwd)
            assert abs(back - a).max() < 1e-15


class TestEllApply:
    """The plain ELL apply (one gather + fused multiply-add per slot)
    against scipy, across banded, jittered, random and rectangular
    sparsity."""

    @pytest.mark.parametrize("m,ell_l,band", [
        (1024, 7, 60),
        (1100, 5, 33),      # m not a power of two
        (512, 13, 150),     # wide band
    ])
    def test_banded_matches_scipy(self, rng, m, ell_l, band):
        a = _banded_random(rng, m, ell_l, band)
        op = sparse_from_scipy(a, fmt="ell", dtype=jnp.float32)
        x = jnp.asarray(rng.uniform(-1, 1, (m, 4)), dtype=jnp.float32)
        np.testing.assert_allclose(np.asarray(op.matmat(x)),
                                   a @ np.asarray(x), atol=1e-4)

    @pytest.mark.parametrize("s", [1, 3, 8])
    def test_operand_widths(self, rng, s):
        a = _banded_random(rng, 512, 5, 40)
        op = sparse_from_scipy(a, fmt="ell")
        x = jnp.asarray(rng.uniform(-1, 1, (512, s)))
        y = op.matmat(x)
        assert y.shape == (512, s)
        np.testing.assert_allclose(np.asarray(y), a @ np.asarray(x),
                                   atol=1e-12)

    @pytest.mark.parametrize("m,n", [(512, 1024), (1024, 512)])
    def test_rectangular(self, rng, m, n):
        a = _banded_random(rng, m, 5, 40, n=n)
        op = sparse_from_scipy(a, fmt="ell")
        x = jnp.asarray(rng.uniform(-1, 1, (n, 3)))
        xt = jnp.asarray(rng.uniform(-1, 1, (m, 3)))
        np.testing.assert_allclose(np.asarray(op.matmat(x)),
                                   a @ np.asarray(x), atol=1e-12)
        np.testing.assert_allclose(np.asarray(op.rmatmat(xt)),
                                   a.T @ np.asarray(xt), atol=1e-12)

    @pytest.mark.parametrize("m,offsets", [
        (1024, (-130, -60, -1, 0, 1, 59, 131)),
        (1100, (-40, 0, 41, 97, 160)),
    ])
    def test_jittered_stencil(self, rng, m, offsets):
        a = _jittered_stencil(rng, m, offsets)
        op = sparse_from_scipy(a, fmt="ell")
        x = jnp.asarray(rng.uniform(-1, 1, (m, 4)))
        np.testing.assert_allclose(np.asarray(op.matmat(x)),
                                   a @ np.asarray(x), atol=1e-12)

    def test_random_sparsity(self, rng):
        a = sp.random(4096, 4096, density=0.002, random_state=7,
                      format="csr")
        op = sparse_from_scipy(a, fmt="ell")
        x = jnp.asarray(rng.uniform(-1, 1, (4096, 2)))
        np.testing.assert_allclose(np.asarray(op.matmat(x)),
                                   a @ np.asarray(x), atol=1e-12)

    def test_empty_rows_pad_row_local(self, rng):
        """Empty rows and short rows pad with values 0 and row-local
        indices, so a row slab's column span stays tight."""
        a = sp.lil_matrix((64, 64))
        for i in range(0, 64, 3):
            a[i, max(i - 2, 0)] = 1.0
            if i % 2:
                a[i, min(i + 2, 63)] = 2.0
        op = sparse_from_scipy(a.tocsr(), fmt="ell")
        idx = np.asarray(op.fwd.indices)
        assert np.abs(idx - np.arange(64)[:, None]).max() <= 2
        x = jnp.asarray(rng.uniform(-1, 1, (64, 2)))
        np.testing.assert_allclose(np.asarray(op.matmat(x)),
                                   a @ np.asarray(x), atol=1e-12)

    def test_astype_casts_values(self, rng):
        a = _banded_random(rng, 512, 5, 30)
        op = sparse_from_scipy(a, fmt="ell", dtype=jnp.float64)
        op32 = op.astype(jnp.float32)
        assert op32.fwd.values.dtype == jnp.float32
        assert op32.fwd.indices is op.fwd.indices

    def test_hyb_parts_match(self, rng):
        """HYB split: dense diagonals -> DIA, strays -> a skinny ELL;
        the sum matches scipy."""
        a = sp.csr_matrix(laplacian2(1024)).tolil()
        for i in np.arange(0, 1024, 16):
            a[i, min(i + 37, 1023)] = 0.5   # off-stencil strays
        a = a.tocsr()
        op = sparse_from_scipy(a, fmt="hyb", dtype=jnp.float32)
        assert op.format == "hyb"
        assert op.fwd.ell.values.shape[1] <= 2
        x = jnp.asarray(rng.uniform(-1, 1, (1024, 3)), jnp.float32)
        np.testing.assert_allclose(np.asarray(op.matmat(x)),
                                   a @ np.asarray(x), atol=1e-4)

    def test_ell_pytree_roundtrip(self, rng):
        a = _banded_random(rng, 512, 5, 30)
        op = sparse_from_scipy(a, fmt="ell")
        x = jnp.asarray(rng.uniform(-1, 1, (512, 3)))
        y = jax.jit(lambda o, v: o.matmat(v))(op, x)
        assert np.allclose(np.asarray(y), a @ np.asarray(x), atol=1e-10)
        leaves, treedef = jax.tree_util.tree_flatten(op)
        assert len(leaves) == 4   # fwd and bwd: indices, values


class TestHubSplit:
    """Hub-splitting for power-law sparsity (rails_tpu/sparse/hub.py):
    dense hub rows + compacted hub columns + a low-degree ELL bulk."""

    @staticmethod
    def _superhub(rng, m=1024, ell_l=4, band=24, n_hubs=8, hub_deg=200):
        """Banded bulk plus a few superhub rows/columns - the realistic
        scale-free-with-locality class the split targets."""
        a = _banded_random(rng, m, ell_l, band).tolil()
        hubs = rng.choice(m, n_hubs, replace=False)
        for hb in hubs:
            cols = rng.choice(m, hub_deg, replace=False)
            vals = rng.uniform(-1, 1, hub_deg)
            a[hb, cols] = vals
            a[cols, hb] = vals * 0.5    # hub columns too (nonsymmetric)
        return a.tocsr()

    def test_matches_scipy(self, rng):
        from rails_tpu.sparse.hub import hub_operator

        a = self._superhub(rng)
        op = hub_operator(a, max_hubs=16, degree_factor=6.0)
        assert op.hub_idx.shape[0] > 0
        # the bulk keeps the banded degree: no hub pads the remainder
        assert op.rest.values.shape[1] <= 4
        x = jnp.asarray(rng.uniform(-1, 1, (a.shape[0], 5)))
        np.testing.assert_allclose(np.asarray(op.matmat(x)),
                                   a @ np.asarray(x), atol=1e-11)
        np.testing.assert_allclose(np.asarray(op.rmatmat(x)),
                                   a.T @ np.asarray(x), atol=1e-11)

    def test_symmetric_reuses_split(self, rng):
        from rails_tpu.sparse.hub import hub_operator

        a = self._superhub(rng)
        a = (a + a.T).tocsr()
        op = hub_operator(a, max_hubs=16, degree_factor=6.0)
        assert op.is_symmetric and op.bwd is None
        x = jnp.asarray(rng.uniform(-1, 1, (a.shape[0], 3)))
        np.testing.assert_allclose(np.asarray(op.rmatmat(x)),
                                   a.T @ np.asarray(x), atol=1e-11)

    def test_under_jit_as_argument(self, rng):
        from rails_tpu.sparse.hub import hub_operator

        a = self._superhub(rng)
        op = hub_operator(a, max_hubs=16, degree_factor=6.0)
        x = jnp.asarray(rng.uniform(-1, 1, (a.shape[0], 4)))
        y = jax.jit(lambda o, z: o.matmat(z))(op, x)
        np.testing.assert_allclose(np.asarray(y), a @ np.asarray(x),
                                   atol=1e-11)

    def test_solver_hosts_hub_operator(self, rng):
        """The solver runs on a hub-split A (backend-contract check)."""
        import rails_tpu
        from rails_tpu.sparse.hub import hub_operator

        a = self._superhub(rng, m=512, n_hubs=4, hub_deg=80)
        a = (a + a.T).tolil()
        a.setdiag(a.diagonal() - np.abs(a).sum(axis=1).A1 - 1.0)
        op = hub_operator(a.tocsr(), max_hubs=8, degree_factor=6.0)
        b = jnp.asarray(rng.uniform(0, 1, (512, 2)))
        v, t, info = rails_tpu.solve(op, b, tol=1e-6, maxit=150)
        assert info.converged
        x_full = np.asarray(v) @ np.asarray(t) @ np.asarray(v).T
        r = a.tocsr() @ x_full + x_full @ a.tocsr().T \
            + np.asarray(b) @ np.asarray(b).T
        r0 = np.linalg.norm(np.asarray(b).T @ np.asarray(b), 2)
        assert np.linalg.norm(r, 2) / r0 < 1e-5

    def test_ba_coverage_is_sqrt_bounded(self, rng):
        """Pure Barabasi-Albert: hub coverage of a bounded hub set is
        ~sqrt(h/m), so the split leaves most of the matrix in the
        remainder (module docstring)."""
        from rails_tpu.sparse.hub import hub_coverage

        m, k = 4096, 4
        # preferential attachment via the repeated-endpoint trick
        targets = list(range(k))
        ends = []
        for v in range(k, m):
            picks = rng.choice(targets, k, replace=False)
            for u in picks:
                ends += [v, u]
            targets += [v] * k + list(picks)
        e = np.asarray(ends).reshape(-1, 2)
        a = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                          shape=(m, m)).tocsr()
        a = a + a.T
        cov = hub_coverage(a, 128)
        # sqrt(w/m) ~ 0.18 at w=128/m=4096; allow the finite-size bump
        assert cov < 0.45, cov


class TestReorder:
    """RCM bandwidth reduction -> DIA-friendly structure (no reference
    analogue, see rails_tpu/sparse/reorder.py)."""

    def test_rcm_recovers_banded_structure(self, rng):
        from rails_tpu.sparse.reorder import (
            bandwidth, n_diagonals, permute_system, rcm_permutation)

        n = 256
        a0 = sp.csr_matrix(laplacian2(n))
        shuffle = rng.permutation(n)
        a = a0[shuffle][:, shuffle].tocsr()
        assert bandwidth(a) > 100  # scrambled
        perm = rcm_permutation(a)
        a2, _, _ = permute_system(a, None, None, perm)
        assert bandwidth(a2) <= 2 * int(np.sqrt(n)) + 2
        assert n_diagonals(a2) < n_diagonals(a)

    def test_permuted_solve_matches(self, rng):
        from rails_tpu.sparse.reorder import permute_system, rcm_permutation

        n = 64
        a0 = sp.csr_matrix(laplacian2(n))
        md = rng.uniform(0.5, 1.5, n)
        b = rng.uniform(0, 1, (n, 1))
        shuffle = rng.permutation(n)
        a = a0[shuffle][:, shuffle].tocsr()
        m = sp.diags(md[shuffle]).tocsr()
        bp = b[shuffle]

        perm = rcm_permutation(a)
        a2, m2, b2 = permute_system(a, m, bp, perm)
        v, t, info = rails_tpu.solve(
            sparse_from_scipy(a2, is_symmetric=True), jnp.asarray(b2),
            rails_tpu.DiagonalOperator(jnp.asarray(m2.diagonal())),
            tol=1e-6)
        assert info.converged
        # map back: X = P' X_perm P
        inv = np.argsort(perm)
        x_orig = (np.asarray(v) @ np.asarray(t) @ np.asarray(v).T)[
            np.ix_(inv, inv)]
        r = a.toarray() @ x_orig @ m.toarray().T \
            + m.toarray() @ x_orig @ a.toarray().T + bp @ bp.T
        assert np.linalg.norm(r, 2) / np.linalg.norm(bp.T @ bp, 2) < 1e-6
