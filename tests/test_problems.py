"""Problem generators (models/problems.py, models/make_problem.py)."""

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

from rails_tpu.models.make_problem import make
from rails_tpu.models.problems import laplacian2, laplacian2_sparse


@pytest.mark.parametrize("n", [4, 64, 256])
def test_sparse_laplacian_matches_dense(n):
    a = laplacian2_sparse(n)
    assert sp.isspmatrix_csr(a) or isinstance(a, sp.csr_array)
    np.testing.assert_array_equal(a.toarray(), laplacian2(n))


def test_sparse_laplacian_rejects_non_square():
    with pytest.raises(ValueError):
        laplacian2_sparse(50)


def test_make_laplace_writes_sparse_operator(tmp_path):
    make("laplace", str(tmp_path), n=1024, seed=3)
    a = scipy.io.mmread(str(tmp_path / "A.mtx"))
    assert a.nnz == laplacian2_sparse(1024).nnz
    np.testing.assert_array_equal(a.toarray(), laplacian2(1024))
    m = scipy.io.mmread(str(tmp_path / "M.mtx")).diagonal()
    assert np.all((m >= 0.5) & (m <= 1.5))


def test_make_dae_small_n_unchanged(tmp_path):
    """Up to n=64 the DAE generator keeps density 0.2, so the problems
    the tests and the multi-host runs were calibrated on are unchanged."""
    n, seed = 64, 4634
    make("dae", str(tmp_path), n=n, seed=seed)
    rng = np.random.default_rng(seed)
    want = rng.uniform(-1, 1, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.2)
    want = want - 3.0 * np.eye(n)
    a = scipy.io.mmread(str(tmp_path / "A.mtx")).toarray()
    np.testing.assert_array_equal(a, want)


def test_make_dae_stays_stable_at_large_n(tmp_path):
    """Past n=64 the coupling count per row stays ~13, so the spectrum
    stays left of the imaginary axis."""
    make("dae", str(tmp_path), n=1024, seed=0)
    a = scipy.io.mmread(str(tmp_path / "A.mtx")).toarray()
    assert np.linalg.eigvals(a).real.max() < 0
    assert (a != 0).sum(axis=1).mean() < 20
