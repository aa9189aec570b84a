"""chip_smoke.py's phases at tiny sizes on the CPU.

The script's ``main`` demands a GPU; every phase function takes its sizes
as arguments, so the same code paths and checks run here small.  The one
``gpu``-marked test runs a phase at full size when a card is present.
"""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def test_phase_f64():
    rec = cs.phase_f64(side=16)
    assert rec["true_residual"] <= 2e-5 and rec["iters"] > 0


def test_phase_f32_refined():
    rec = cs.phase_f32_refined(side=16)
    assert rec["residual_ratio_default_vs_highest"] <= 2.0


def test_phase_ell():
    # a small maxit keeps the padded capacity, and with it the projected
    # solves' multithreaded GEMMs, small at this m
    rec = cs.phase_ell(m_apply=4096, m_solve=1024, maxit=30)
    assert rec["apply_rel_err"] <= 1e-5 and rec["slots"] >= 6


def test_phase_cli(tmp_path):
    rec = cs.phase_cli(str(tmp_path), n_laplace=1024, n_dae=96)
    assert rec["laplace_true_residual"] <= 2e-4
    for kind in ("laplace", "dae"):
        for name in ("V.mtx", "T.mtx"):
            assert (tmp_path / kind / name).stat().st_size > 0


def test_phase_dia():
    rec = cs.phase_dia(side=64, card="cpu")
    assert rec["fused_vs_chain_rel_err"] <= 1e-6
    assert rec["fused_gbs"] > 0 and rec["copy_gbs"] > 0


def test_phase_four_on_virtual_devices(tmp_path):
    # a small maxit keeps the capacity buffer, and with it the replicated
    # projected solves, small at this m
    rec = cs.phase_four(n_devices=4, side=16, m_ell=512, n_dae=64,
                        workdir=str(tmp_path), ell_maxit=30)
    assert rec["dia_operator"] == "HaloDiaOperator"
    assert rec["ell_operator"] == "HaloEllOperator"
    assert rec["ell_iteration_difference"] == 0
    assert rec["schur_probe_gap"] <= 1e-8


def test_main_refuses_cpu(monkeypatch, capsys):
    monkeypatch.setattr(cs, "card_line", lambda: "no card")
    for argv in ([], ["--four"]):
        assert cs.main(argv) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_true_residual_matches_dense(rng):
    import scipy.sparse as sp

    n = 40
    a = sp.diags([1.0, -3.0, 1.2], [-1, 0, 1], (n, n)).tocsr()
    md = rng.uniform(0.5, 1.5, n)
    b = rng.uniform(0, 1, (n, 2))
    v = np.linalg.qr(rng.standard_normal((n, 5)))[0]
    t = rng.standard_normal((5, 5))
    t = t + t.T
    x = v @ t @ v.T
    m = np.diag(md)
    r = a @ x @ m + m @ x @ a.T + b @ b.T
    want = np.linalg.norm(r, 2) / np.linalg.norm(b.T @ b, 2)
    got = cs.true_residual(a, md, b, v, t, iters=500)
    assert abs(got - want) <= 1e-6 * want


def test_probe_gap(rng):
    v = rng.standard_normal((30, 4))
    t = np.eye(4)
    assert cs.probe_gap(v, t, v, t) == 0.0
    assert cs.probe_gap(v, t, v, 1.1 * t) == pytest.approx(0.1, rel=1e-12)


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: RAILS_TEST_PLATFORM=gpu python -m "
                    "pytest -m gpu tests/")


@pytest.mark.gpu
def test_dia_phase_on_card(gpu):
    rec = cs.phase_dia(card=cs.card_line())
    assert rec["fused_vs_chain_rel_err"] <= 1e-6
