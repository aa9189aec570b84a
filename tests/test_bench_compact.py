"""The bench's machine-readable contract: the LAST stdout line of the
orchestrator must be a JSON headline short enough for a ~2,000-char
tail window, even when every phase populated every field AND errored
(worst-width case)."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import bench  # noqa: E402


def _worst_case_out():
    out = {"metric": "dia_spmm_nnz_per_s", "value": 2.0555e10,
           "unit": "nnz/s", "vs_baseline": 0.7654321987654321,
           "provenance": "x" * 300, "phases": {}}
    # every compact key present, at float-repr-worst width
    for k in bench.COMPACT_KEYS:
        if k not in out:
            out[k] = 1.2345678901234567e-09
    out["device_kind"] = "NVIDIA H200"
    for name in ("spmm", "accuracy", "ell", "hub", "solve",
                 "continuation", "scale", "mesh"):
        out["phases"][name] = {
            "wall_s": 123.4,
            "error": "timeout after 600s; " + "y" * 100,
        }
    # plus large non-compact payloads that must NOT leak through
    out["cont_steps"] = [{"theta": 0.1, "wall_s": 1.0}] * 50
    out["mesh_comm"] = {"8": {"permute_bytes_per_device": 1}}
    return out


def test_compact_line_bounded_and_parseable():
    line = bench.build_compact_line(_worst_case_out())
    assert len(line) <= bench.COMPACT_LIMIT, len(line)
    d = json.loads(line)
    assert d["metric"] == "dia_spmm_nnz_per_s"
    assert "cont_steps" not in d
    assert "mesh_comm" not in d
    # headline fields for all six-plus phases survive
    for k in ("value", "vs_stream", "acc_target_met", "scale_res_true",
              "cont_warm_speedup_wall", "hub_speedup_vs_xla",
              "solve_wall_s", "moc_res_fro"):
        assert k in d, k


def test_compact_line_minimal_out():
    line = bench.build_compact_line(
        {"metric": "m", "value": 0.0, "unit": "u", "vs_baseline": 0.0,
         "phases": {}})
    d = json.loads(line)
    assert d["value"] == 0.0
