"""``BENCHMARK.json`` keeps to its contract, and every cell resolves to its
files by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_keys():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for entry in SPEC["configs"] + SPEC["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for entry in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for m in SPEC["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    assert len({e["name"] for e in metrics}) == len(metrics)


def test_every_cell_resolves_by_name():
    for w in SPEC["workloads"]:
        cell = run.load_cell(w["name"])
        assert cell.config["model"]["n_layers"] >= 1
        assert cell.traffic["kind"] in ("open_loop", "closed_loop")
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert set(cell.limits) <= {"widest_gap", "logprob_err",
                                    "clear_gap", "clear_lp_err"}
        names = {m["name"] for m in cell.e2e}
        assert "setup_s" in names and len(names) >= 2
        assert cell.layer, w["name"]
        for m in cell.layer:
            assert callable(run.reader(m["name"]))
            assert m["moves"] in names


def test_config_files_hold_their_reductions():
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert conf["source"].startswith(c["source"])
        m = conf["model"]
        assert m["d_model"] == conf["hidden_size"]
        assert m["d_ff"] == conf["intermediate_size"]
        assert m["n_layers"] == conf["num_hidden_layers"]
        assert m["n_kv_heads"] == conf["num_key_value_heads"]
        if "num_local_experts" in conf:
            assert m["n_experts"] == conf["num_local_experts"]
            assert m["moe_top_k"] == conf["num_experts_per_tok"]
            # dropless: capacity factor = the number of experts
            assert m["moe_capacity_factor"] == m["n_experts"]
