"""The benchmark's files: every cell, configuration and metric found by name,
``BENCHMARK.json`` within the contract's limits, and a cell added as files
alone picked up without an edit."""
import json
import re
import shutil

import pytest

from coldbench import harness, spec
from coldbench.tests import small

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_names_a_configuration_and_its_functions(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    cell = spec.cell(name)
    assert cell["config"] == entry["config"]
    config = spec.config(cell["config"])
    assert {f for c in cell["clients"] for f in c} <= set(config["functions"])
    assert set(cell["correct"]) == {"restored_bytes_differing", "logits_rel_err", "token_gap"}
    assert cell["expect"] in ("cold", "warm") and entry["chips"] == 1


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_file(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = json.loads((spec.ROOT / entry["file"]).read_text())
    assert data["name"] == config and data["reduced"] == entry["reduced"]
    assert spec.reference(data).leaf_specs(data)
    assert spec.program_config(data).n_layers == data["program"]["n_layers"]
    widths = ("hidden", "intermediate", "state", "head", "expand", "_dim", "_rank")
    assert not [k for k in entry["reduced"] if any(w in k for w in widths)]


def test_benchmark_json_within_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and BENCH["paths"] == ["coldbench"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in METRICS)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for cell in CELLS:
        reported = {m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_of(BENCH, cell, "per_layer")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in spec.metrics_of(BENCH, cell, "end_to_end")}
    texts = [x["why"] for x in BENCH["configs"] + BENCH["workloads"]]
    texts += [m["layer"] for m in BENCH["per_layer"]] + [c["source"] for c in BENCH["configs"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_a_cell_added_as_files_is_picked_up(tmp_path, monkeypatch):
    """A copy of the benchmark with one more cell (two clients on two
    fine-tunes) in a new workload file and a new entry in BENCHMARK.json:
    the harness finds and runs it, and its metrics are read, with no code
    changed."""
    shutil.copytree(spec.HERE, tmp_path / "coldbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "qwen1.5-0.5b.cold-x2", "config": "qwen1.5-0.5b",
                               "traffic": "cold-x2", "chips": 1, "why": "two tenants"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = dict(spec.cell("qwen1.5-0.5b.cold"), clients=[["fn-ft-0"], ["fn-ft-1"]])
    (tmp_path / "coldbench" / "workloads" / "qwen1.5-0.5b.cold-x2.json").write_text(
        json.dumps(cell))
    monkeypatch.setattr(spec, "HERE", tmp_path / "coldbench")
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    assert spec.cell("qwen1.5-0.5b.cold-x2")["clients"] == [["fn-ft-0"], ["fn-ft-1"]]
    out = harness.run("qwen1.5-0.5b.cold-x2", 7, 0.3, False, t_start=0.0, device="cpu",
                      cell=small.cell("qwen1.5-0.5b.cold-x2"), config=small.config("qwen1.5-0.5b"))
    assert out["correct"] and {r["function"] for r in out["ok"]} == {"fn-ft-0", "fn-ft-1"}
    for m in spec.metrics_of(spec.benchmark(), "qwen1.5-0.5b.cold-x2", "end_to_end"):
        assert spec.reader(m["name"])(out) > 0
