"""The benchmark's files, found by name.

* ``BENCHMARK.json`` at the root of the checkout: the cells and metrics;
* ``coldbench/workloads/<cell>.json``: a cell's traffic (clients, the
  functions each one invokes, eviction, batch, prompt and output lengths,
  the ledger's budget) and the limits of its correctness check;
* ``coldbench/configs/<config>.json``: a configuration, as published and as
  run, the reference module that computes it, and its functions;
* ``coldbench/metrics/<metric>.py``: a metric's reader, ``read(record)``.

A later change adds a cell, a configuration or a metric by adding files
(and entries in ``BENCHMARK.json``) and edits none of these.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    return _json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def reference(config: dict):
    """The configuration's plain reference module (``coldbench.reference.<name>``)."""
    return importlib.import_module(f"coldbench.reference.{config['reference']}")


def program_config(config: dict):
    """The configuration as the program takes it (its ``ModelConfig``)."""
    from repro_torch.configs.base import LayerSpec, ModelConfig

    kw = dict(config["program"])
    kw["pattern"] = tuple(LayerSpec(**s) for s in kw["pattern"])
    return ModelConfig(name=config["name"], **kw)


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    """The entries of ``bench[kind]`` (``"end_to_end"`` or ``"per_layer"``)
    that the cell reports: those without ``workloads`` and those that list it."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str):
    """The ``read(record)`` of ``coldbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"coldbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
