"""Where the benchmark's pieces are, found by the names in BENCHMARK.json.

    configs/<config>.json      a configuration: sizes, universe, source, cuts
    traffic/<traffic>.json     a traffic mix: parameters of one traffic kind
    workloads/<cell>.json      a cell's own settings: its correctness limits
    metrics/<metric>.py        the reader of one per-layer metric
    reference/<name>.py        a configuration's plain reference
    harness/<kind>.py          the driver of a traffic kind

A cell, a traffic mix of an existing kind, a configuration of an existing
reference or a per-layer metric is added as files and an entry in
BENCHMARK.json.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def spec(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(spec_: dict, name: str) -> dict:
    for w in spec_["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in spec_['workloads']]}")


def config(name: str) -> dict:
    return _json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def cell(name: str) -> dict:
    return _json(BENCH / "workloads" / f"{name}.json")


def reference(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")


def driver(kind: str):
    return importlib.import_module(f"benchmark.harness.{kind}")


def metric_reader(name: str):
    """The module of metrics/<name>.py (a name may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_name = "benchmark.metrics._" + name.replace(".", "_").replace("-", "_")
    loader = importlib.util.spec_from_file_location(mod_name, path)
    if loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod


def reports(metric: dict, cell_name: str, end_to_end: list) -> bool:
    """Whether the cell reports `metric`: listed in its `workloads`, or,
    without that key, wherever the end-to-end metric it moves is reported."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    moved = next((e for e in end_to_end if e["name"] == metric.get("moves")), None)
    return moved is None or "workloads" not in moved or cell_name in moved["workloads"]
