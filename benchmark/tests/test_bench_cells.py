"""BENCHMARK.json's shape, and the harness finding every configuration,
traffic mix, cell and per-layer metric by its name."""

import json
import re
import statistics
from types import SimpleNamespace

import pytest

from benchmark.harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = cells.spec()


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    config = cells.config(entry["name"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert config["source"] == entry["source"] and config["reduced"] == entry["reduced"]
    assert cells.reference(config["reference"]).param_specs(config["model"])
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_workloads(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and entry["chips"] == 1 and len(entry["why"]) <= 200
    traffic = cells.traffic(entry["traffic"])
    driver = cells.driver(traffic["kind"])
    assert hasattr(driver, "Driver")
    limits = cells.cell(entry["name"])["limits"]
    assert limits and all(v >= 0 for v in limits.values())
    e2e = [e for e in SPEC["end_to_end"] if cells.reports(e, entry["name"], [])]
    layer = [e for e in SPEC["per_layer"]
             if cells.reports(e, entry["name"], SPEC["end_to_end"])]
    assert "setup_s" in {e["name"] for e in e2e} and len(e2e) >= 2 and layer
    assert {e["moves"] for e in layer} <= {e["name"] for e in e2e}


def test_metrics():
    names = [e["name"] for e in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for e in SPEC["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    assert next(e for e in SPEC["end_to_end"] if e["name"] == "setup_s")["bound"] <= 0.25
    layers = {}
    for e in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for e in SPEC["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        layers.setdefault(e["layer"], []).append(e["name"])
        if "roofline" in e["name"] or "mfu" in e["name"]:
            assert e["unit"] == "%"


@pytest.mark.parametrize("entry", SPEC["per_layer"], ids=lambda e: e["name"])
def test_every_per_layer_metric_has_a_reader(entry):
    reader = cells.metric_reader(entry["name"])
    assert callable(reader.read)
    for name, where in getattr(reader, "COUNTERS", {}).items():
        module, attr = where.split(":")
        assert module.startswith("factorvae_tpu_torch.") and attr.endswith(".launches")


def test_a_reader_with_nothing_to_read_returns_nothing():
    ctx = SimpleNamespace(reduced=None, shapes={"days": 8, "n": 16, "rows": 128, "t": 5, "h": 8,
                                        "k": 4, "valid_train": 100.0, "valid_eval": 100.0},
                  counts={k: 0 for k in ("gru_fwd", "gru_fwd_residuals", "gru_bwd",
                                         "gru_dwh", "attention_fwd", "attention_bwd")},
                  spans={}, window_s=1.0, windows=0, valid_per_day=10.0,
                  config=cells.config("csi800-k60"))
    for entry in SPEC["per_layer"]:
        assert cells.metric_reader(entry["name"]).read(ctx) is None, entry["name"]


def test_span_readers_take_the_median():
    ctx = SimpleNamespace(spans={"epoch": [3.0, 1.0, 2.0, 9.0], "pass": [1.0, 5.0, 2.0]})
    assert cells.metric_reader("epoch_s.train").read(ctx) == statistics.median([3, 1, 2, 9])
    assert cells.metric_reader("pass_s.score").read(ctx) == 2.0


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.workload(SPEC, "no-such-cell")
