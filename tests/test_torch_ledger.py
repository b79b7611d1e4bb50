"""The port's perf-regression ledger (`factorvae_tpu_torch/obs/ledger.py`)
against the JAX package's (`factorvae_tpu/obs/ledger.py`) on seeded
histories, and on its own: the history file it defaults to, the backfill
that reads only the artifacts named, the command's exit codes, and the rig
key that keeps cards and power limits apart."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from factorvae_tpu.obs import ledger as jledger
from factorvae_tpu_torch.obs import ledger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

METRICS = ("score_windows_per_s", "train_windows_per_s", "requests_per_s",
           "bench_failed")
CARD = {"device": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
# three rigs that the JAX key tells apart too (their cards stay put)
RIGS = (
    {"platform": "cuda", "env": {"cuda_visible_devices": None}, "device_count": 1, **CARD},
    {"platform": "cuda", "env": {"cuda_visible_devices": "1"}, "device_count": 1, **CARD},
    {"platform": "cpu", "env": {"torch_num_threads": 4}, "device_count": 0,
     "device": None, "power_limit": None},
)


def _row(rng, metric=None, rig=None, value=None, backfill=None):
    rig = RIGS[rng.integers(len(RIGS))] if rig is None else rig
    meta = ({"backfill_source": backfill} if backfill else
            {k: v for k, v in rig.items() if k != "platform"})
    if value is None:
        value = float(np.round(rng.uniform(50, 150), 3))
    return {"ts": 1.0, "metric": metric or METRICS[rng.integers(len(METRICS))],
            "value": value, "unit": "windows/s", "platform": rig["platform"],
            "vs_baseline": None, "plan": None, "run_meta": meta}


def _history(seed: int, path) -> str:
    """Seeded rows over three rigs and four metrics, a `*_failed` and two
    zero-valued rows, backfilled rows after tracked ones, a torn last line."""
    rng = np.random.default_rng(seed)
    rows = [_row(rng) for _ in range(40)]
    rows.insert(5, _row(rng, value=0.0))
    rows.append(_row(rng, metric="requests_per_s", rig=RIGS[0], value=0))
    rows += [_row(rng, metric=m, rig=RIGS[2], backfill=f"BENCH_r0{k}.json")
             for k, m in enumerate(METRICS[:3])]
    # a regression on rig 0: its latest row far below its trailing median
    rows += [_row(rng, metric="train_windows_per_s", rig=RIGS[0], value=100.0 + k)
             for k in range(4)]
    if seed % 2:
        rows.append(_row(rng, metric="train_windows_per_s", rig=RIGS[0], value=20.0))
    with open(path, "w") as fh:
        fh.writelines(json.dumps(r) + "\n" for r in rows)
        fh.write('{"metric": "score_windows_per_s", "value": 9')     # torn
    return str(path)


def _without_path(report):
    return {k: v for k, v in report.items() if k != "path"}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("threshold,window", [(0.4, 5), (0.1, 2)])
def test_check_report_equals_the_jax_report(seed, threshold, window, tmp_path):
    path = _history(seed, tmp_path / "hist.jsonl")
    ok, report = ledger.check(path, threshold=threshold, window=window)
    jok, jreport = jledger.check(path, threshold=threshold, window=window)
    assert ok == jok and _without_path(report) == _without_path(jreport)
    assert report["path"] == path and report["rows"] == 49 + seed % 2
    assert {e["metric"] for e in report["metrics"]} == set(METRICS)
    if seed % 2:
        assert not ok
    text, jtext = ledger.format_report(report), jledger.format_report(jreport)
    assert text.splitlines()[1:] == jtext.splitlines()[1:]
    assert text.splitlines()[0] == jtext.splitlines()[0]       # the same path here


def test_backfill_gives_the_jax_rows_and_is_idempotent(tmp_path):
    direct = tmp_path / "BENCH_direct.json"
    direct.write_text(json.dumps({"metric": "score_windows_per_s", "value": 812.5,
                                  "unit": "windows/s", "platform": "cuda"}))
    wrapper = tmp_path / "BENCH_wrapped.json"
    wrapper.write_text(json.dumps({"rc": 0, "tail": "\n".join([
        "some log line",
        json.dumps({"metric": "train_windows_per_s", "value": 55.5, "unit": "windows/s"}),
        json.dumps({"metric": "bench_failed", "value": 0, "unit": "windows/s"}),
        json.dumps({"metric": "requests_per_s", "value": 240.0, "unit": "req/s"}),
        "{not json"])}))
    empty = tmp_path / "BENCH_empty.json"
    empty.write_text("[1, 2]")
    arts = [str(direct), str(wrapper), str(empty)]
    ours, theirs = tmp_path / "ours.jsonl", tmp_path / "theirs.jsonl"
    res = ledger.backfill(arts, path=str(ours))
    jres = jledger.backfill(arts, path=str(theirs))
    assert res["added"] == jres["added"] and len(res["added"]) == 3
    assert res["skipped_artifacts"] == jres["skipped_artifacts"] == ["BENCH_empty.json"]
    assert ledger.load_history(str(ours)) == jledger.load_history(str(theirs))
    assert all(r["ts"] is None for r in ledger.load_history(str(ours)))
    again = ledger.backfill(arts, path=str(ours))
    assert again["added"] == [] and len(ledger.load_history(str(ours))) == 3
    assert ledger.check(str(ours))[1]["metrics"] == jledger.check(str(theirs))[1]["metrics"]
    # nothing named: nothing read, nothing written
    none = tmp_path / "none.jsonl"
    assert ledger.backfill([], path=str(none))["added"] == [] and not none.exists()


def test_default_history_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(ledger.HISTORY_ENV, raising=False)
    monkeypatch.setenv(jledger.HISTORY_ENV, str(tmp_path / "jax.jsonl"))
    default = ledger.history_path()
    assert os.path.basename(default) == "BENCH_HISTORY_TORCH.jsonl"
    assert os.path.dirname(default) == REPO
    assert default != jledger.DEFAULT_HISTORY_PATH
    assert os.path.basename(default) != "BENCH_HISTORY.jsonl"
    monkeypatch.setenv(ledger.HISTORY_ENV, str(tmp_path / "torch.jsonl"))
    assert ledger.history_path() == str(tmp_path / "torch.jsonl")
    assert ledger.history_path("x.jsonl") == "x.jsonl"


def test_rows_on_another_card_or_power_limit_are_another_rig(tmp_path):
    base = {"device_count": 1, "env": {"torch_num_threads": 8}, **CARD}
    path = str(tmp_path / "h.jsonl")
    for value in (100.0, 101.0, 99.0):
        ledger.append_row({"metric": "m", "value": value, "unit": "u", "platform": "cuda"},
                          path=path, run_meta=base)
    ledger.append_row({"metric": "m", "value": 10.0, "unit": "u", "platform": "cuda"},
                      path=path, run_meta=dict(base))
    ok, report = ledger.check(path)
    assert not ok and report["metrics"][0]["status"] == "REGRESSION"
    for k, change in enumerate(({"power_limit": "500.00 W"}, {"device": "NVIDIA H100 PCIe"})):
        path = str(tmp_path / f"h_{k}.jsonl")
        for value in (100.0, 101.0, 99.0):
            ledger.append_row({"metric": "m", "value": value, "unit": "u",
                               "platform": "cuda"}, path=path, run_meta=base)
        ledger.append_row({"metric": "m", "value": 10.0, "unit": "u", "platform": "cuda"},
                          path=path, run_meta={**base, **change})
        ok, report = ledger.check(path)
        (entry,) = report["metrics"]
        assert ok and entry["status"] == "no_comparable_history"
        assert entry["other_rig_skipped"] == 3
        # the JAX key would have compared them
        assert not jledger.check(path)[0]


def test_untrackable_payloads_are_skipped_and_rows_carry_this_rig(tmp_path):
    path = str(tmp_path / "h.jsonl")
    for payload in ({"metric": "x_failed", "value": 3, "unit": "u"},
                    {"metric": "x", "value": 0, "unit": "u"},
                    {"metric": "x", "value": "n/a", "unit": "u"},
                    {"metric": "", "value": 1, "unit": "u"}):
        assert ledger.append_row(payload, path=path) is None
        assert ledger._trackable(payload) == jledger._trackable(payload)
    assert not os.path.exists(path)
    assert ledger.append_row({"metric": "x", "value": 2.5, "unit": "u",
                              "platform": "cpu"}, path=path) == path
    (row,) = ledger.load_history(path)
    assert set(row) == {"ts", "metric", "value", "unit", "platform", "vs_baseline",
                        "plan", "run_meta"}
    meta = row["run_meta"]
    assert meta["platform"] == "cpu" and meta["device"] is None
    assert "power_limit" not in meta and "torch" in meta
    # a payload's own run_meta (the measuring process's rig) is kept
    own = ledger.make_row({"metric": "x", "value": 1, "run_meta": {"device": "d"}})
    assert own["run_meta"] == {"device": "d"}


def test_backfill_with_no_artifact_exits_2_and_writes_nothing(tmp_path, capsys):
    path = tmp_path / "h.jsonl"
    assert ledger.main([str(path), "--backfill"]) == 2
    assert not path.exists() and "at least one" in capsys.readouterr().out
    art = tmp_path / "BENCH_a.json"
    art.write_text(json.dumps({"metric": "m", "value": 5.0, "unit": "u"}))
    assert ledger.main([str(path), "--backfill", str(art)]) == 0
    assert "backfilled 1 rows" in capsys.readouterr().out
    assert ledger.main([str(path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["rows"] == 1


@pytest.mark.parametrize("case,want", [("ok", 0), ("regression", 1), ("missing", 2)])
def test_command_exit_codes(case, want, tmp_path):
    path = tmp_path / "h.jsonl"
    if case != "missing":
        values = [100.0, 102.0, 98.0, 101.0 if case == "ok" else 30.0]
        path.write_text("".join(json.dumps({
            "ts": 1.0, "metric": "m", "value": v, "unit": "u", "platform": "cuda",
            "run_meta": {"device_count": 1, **CARD}}) + "\n" for v in values))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "factorvae_tpu_torch.obs.ledger", str(path)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == want, proc.stdout + proc.stderr
    first = proc.stdout.splitlines()[0]
    if case == "missing":
        assert first.startswith("error: no bench history")
    else:
        assert first.startswith(f"perf ledger: {path} (4 rows")
        assert proc.stdout.strip().endswith("OK" if case == "ok" else "REGRESSION detected (exit 1)")
