"""The repo's two examples on the port, run once each on the CPU as a user
runs them: `examples/torch_full_workflow.py` (train one epoch, the score
CSV, Rank-IC, backtest, int8 rank correlation) and
`examples/torch_sharded_cross_section.py` (a 2-rank gloo world: the
sharded softmax, portfolio reduction and ring attention against the
unsharded ones)."""

from __future__ import annotations

import csv
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run([sys.executable, os.path.join(REPO, "examples", script), *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout, json.loads(proc.stdout.strip().splitlines()[-1])


def test_full_workflow_on_the_cpu(tmp_path):
    out, res = _run("torch_full_workflow.py", "--cpu", "--epochs", "1",
                    "--workdir", str(tmp_path / "work"), cwd=tmp_path)
    assert "rank-ic    :" in out and "int8 path  : rank corr vs f32" in out
    assert res["device"] == "cpu" and res["rows"] > 0
    assert np.isfinite(res["rank_ic"]) and np.isfinite(res["rank_ic_ir"])
    assert res["int8_rank_corr"] > 0.99
    assert set(res["backtest"]) >= {"cumulative_return", "max_drawdown", "mean_turnover"}
    with open(res["csv"], newline="") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["datetime", "instrument", "score", "LABEL0"]
    assert len(rows) - 1 == res["rows"]
    assert os.path.dirname(res["csv"]) == str(tmp_path / "work" / "scores")


def test_sharded_cross_section_on_the_cpu(tmp_path):
    out, res = _run("torch_sharded_cross_section.py", "--cpu", cwd=tmp_path)
    assert out.startswith("mesh: 2 ranks on cpu over axis 'stock' (gloo)")
    assert res["ok"] is True and res["world"] == 2
    assert max(res["max_abs_err"].values()) <= res["tolerance"] == 1e-6
    assert res["comms"]["all-reduce over stock"]["calls"] >= 3
    assert res["comms"]["collective-permute over stock"]["calls"] == 3
