"""The whole slice on the CPU: the port's `predict_panel` against the JAX
`predict_panel`, and the port's daemon, registry and CLI.

Shapes: C=12, T=6, H=8, K=4, M=10 on a 30-day synthetic panel of 13
stocks (padded to 16) with missing rows. Weights from the JAX `load_model`,
copied in with `flax_to_torch`. The scores hold at the repo's torch-oracle
tolerance, f32 with rtol=1e-5, atol=1e-6, against the JAX scores with its
Pallas kernels (interpret mode) and with the XLA path.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.eval.predict import predict_panel as jpredict_panel
from factorvae_tpu.models.factorvae import load_model as jload_model
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.eval.predict import generate_prediction_scores, predict_panel
from factorvae_tpu_torch.models.factorvae import FactorVAE
from factorvae_tpu_torch.params import flax_to_torch, save_weights
from factorvae_tpu_torch.serve.daemon import ScoringDaemon, serve_stdin
from factorvae_tpu_torch.serve.registry import ModelRegistry

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
C, T, H, K, M = 12, 6, 8, 4, 10


@pytest.fixture(scope="module")
def rig():
    jp = synthetic_panel(num_days=30, num_instruments=13, num_features=C,
                         missing_prob=0.15, seed=2)
    tp = Panel(values=jp.values, valid=jp.valid,
               dates=jp.dates.values.astype("datetime64[D]"),
               instruments=np.asarray(jp.instruments))
    jcfg = jconfig.Config(model=jconfig.ModelConfig(
        num_features=C, hidden_size=H, num_factors=K, num_portfolios=M,
        seq_len=T, use_pallas_gru=False, use_pallas_attention=False),
        data=jconfig.DataConfig(seq_len=T))
    _, params = jload_model(jcfg, n_max=8)
    tcfg = tconfig.Config(model=tconfig.ModelConfig(
        num_features=C, hidden_size=H, num_factors=K, num_portfolios=M, seq_len=T),
        data=tconfig.DataConfig(seq_len=T))
    model = FactorVAE(tcfg.model)
    model.load_state_dict(flax_to_torch(params))
    jds = JPanelDataset(jp, seq_len=T)
    tds = PanelDataset(tp, seq_len=T, device="cpu")
    return dict(jcfg=jcfg, params=params, tcfg=tcfg, model=model.eval(),
                jds=jds, tds=tds)


class TestPredictPanel:
    @pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "xla"])
    def test_matches_jax_predict_panel(self, rig, pallas):
        jcfg = dataclasses.replace(rig["jcfg"], model=dataclasses.replace(
            rig["jcfg"].model, use_pallas_gru=pallas, use_pallas_attention=pallas))
        days = rig["tds"].split_days(None, None)
        assert len(days) == 30
        # chunk=8 -> four chunks, the last one -1-padded
        want = jpredict_panel(rig["params"], jcfg, rig["jds"], days,
                              stochastic=False, chunk=8)
        got = predict_panel(rig["model"], rig["tcfg"], rig["tds"], days,
                            stochastic=False, chunk=8)
        assert got.shape == want.shape == (30, 16)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[:, 13:]).all() and (~np.isnan(got)).sum() > 300
        np.testing.assert_allclose(got, want, **SCORE_TOL)

    def test_chunking_and_sampling(self, rig):
        days = rig["tds"].split_days(None, None)[:11]
        args = (rig["model"], rig["tcfg"], rig["tds"], days)
        a = predict_panel(*args, stochastic=False, chunk=32)
        b = predict_panel(*args, stochastic=False, chunk=4)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        s1 = predict_panel(*args, stochastic=True, seed=5)
        s2 = predict_panel(*args, stochastic=True, seed=5)
        assert np.array_equal(s1, s2, equal_nan=True)
        assert not np.allclose(np.nan_to_num(s1), np.nan_to_num(a))
        assert predict_panel(*args[:3], np.array([], np.int32)).shape == (0, 16)

    def test_score_frame(self, rig):
        df = generate_prediction_scores(rig["model"], rig["tcfg"], rig["tds"],
                                        "2020-01-10", "2020-01-31", stochastic=False,
                                        with_labels=True)
        days = rig["tds"].split_days("2020-01-10", "2020-01-31")
        assert len(df) == int(rig["tds"].valid[days].sum())
        assert list(df.columns) == ["score", "LABEL0"] and df["score"].notna().all()


class TestDaemon:
    def _daemon(self, rig):
        registry = ModelRegistry(device="cpu")
        key = registry.admit(rig["model"], rig["tcfg"], alias="tiny")
        return ScoringDaemon(registry, rig["tds"]), key

    def test_mixed_batch(self, rig):
        daemon, key = self._daemon(rig)
        tds = rig["tds"]
        dates = [str(d) for d in tds.dates]
        out = daemon.handle_batch([
            {"id": 1, "model": "tiny", "day": dates[20], "top": 3},
            {"id": 2, "model": key, "start": dates[5], "end": dates[14]},
            {"id": 3, "cmd": "ping"},
            {"id": 4, "cmd": "stats"},
            {"id": 5, "model": "nope", "day": 3},
            {"id": 6, "model": "tiny", "day": "1999-01-04"},
            {"id": 7, "model": "tiny", "day": 999},
            {"id": 8, "cmd": "reboot"},
        ])
        assert [r["id"] for r in out] == list(range(1, 9))
        assert [r["ok"] for r in out] == [True] * 4 + [False] * 4
        assert "unknown model" in out[4]["error"]
        assert "not in the serving panel" in out[5]["error"]

        one = predict_panel(rig["model"], rig["tcfg"], tds, np.array([20]),
                            stochastic=False)[0]
        valid = np.nonzero(tds.valid[20])[0]
        best = valid[np.argsort(-one[valid])[:3]]
        res = out[0]["results"][0]
        assert out[0]["n"] == 3 and res["day"] == dates[20]
        assert res["instruments"] == [str(tds.instruments[i]) for i in best]
        assert res["scores"] == [float(v) for v in one[best]]

        days = tds.split_days(dates[5], dates[14])
        full = predict_panel(rig["model"], rig["tcfg"], tds, days, stochastic=False)
        assert len(out[1]["results"]) == len(days) == 10
        for i, r in enumerate(out[1]["results"]):
            idx = np.nonzero(tds.valid[days[i]])[0]
            assert r["scores"] == [float(v) for v in full[i, idx]]
        jfull = jpredict_panel(rig["params"], rig["jcfg"], rig["jds"], days,
                               stochastic=False)
        np.testing.assert_allclose(full, jfull, **SCORE_TOL)

        stats = out[3]
        assert stats["requests_served"] == 2 and stats["registry"]["models"] == 1
        assert stats["registry"]["aliases"] == {"tiny": key}

    def test_weights_dir_admission_and_stdin(self, rig, tmp_path):
        path = save_weights(rig["model"], rig["tcfg"], str(tmp_path / "tiny_w"))
        registry = ModelRegistry(device="cpu")
        key = registry.admit(path)
        assert registry.get("tiny_w").key == key
        daemon = ScoringDaemon(registry, rig["tds"])
        lines = [json.dumps({"id": 1, "model": "tiny_w", "day": 12}), "",
                 "not json", json.dumps([{"cmd": "ping"}, {"cmd": "shutdown"}]),
                 json.dumps({"cmd": "ping"})]
        out_lines = []

        class Sink:
            def write(self, s):
                out_lines.append(s)

            def flush(self):
                pass

        assert serve_stdin(daemon, iter(line + "\n" for line in lines), Sink()) == 4
        resp = [json.loads(s) for s in out_lines]
        assert resp[0]["ok"] and not resp[1]["ok"] and resp[3]["cmd"] == "shutdown"
        want = predict_panel(rig["model"], rig["tcfg"], rig["tds"], np.array([12]),
                             stochastic=False)[0]
        idx = np.nonzero(rig["tds"].valid[12])[0]
        assert resp[0]["results"][0]["scores"] == [float(v) for v in want[idx]]


def test_serve_cli_answers_stdin_on_cpu():
    reqs = "\n".join([json.dumps({"id": 1, "model": "flagship", "day": 25, "top": 2}),
                      json.dumps({"cmd": "stats"}), json.dumps({"cmd": "shutdown"})])
    proc = subprocess.run(
        [sys.executable, "-m", "factorvae_tpu_torch.serve", "--synthetic", "30,10",
         "--device", "cpu"], input=reqs, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    resp = [json.loads(s) for s in proc.stdout.splitlines()]
    assert [r["ok"] for r in resp] == [True, True, True]
    assert resp[0]["n"] == 2 and resp[1]["registry"]["entries"][0]["arch"]["k"] == 96
    assert torch.isfinite(torch.tensor(resp[0]["results"][0]["scores"])).all()
