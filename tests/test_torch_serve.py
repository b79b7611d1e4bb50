"""The serving path on the CPU: the port's `predict_panel` against the JAX
`predict_panel`, and the port's registry, daemon, scheduler, HTTP front and
CLI against the JAX package's.

Shapes: C=12, T=6, H=8, K=4, M=10 on a 30-day synthetic panel of 13 stocks
(padded to 16) for the first classes; C 8, T 5, H 8, K 4, M 8 on a 30-day
panel of 12 stocks (padded to 16) for the daemon's (`srv`). Weights from
the JAX `load_model`, copied in with `flax_to_torch`. Scores hold at the
repo's torch-oracle tolerance, f32 with rtol=1e-5, atol=1e-6, against the
JAX scores (Pallas in interpret mode, or the XLA path). The JAX daemon and
the port's answer the same tick field for field; their keys (config hashes)
differ, because the port's Config has no `use_pallas_*` fields, so the port's
keys are mapped to the JAX keys of the same alias before comparing, and an
"unknown model" error is compared up to its list of known names. The
registry's walk, the breaker's and health's state sequences and the admit
gate's decision are held equal to the JAX package's on the same inputs.
"""

from __future__ import annotations

import dataclasses
import http.client
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time

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

    def test_stacked_gru_matches_jax_and_its_artifact(self, rig, tmp_path):
        """gru_layers = 2: predict_panel against the JAX one from the same
        Flax weights, and a CPU `torch.export` artifact (its lower layers
        plain ops in the graph, the top layer the registered K1 op) scoring
        each day as predict_panel does; the registry admits the weights
        directory (its manifest verified) and scores the same."""
        from factorvae_tpu_torch.eval.export_aot import export_prediction, load_exported

        jcfg = dataclasses.replace(rig["jcfg"], model=dataclasses.replace(
            rig["jcfg"].model, gru_layers=2))
        _, params = jload_model(jcfg, n_max=8)
        tcfg = dataclasses.replace(rig["tcfg"], model=dataclasses.replace(
            rig["tcfg"].model, gru_layers=2))
        model = FactorVAE(tcfg.model)
        model.load_state_dict(flax_to_torch(params))
        model.eval()
        tds = rig["tds"]
        days = tds.split_days(None, None)
        want = jpredict_panel(params, jcfg, rig["jds"], days, stochastic=False)
        got = predict_panel(model, tcfg, tds, days, stochastic=False)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, **SCORE_TOL)
        art = load_exported(export_prediction(model, tcfg, tds.n_max, platform="cpu"))
        ops = {str(n.target) for n in art.program.graph.nodes if n.op == "call_function"}
        assert "factorvae_tpu_torch.gru_fwd.default" in ops
        for i, day in enumerate(days[[0, 11, -1]]):
            x, _, mask = tds.gather(torch.tensor([int(day)]))
            np.testing.assert_allclose(art.call(x, mask).numpy()[0],
                                       got[[0, 11, -1][i]], **SCORE_TOL)
        reg = ModelRegistry(device="cpu")
        key = reg.register_checkpoint(save_weights(model, tcfg, str(tmp_path / "l2")))
        np.testing.assert_array_equal(reg.score(key, tds, days, stochastic=False), got)

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


# ---------------------------------------------------------------------------
# the full daemon against the JAX package's (C 8, T 5, H 8, K 4, M 8)

from factorvae_tpu import chaos as jchaos  # noqa: E402
from factorvae_tpu.eval.predict import predict_panel_fleet as jpredict_panel_fleet  # noqa: E402
from factorvae_tpu.obs.metrics import daemon_metrics as jdaemon_metrics  # noqa: E402
from factorvae_tpu.ops.quant import ensure_quantized as jensure_quantized  # noqa: E402
from factorvae_tpu.serve.daemon import ScoringDaemon as JScoringDaemon  # noqa: E402
from factorvae_tpu.serve.registry import ModelRegistry as JModelRegistry  # noqa: E402
from factorvae_tpu.train.checkpoint import save_params as jsave_params  # noqa: E402
from factorvae_tpu_torch import chaos  # noqa: E402
from factorvae_tpu_torch.eval import predict as tpredict  # noqa: E402
from factorvae_tpu_torch.ops.quant import quantize_params  # noqa: E402
from factorvae_tpu_torch.serve.daemon import (  # noqa: E402
    TickScheduler,
    serve_batch_file,
    serve_http,
)
from factorvae_tpu_torch.serve.registry import RegistryError  # noqa: E402
from factorvae_tpu_torch.utils import logging as tlogging  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SC, ST, SH, SK, SM = 8, 5, 8, 4, 8
HOLDOUT = [20, 21, 22, 23, 24]


def _srv_cfgs(seed):
    jcfg = jconfig.Config(
        model=jconfig.ModelConfig(num_features=SC, hidden_size=SH, num_factors=SK,
                                  num_portfolios=SM, seq_len=ST,
                                  stochastic_inference=False, use_pallas_gru=True,
                                  use_pallas_attention=True),
        data=jconfig.DataConfig(seq_len=ST), train=jconfig.TrainConfig(seed=seed))
    return jcfg, tconfig.Config.from_dict(jcfg.to_dict())


@pytest.fixture(scope="module")
def srv():
    jp = synthetic_panel(num_days=30, num_instruments=12, num_features=SC,
                         missing_prob=0.2, seed=5)
    tp = Panel(values=jp.values, valid=jp.valid,
               dates=jp.dates.values.astype("datetime64[D]"),
               instruments=np.asarray(jp.instruments))
    models = []
    for seed in range(4):
        jcfg, tcfg = _srv_cfgs(seed)
        models.append((jcfg, tcfg, jload_model(jcfg, n_max=16)[1]))
    return dict(jds=JPanelDataset(jp, seq_len=ST), tds=PanelDataset(tp, seq_len=ST, device="cpu"),
                models=models)


class _Side:
    """One package's daemon, registry and chaos, so that a case runs the same
    steps on both."""

    def __init__(self, srv, port: bool):
        self.port = port
        self.srv = srv
        self.ds = srv["tds"] if port else srv["jds"]
        self.chaos = chaos if port else jchaos

    def registry(self, **kw):
        return ModelRegistry(device="cpu", **kw) if self.port else JModelRegistry(**kw)

    def register(self, reg, i, precision=None, alias=None, cfg_of=None):
        jcfg, tcfg, params = self.srv["models"][i]
        if cfg_of is not None:
            jcfg, tcfg, _ = self.srv["models"][cfg_of]
        if self.port:
            return reg.register_params(flax_to_torch(params), tcfg, precision=precision,
                                       alias=alias)
        return reg.register_params(params, jcfg, precision=precision, alias=alias)

    def daemon(self, reg=None, **kw):
        if reg is None:
            reg = self.registry()
            self.register(reg, 0, alias="m0")
        kw.setdefault("stochastic", False)
        return (ScoringDaemon if self.port else JScoringDaemon)(reg, self.ds, **kw)

    def plan(self, *faults):
        return self.chaos.ChaosPlan([self.chaos.Fault(*f[:1], **f[1]) for f in faults])


def _sides(srv):
    return _Side(srv, port=False), _Side(srv, port=True)


# ---- the registry ----------------------------------------------------------


def _registry_walk(S):
    trail = []

    def snap(reg, op):
        st = reg.stats()
        trail.append((op, [e["alias"] for e in st["entries"]], reg.version, reg.hits,
                      reg.misses, reg.evictions, reg.readmissions,
                      [(e["alias"], e["generation"], e["nbytes"]) for e in st["entries"]]))

    probe = S.registry()
    S.register(probe, 0)
    nb = probe.total_bytes()
    reg = S.registry(budget_bytes=int(2.5 * nb))
    for i in (0, 1):
        S.register(reg, i, alias=f"a{i}")
        snap(reg, f"admit a{i}")
    reg.get("a0")
    snap(reg, "touch a0")
    S.register(reg, 2, alias="a2")          # a1 is the least recently used
    snap(reg, "admit a2")
    with pytest.raises(ValueError, match="unknown model 'a1'"):
        reg.get("a1")                       # in-memory: gone with its alias
    snap(reg, "get a1")
    S.register(reg, 0, precision="int8", alias="q0")
    snap(reg, "admit q0")
    # the generation walk, unbounded
    reg = S.registry()
    S.register(reg, 0, alias="g")
    S.register(reg, 0, precision="int8", alias="gq")
    S.register(reg, 0, alias="g")           # the same bytes: a refresh
    snap(reg, "refresh")
    S.register(reg, 3, alias="g", cfg_of=0)  # other bytes under the key
    snap(reg, "readmit")
    S.register(reg, 1, alias="g", cfg_of=0)
    snap(reg, "readmit again")
    return trail


def test_registry_walk_matches_jax(srv):
    j, t = (_registry_walk(S) for S in _sides(srv))
    assert t == j
    assert t[-1][-1] == [("g", 3, t[-1][-1][0][2])] and t[-2][6] == 1


def _save_both(srv, i, tmp_path, name):
    """Weights directories of model i: the JAX layout and the port's."""
    jcfg, tcfg, params = srv["models"][i]
    jsave_params(str(tmp_path / "jax"), name, params)
    with open(tmp_path / "jax" / name / "serve_config.json", "w") as fh:
        json.dump(jcfg.to_dict(), fh)
    model = FactorVAE(tcfg.model)
    model.load_state_dict(flax_to_torch(params))
    save_weights(model, tcfg, str(tmp_path / "port" / name))
    return str(tmp_path / "jax" / name), str(tmp_path / "port" / name)


class TestRegistryColdStart:
    def _evicted(self, srv, tmp_path):
        _, path = _save_both(srv, 0, tmp_path, "w0")
        reg = ModelRegistry(device="cpu")
        key = reg.register_checkpoint(path)
        days = srv["tds"].split_days(None, None)[-6:]
        before = reg.score("w0", srv["tds"], days)
        reg.budget_bytes = 1                  # only the newest survives
        _, tcfg, params = srv["models"][1]
        reg.register_params(flax_to_torch(params), tcfg)
        assert key not in reg.keys() and reg.evictions == 1
        return reg, key, path, days, before

    def test_cold_start_scores_bitwise_as_before(self, srv, tmp_path):
        reg, key, _, days, before = self._evicted(srv, tmp_path)
        entry = reg.get("w0")
        assert entry.key == key and reg.cold_starts == 1 and reg.misses == 1
        assert np.array_equal(reg.score("w0", srv["tds"], days), before, equal_nan=True)
        assert entry.source == "checkpoint" and entry.generation == 1

    def test_failed_cold_start_stays_actionable(self, srv, tmp_path, monkeypatch):
        monkeypatch.setattr(ModelRegistry, "COLD_BACKOFF_S", 0.001)
        reg, _, path, _, _ = self._evicted(srv, tmp_path)
        shutil.rmtree(path)
        for _ in range(2):        # the tombstone survives a failed reload
            with pytest.raises(RegistryError):
                reg.get("w0")
        assert reg.cold_starts == 0
        daemon = ScoringDaemon(reg, srv["tds"])
        resp = daemon.handle({"model": "w0", "day": 20})
        assert not resp["ok"] and daemon.health()["window"] == 1    # the daemon's fault

    def test_serve_cold_fail_heals_with_one_retry(self, srv, tmp_path, monkeypatch):
        monkeypatch.setattr(ModelRegistry, "COLD_BACKOFF_S", 0.001)
        reg, key, _, _, _ = self._evicted(srv, tmp_path)
        plan = chaos.ChaosPlan([chaos.Fault("serve_cold_fail")])
        with chaos.active(plan):
            assert reg.get("w0").key == key
        assert reg.cold_starts == 1 and plan.fired == [{"kind": "serve_cold_fail"}]

    def test_register_artifact_admits_a_port_artifact(self, srv):
        """An AOT artifact admits under its header's config hash and scores
        as `predict_panel` does (one exported call per day); a JAX artifact
        is refused in one line naming its format."""
        from factorvae_tpu.eval.export_aot import export_prediction as jexport
        from factorvae_tpu_torch.eval.export_aot import export_prediction

        jcfg, tcfg, params = srv["models"][0]
        model = FactorVAE(tcfg.model)
        model.load_state_dict(flax_to_torch(params))
        ds = srv["tds"]
        reg = ModelRegistry(device="cpu")
        key = reg.register_artifact(export_prediction(model, tcfg, ds.n_max, platform="cpu"),
                                    alias="a0")
        entry = reg.get("a0")
        assert key == tconfig.config_hash(tcfg.to_dict()) and entry.source == "artifact"
        days = np.arange(ST, 30)
        np.testing.assert_allclose(reg.score("a0", ds, days),
                                   predict_panel(model.eval(), tcfg, ds, days, stochastic=False),
                                   **SCORE_TOL)
        with pytest.raises(RegistryError, match="JAX StableHLO") as ei:
            reg.register_artifact(jexport(params, jcfg, n_max=ds.n_max))
        assert "\n" not in str(ei.value)


# ---- fused dispatch ----------------------------------------------------------

_FUSED_TICK = [
    {"id": 1, "model": "f0", "day": 20, "top": 3}, {"id": 2, "model": "f1", "day": 20, "top": 3},
    {"id": 3, "model": "f0", "day": 20, "top": 3},
    {"id": 4, "model": "b0", "day": 21}, {"id": 5, "model": "b1", "day": 21},
    {"id": 6, "model": "q0", "days": [22, 23]}, {"id": 7, "model": "q1", "days": [22, 23]},
    {"id": 8, "model": "f1", "day": 999}, {"id": 9, "model": "ghost", "day": 3},
    {"id": 10, "model": "f0", "start": "2020-01-25", "end": "2020-02-05"},
    {"id": 11, "cmd": "ping"}, {"id": 12, "cmd": "models"}, {"id": 13, "cmd": "reboot"},
]


def _fused_registry(S):
    reg = S.registry()
    keys = {}
    for i in (0, 1):
        for prec, pre in (("float32", "f"), ("bfloat16", "b"), ("int8", "q")):
            keys[f"{pre}{i}"] = S.register(reg, i, precision=prec, alias=f"{pre}{i}")
    return reg, keys


def _normal(resp, keymap=None):
    """A response without its timings, its port keys as JAX keys. An
    entry's `compiled` is left out: the JAX registry marks only a serial
    call (a fused one warms its fleet program instead), the port's marks the
    first scoring call of either kind."""
    out = {k: v for k, v in resp.items() if k not in ("latency_ms", "run_meta")}
    if keymap and out.get("model") in keymap:
        out["model"] = keymap[out["model"]]
    if "error" in out:
        out["error"] = out["error"].split(" (known:")[0]
    if "models" in out:
        out["models"] = [{**{k: v for k, v in e.items() if k not in ("compiled", "compile_s")},
                          "key": (keymap or {}).get(e["key"], e["key"])}
                         for e in out["models"]]
    return out


class TestFusedDispatch:
    def test_tick_matches_the_jax_daemon(self, srv):
        (js, ts) = _sides(srv)
        jreg, jkeys = _fused_registry(js)
        treg, tkeys = _fused_registry(ts)
        keymap = {tkeys[a]: jkeys[a] for a in tkeys}
        jout = JScoringDaemon(jreg, srv["jds"]).handle_batch(_FUSED_TICK)
        tdaemon = ScoringDaemon(treg, srv["tds"])
        tout = tdaemon.handle_batch(_FUSED_TICK)
        # f0 twice with f1, the bf16 pair, the int8 pair; the range is f0's alone
        assert [r["batched_with"] for r in tout if "batched_with" in r] == [2] * 7 + [1]
        for jr, tr in zip(jout, tout):
            jn, tn = _normal(jr), _normal(tr, keymap)
            jres, tres = jn.pop("results", []), tn.pop("results", [])
            assert tn == jn, tr.get("id")
            assert len(tres) == len(jres)
            for a, b in zip(tres, jres):
                assert a["day"] == b["day"] and a["instruments"] == b["instruments"]
                np.testing.assert_allclose(a["scores"], b["scores"], **SCORE_TOL)
        st = tdaemon.stats()
        assert st["fused_requests"] == 7 and st["dispatches"] == 4
        # every entry the tick scored, fused or serial, has made its first call
        assert all(e["compiled"] for e in st["registry"]["entries"])

    def test_fused_lanes_match_serial_and_one_lane_is_bitwise(self, srv):
        _, ts = _sides(srv)
        reg, _ = _fused_registry(ts)
        ds, days = srv["tds"], np.arange(3, 30)
        for pre in ("f", "b", "q"):
            entries = [reg.get(f"{pre}{i}") for i in (0, 1)]
            lanes = tpredict.predict_panel_fleet(
                tpredict.stack_params([e.params for e in entries]),
                entries[0].score_config, ds, days, stochastic=False, int8=entries[0].int8)
            for e, got in zip(entries, lanes):
                want = reg.score(e, ds, days)
                np.testing.assert_allclose(got, want, **SCORE_TOL)
                one = tpredict.predict_panel_fleet(
                    tpredict.stack_params([e.params]), e.score_config, ds, days,
                    stochastic=False, int8=e.int8)[0]
                assert np.array_equal(one, want, equal_nan=True), pre

    def test_fleet_int8_matches_jax(self, srv):
        import jax
        import jax.numpy as jnp

        days = np.arange(4, 30)
        trees = [m[2] for m in srv["models"][:3]]
        jstacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                                *[jensure_quantized(t) for t in trees])
        want = jpredict_panel_fleet(jstacked, srv["models"][0][0], srv["jds"], days,
                                    stochastic=False, int8=True)
        stacked = tpredict.stack_params([quantize_params(flax_to_torch(t)) for t in trees])
        got = tpredict.predict_panel_fleet(stacked, srv["models"][0][1], srv["tds"], days,
                                           stochastic=False, int8=True)
        assert got.shape == want.shape == (3, 26, 16)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, **SCORE_TOL)
        # a dense stacked tree is quantized lane by lane: the same scores
        dense = tpredict.stack_params([flax_to_torch(t) for t in trees])
        again = tpredict.predict_panel_fleet(dense, srv["models"][0][1], srv["tds"], days,
                                             stochastic=False, int8=True)
        assert np.array_equal(again, got, equal_nan=True)

    def test_a_failed_group_falls_back_to_serial(self, srv, monkeypatch, tmp_path):
        _, ts = _sides(srv)
        reg, _ = _fused_registry(ts)
        daemon = ScoringDaemon(reg, srv["tds"])

        def broken(*a, **k):
            raise RuntimeError("lane-batched launch failed")

        monkeypatch.setattr(tpredict, "predict_panel_fleet", broken)
        path = str(tmp_path / "run.jsonl")
        logger = tlogging.MetricsLogger(jsonl_path=path, echo=False)
        prev = tlogging.install_timeline(tlogging.Timeline(logger))
        try:
            out = daemon.handle_batch([{"id": i, "model": f"f{i}", "day": 20}
                                       for i in (0, 1)])
        finally:
            tlogging.install_timeline(prev)
            logger.finish()
        assert [(r["ok"], r["batched_with"]) for r in out] == [(True, 1), (True, 1)]
        marks = [json.loads(x) for x in open(path)]
        (fb,) = [m for m in marks if m.get("name") == "fused_fallback"]
        assert fb["models"] == 2 and "lane-batched" in fb["error"]
        assert daemon.dispatches == 2 and daemon.fused_requests == 0


# ---- resilience: the JAX TestServeChaos cases, on both daemons ---------------


def _state(resp) -> tuple:
    err = resp.get("error") or ""
    kind = ("deadline" if "deadline exceeded" in err else "circuit" if "circuit open" in err
            else "error" if err else None)
    return (resp["ok"], kind, "retry_after_s" in resp)


def _health(d) -> tuple:
    h = d.health()
    return (d.deadline_misses, d.breaker_fast_fails, bool(d.open_breakers()), h["status"],
            h["error_rate"], h["window"])


# Each case arms the server's deadline after its unstalled requests, and
# stalls by more than the deadline, so that no state depends on how fast
# the host runs a tick.


def _case_stall_breaker_recovery(S):
    d = S.daemon(breaker_k=2, breaker_cooldown_s=1.0)
    day = 20
    trail = [_state(d.handle({"model": "m0", "day": day}))]
    d.deadline_ms = 150.0
    with S.chaos.active(S.plan(("serve_stall", dict(times=2, delay_s=0.25)))):
        trail += [_state(d.handle({"model": "m0", "day": day})) for _ in range(3)]
    trail.append(_health(d))
    time.sleep(1.05)
    d.deadline_ms = 10_000.0
    trail += [_state(d.handle({"model": "m0", "day": day})), _health(d)]
    return trail


def _case_client_deadline(S):
    d = S.daemon(breaker_k=2, breaker_cooldown_s=60.0)
    trail = [_state(d.handle({"model": "m0", "day": 20}))]
    trail += [_state(d.handle({"model": "m0", "day": 20, "deadline_ms": 0.001}))
              for _ in range(3)]
    return trail + [_health(d), _state(d.handle({"model": "m0", "day": 20}))]


def _case_client_past_server(S):
    d = S.daemon(breaker_k=1, breaker_cooldown_s=60.0)
    trail = [_state(d.handle({"model": "m0", "day": 20}))]
    d.deadline_ms = 100.0
    with S.chaos.active(S.plan(("serve_stall", dict(times=1, delay_s=0.25)))):
        trail.append(_state(d.handle({"model": "m0", "day": 20, "deadline_ms": 10.0})))
    return trail + [_health(d)]


def _case_raised_client_deadline(S):
    d = S.daemon(breaker_k=1, breaker_cooldown_s=60.0)
    trail = [_state(d.handle({"model": "m0", "day": 20}))]
    d.deadline_ms = 100.0
    with S.chaos.active(S.plan(("serve_stall", dict(times=1, delay_s=0.25)))):
        trail.append(_state(d.handle({"model": "m0", "day": 20, "deadline_ms": 60000.0})))
    return trail + [_health(d)]


def _case_shared_tick_failure(S):
    d = S.daemon(breaker_k=3, breaker_cooldown_s=60.0, health_window=10)
    trail = [_state(d.handle({"model": "m0", "day": 20}))]
    d.deadline_ms = 100.0
    with S.chaos.active(S.plan(("serve_stall", dict(times=1, delay_s=0.25)))):
        trail += [_state(r) for r in d.handle_batch([{"id": i, "model": "m0", "day": 20}
                                                     for i in range(3)])]
    return trail + [_health(d)]


def _case_fast_fails_do_not_poison(S):
    d = S.daemon(breaker_k=1, breaker_cooldown_s=60.0, health_window=10, failing_at=0.5)
    trail = [_state(d.handle({"model": "m0", "day": 20})) for _ in range(3)]
    d.deadline_ms = 100.0
    with S.chaos.active(S.plan(("serve_stall", dict(times=1, delay_s=0.25)))):
        trail.append(_state(d.handle({"model": "m0", "day": 20})))
    trail += [_state(d.handle({"model": "m0", "day": 20})) for _ in range(8)]
    return trail + [_health(d)]


def _case_health_window(S):
    d = S.daemon(health_window=10, degraded_at=0.1, failing_at=0.5, breaker_k=5)
    trail = [_health(d), _state(d.handle({"model": "m0", "day": 20}))]
    d.deadline_ms = 1e-6
    trail += [_state(d.handle({"model": "m0", "day": 20})) for _ in range(2)]
    trail.append(_health(d))
    d.deadline_ms = 0.0
    trail += [_state(d.handle({"model": "m0", "day": 20})) for _ in range(7)]
    return trail + [_health(d)]


def _case_client_garbage(S):
    d = S.daemon(health_window=10, degraded_at=0.1, failing_at=0.5)
    trail = [_state(d.handle({"model": "m0", "day": 20}))]
    for bad in ({"model": "no_such_model", "day": 20}, {"model": "m0", "day": "not-a-date"},
                {"model": "m0"}, {"model": "m0", "day": 20, "deadline_ms": "x"},
                {"model": "m0", "day": 10 ** 9}, "not an object"):
        trail += [_state(d.handle(bad)) for _ in range(4)]
    return trail + [_health(d)]


def _case_drain(S):
    d = S.daemon()
    trail = [_state(d.handle({"model": "m0", "day": 20}))]
    d.request_drain()
    h = d.health()
    trail += [(h["status"], h["ok"], d.closing)]
    d.request_drain()
    return trail + [d.health()["status"]]


_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_stall_breaker_recovery, _case_client_deadline, _case_client_past_server,
    _case_raised_client_deadline, _case_shared_tick_failure, _case_fast_fails_do_not_poison,
    _case_health_window, _case_client_garbage, _case_drain)}


@pytest.mark.parametrize("case", list(_CASES))
def test_resilience_states_match_jax(srv, case):
    j, t = (_CASES[case](S) for S in _sides(srv))
    assert t == j and len(t) >= 2


# ---- admission ---------------------------------------------------------------


@pytest.mark.parametrize("cand,inc", [(1, 0), (0, 1)], ids=["1_over_0", "0_over_1"])
def test_admit_gate_matches_jax(srv, tmp_path, cand, inc):
    outs = []
    for S in _sides(srv):
        side = tmp_path / ("port" if S.port else "jax")
        inc_j, inc_t = _save_both(srv, inc, side, "inc")
        cand_j, cand_t = _save_both(srv, cand, side, "cand")
        reg = S.registry()
        reg.register_checkpoint(inc_t if S.port else inc_j, alias="prod")
        d = S.daemon(reg)
        boot = d.admit(cand_t if S.port else cand_j, "fresh")      # no incumbent
        out = d.admit(cand_t if S.port else cand_j, "prod", holdout_days=HOLDOUT)
        serving = d.handle({"model": "prod", "day": 20})
        outs.append((boot, out, serving["model"] == out["model"], reg.stats()["aliases"],
                     d.promotions))
    (jb, jo, jserv, jal, jp), (tb, to, tserv, tal, tp) = outs
    assert tb["promoted"] and tb["incumbent"] is None and tb["reason"] == jb["reason"]
    assert to["holdout_days"] == jo["holdout_days"] == HOLDOUT
    np.testing.assert_allclose(to["candidate_rank_ic"], jo["candidate_rank_ic"], rtol=1e-5)
    np.testing.assert_allclose(to["incumbent_rank_ic"], jo["incumbent_rank_ic"], rtol=1e-5)
    assert (to["promoted"], tserv, tp) == (jo["promoted"], jserv, jp)
    assert sorted(tal) == sorted(jal)


def _admit_rig(srv, tmp_path):
    _, inc = _save_both(srv, 0, tmp_path, "inc")
    _, cand = _save_both(srv, 1, tmp_path, "cand")
    reg = ModelRegistry(device="cpu")
    inc_key = reg.register_checkpoint(inc, alias="prod")
    return ScoringDaemon(reg, srv["tds"]), reg, inc_key, cand


def test_fidelity_gate_reject_keeps_the_incumbent(srv, tmp_path):
    d, reg, inc_key, cand = _admit_rig(srv, tmp_path)
    with chaos.active(chaos.ChaosPlan([chaos.Fault("fidelity_gate_reject", request=1)])):
        out = d.admit(cand, "prod", holdout_days=HOLDOUT, min_margin=1.0)
    assert not out["promoted"] and "forced" in out["reason"]
    assert reg.keys() == [inc_key] and reg.resolve_key("prod") == inc_key
    assert d.handle({"model": "prod", "day": 20})["model"] == inc_key


_KILL_SCRIPT = r"""
import json, sys
from factorvae_tpu_torch import config
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.serve.daemon import ScoringDaemon
from factorvae_tpu_torch.serve.registry import ModelRegistry
import numpy as np
z = np.load(sys.argv[1])
panel = Panel(values=z["values"], valid=z["valid"], dates=z["dates"],
              instruments=z["instruments"])
reg = ModelRegistry(device="cpu")
reg.register_checkpoint(sys.argv[2], alias="prod")
d = ScoringDaemon(reg, PanelDataset(panel, seq_len=5, device="cpu"))
print(json.dumps(d.admit(sys.argv[3], "prod", holdout_days=[20, 21, 22, 23, 24],
                         min_margin=1.0)), flush=True)
"""


def test_kill_between_admit_and_drain_then_rerun_flips(srv, tmp_path):
    d, reg, inc_key, cand = _admit_rig(srv, tmp_path)
    ds = srv["tds"]
    panel_file = str(tmp_path / "panel.npz")
    np.savez(panel_file, values=ds.panel.values, valid=ds.panel.valid, dates=ds.panel.dates,
             instruments=np.asarray(ds.panel.instruments, str))
    plan = chaos.ChaosPlan([chaos.Fault("kill_between_admit_and_drain", request=1)])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env[chaos.ENV_VAR] = plan.to_json()
    proc = subprocess.run([sys.executable, "-c", _KILL_SCRIPT, panel_file,
                           str(tmp_path / "port" / "inc"), cand],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == -9 and proc.stdout == "", proc.stderr
    # the re-run admits the same bytes and completes the flip
    out = d.admit(cand, "prod", holdout_days=HOLDOUT, min_margin=1.0)
    again = d.admit(cand, "prod", holdout_days=HOLDOUT, min_margin=1.0)
    assert out["promoted"] and out["incumbent"] == inc_key
    assert again["promoted"] and again["generation"] == 1
    assert reg.resolve_key("prod") == out["model"] and inc_key not in reg.keys()
    assert d.handle({"model": "prod", "day": 20})["model"] == out["model"]


# ---- the scheduler and the HTTP front ----------------------------------------


def _two_model_daemon(srv, **kw):
    _, ts = _sides(srv)
    reg = ts.registry()
    for i in (0, 1):
        ts.register(reg, i, alias=f"m{i}")
    return ScoringDaemon(reg, srv["tds"], **kw)


def test_scheduler_answers_eight_threads_in_order(srv):
    d = _two_model_daemon(srv)
    sched = TickScheduler(d, tick_ms=50.0, max_tick_batch=64)
    results = {}
    go = threading.Barrier(8)

    def client(c):
        # two models on one day fuse within a submission, and across clients
        reqs = [{"id": f"{c}-{k}", "model": f"m{k % 2}", "day": 20 + c % 3} for k in range(3)]
        go.wait()
        results[c] = sched.submit(reqs + [{"_parse_error": "bad JSON: x"}])

    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # interleave the clients as tightly as it can
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    sched.close()
    for c, resp in results.items():
        assert [r["id"] for r in resp] == [f"{c}-0", f"{c}-1", f"{c}-2", None]
        assert all(r["ok"] for r in resp[:3]) and not resp[3]["ok"]
    st = sched.stats()
    assert len(results) == 8 and st["scheduled"] == 24 and st["fused_ticks"] > 0
    assert d.fused_requests > 0
    assert sched.submit([{"model": "m0", "day": 20}])[0]["error"] == "daemon is shutting down"


def test_scheduler_close_answers_what_is_queued(srv):
    d = _two_model_daemon(srv)
    sched = TickScheduler(d, tick_ms=0.0, max_tick_batch=1)
    got = []
    with chaos.active(chaos.ChaosPlan([chaos.Fault("serve_stall", delay_s=0.3)])):
        threads = [threading.Thread(target=lambda i=i: got.append(
            sched.submit([{"id": i, "model": "m0", "day": 20}])[0])) for i in range(4)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 60
        while sched.stats()["scheduled"] < 4 and time.monotonic() < deadline:
            time.sleep(0.01)          # the first tick stalls; the others queue behind it
        sched.close()
        for th in threads:
            th.join(60)
    assert sorted(r["id"] for r in got) == [0, 1, 2, 3] and all(r["ok"] for r in got)
    assert sched.stats()["queued"] == 0 and not sched._thread.is_alive()


def test_scheduler_admits_while_ticks_go_on(srv, tmp_path, monkeypatch):
    d = _two_model_daemon(srv)
    inc_key = d.registry.resolve_key("m0")
    _, cand = _save_both(srv, 2, tmp_path, "cand")
    sched = TickScheduler(d, tick_ms=1.0)
    in_gate, release = threading.Event(), threading.Event()
    gate = d._gate_rank_ic

    def held_gate(key, days):        # the gate's scoring, held until released
        in_gate.set()
        assert release.wait(30), "the tick was not answered while the gate ran"
        return gate(key, days)

    monkeypatch.setattr(d, "_gate_rank_ic", held_gate)
    out = []
    admit = threading.Thread(target=lambda: out.extend(sched.submit([
        {"id": "a", "cmd": "admit", "path": cand, "alias": "m0", "holdout_days": HOLDOUT,
         "min_margin": 1.0}])))
    admit.start()
    try:
        assert in_gate.wait(30)
        # a tick during the admission answers, from the incumbent
        (resp,) = sched.submit([{"id": 1, "model": "m0", "day": 20}])
        assert resp["ok"] and resp["model"] == inc_key
    finally:
        release.set()
        admit.join(60)
    (verdict,) = out
    assert verdict["id"] == "a" and verdict["cmd"] == "admit" and verdict["promoted"]
    (after,) = sched.submit([{"id": 2, "model": "m0", "day": 20}])
    assert after["model"] == verdict["model"] != inc_key
    sched.close()
    st = sched.stats()
    assert st["admitted"] == 1 and st["queued"] == 0 and not sched._admit_thread.is_alive()


class _Front:
    """serve_http on 127.0.0.1, any free port, in a thread."""

    def __init__(self, daemon, scheduler=None):
        self.daemon = daemon
        bound = threading.Event()
        self.port = None

        def ready(server):
            self.port = server.server_address[1]
            bound.set()

        self.thread = threading.Thread(target=serve_http, args=(daemon, 0),
                                       kwargs=dict(scheduler=scheduler, ready=ready))
        self.thread.start()
        assert bound.wait(30)

    def call(self, method, path, body=None, headers=None, conn=None):
        c = conn or http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        c.request(method, path, body=None if body is None else json.dumps(body),
                  headers=headers or {})
        r = c.getresponse()
        data = r.read().decode()
        if conn is None:
            c.close()
        ctype = r.getheader("Content-Type")
        return r.status, (json.loads(data) if "json" in ctype else data)

    def stop(self):
        self.call("POST", "/score", {"cmd": "shutdown"})
        self.thread.join(30)
        assert not self.thread.is_alive()


@pytest.mark.parametrize("threaded", [False, True], ids=["single", "scheduler"])
def test_http_endpoints(srv, tmp_path, threaded):
    d = _two_model_daemon(srv)
    _, cand = _save_both(srv, 2, tmp_path, "cand")
    path = str(tmp_path / "run.jsonl")
    logger = tlogging.MetricsLogger(jsonl_path=path, echo=False)
    prev = tlogging.install_timeline(tlogging.Timeline(logger))
    front = _Front(d, TickScheduler(d, tick_ms=5.0) if threaded else None)
    try:
        status, one = front.call("POST", "/score", {"id": 1, "model": "m0", "day": 20},
                                 headers={"X-Factorvae-Trace": "edge-7;lb"})
        assert status == 200 and one["ok"] and one["id"] == 1
        status, many = front.call("POST", "/score", [{"id": 2, "model": "m0", "day": 21},
                                                     {"id": 3, "model": "m1", "day": 21}])
        assert [r["batched_with"] for r in many] == [2, 2]
        assert front.call("POST", "/score", [])[1] == []
        status, stats = front.call("GET", "/stats")
        assert status == 200 and stats["fused_requests"] == 2
        assert ("scheduler" in stats) == threaded
        status, models = front.call("GET", "/models")
        assert {m["alias"] for m in models["models"]} == {"m0", "m1"} and models["run_meta"]
        status, health = front.call("GET", "/healthz")
        assert status == 200 and health["status"] == "ok" and health["mono"] >= 0
        status, text = front.call("GET", "/metrics")
        assert status == 200 and "factorvae_serve_request_latency_seconds_bucket" in text
        assert front.call("POST", "/admit", {"alias": "prod"})[0] == 400
        status, adm = front.call("POST", "/admit", {"path": cand, "alias": "prod"})
        assert status == 200 and adm["promoted"] and adm["incumbent"] is None
        status, prof = front.call("POST", "/profile", {"action": "start",
                                                       "log_dir": str(tmp_path / "prof")})
        assert status == 200 and prof["ok"] and prof["log_dir"] == str(tmp_path / "prof")
        front.call("POST", "/score", {"id": 4, "model": "m0", "day": 22})
        status, prof = front.call("POST", "/profile", {"action": "stop"})
        assert status == 200 and prof["ok"] and prof["files"] == 1 and prof["total_us"] > 0
        assert front.call("GET", "/nope")[0] == 404
    finally:
        front.stop()
        tlogging.install_timeline(prev)
        logger.finish()
    spans = [json.loads(x) for x in open(path)]
    traced = [s for s in spans if s.get("trace") == "edge-7"]
    names = {s["name"] for s in traced}
    assert {"serve_dispatch", "serve_request"} <= names
    if threaded:
        (q,) = [s for s in traced if s["name"] == "serve_queue"]
        assert q["parent"] == "lb" and q["resource"] == "scheduler"


def test_http_metrics_families_match_jax_and_503_while_draining(srv):
    tick = [{"id": 1, "model": "m0", "day": 20}, {"id": 2, "model": "m1", "day": 20},
            {"id": 3, "model": "m0", "day": 21}, {"id": 4, "model": "ghost", "day": 1}]
    js, _ = _sides(srv)
    jreg = js.registry()
    for i in (0, 1):
        js.register(jreg, i, alias=f"m{i}")
    jd = JScoringDaemon(jreg, srv["jds"])
    jd.handle_batch(tick)
    d = _two_model_daemon(srv)
    front = _Front(d, TickScheduler(d, tick_ms=1.0))
    conn = http.client.HTTPConnection("127.0.0.1", front.port, timeout=60)
    front.call("POST", "/score", tick, conn=conn)
    _, text = front.call("GET", "/metrics", conn=conn)

    def families(t):
        return sorted(line for line in t.splitlines() if line.startswith("# TYPE"))

    assert families(text) == families(jdaemon_metrics(jd))
    assert front.call("GET", "/healthz", conn=conn)[0] == 200
    d.request_drain()      # the loop ends; the kept-alive connection still answers
    status, health = front.call("GET", "/healthz", conn=conn)
    assert status == 503 and health["status"] == "draining"
    conn.close()
    front.thread.join(30)
    assert not front.thread.is_alive()


# ---- the serve CLI ---------------------------------------------------------


def test_cli_batch_equals_handle_batch(srv, tmp_path):
    paths = [_save_both(srv, i, tmp_path, f"w{i}")[1] for i in (0, 1)]
    reqs = [{"id": 1, "model": "w0", "day": 20, "top": 4}, {"id": 2, "model": "w1", "day": 20},
            {"id": 3, "model": "w1", "days": [21, 22]}, {"id": 4, "model": "w0", "day": 99},
            {"id": 5, "cmd": "ping"}]
    req_file = tmp_path / "reqs.jsonl"
    req_file.write_text("\n".join(json.dumps(r) for r in reqs) + "\nnot json\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "factorvae_tpu_torch.serve", "--model", paths[0], "--model",
         paths[1], "--synthetic", "30,12", "--device", "cpu", "--batch", str(req_file),
         "--out", str(tmp_path / "out.jsonl"), "--compile_cache", str(tmp_path / "cc"),
         "--warmup", "--budget_mb", "10"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = [json.loads(x) for x in open(tmp_path / "out.jsonl")]
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense

    reg = ModelRegistry(device="cpu")
    for p in paths:
        reg.register_checkpoint(p)
    ds = PanelDataset(synthetic_panel_dense(30, 12, SC, seed=0), seq_len=ST, device="cpu")
    reg.warmup(ds)
    sink = io.StringIO()
    assert serve_batch_file(ScoringDaemon(reg, ds), str(req_file), sink) == 6
    want = [json.loads(x) for x in sink.getvalue().splitlines()]
    assert [_normal(r) for r in got] == [_normal(r) for r in want]
    assert [r["batched_with"] for r in got[:3]] == [2, 2, 1] and not got[5]["ok"]


def _fleet_of(argv, tmp_path):
    from factorvae_tpu_torch.serve.__main__ import _pool_refusal, build_fleet, build_parser

    args = build_parser().parse_args(["--model", str(tmp_path / "w0"), "--synthetic", "30,12",
                                      "--device", "cpu", "--workers", "2", *argv])
    assert _pool_refusal(args) is None
    return build_fleet(args, str(tmp_path / "work"))


def _wired_workers(tmp_path):
    pool, _, _ = _fleet_of(["--workers", "3"], tmp_path)
    return [w.wid for w in pool.workers] == ["w0", "w1", "w2"]


def _wired_router_port(tmp_path):
    pool, _, _ = _fleet_of(["--router_port", "8811"], tmp_path)
    return pool.router_url == "http://127.0.0.1:8811"


def _wired_aot_store(tmp_path):
    pool, _, _ = _fleet_of(["--aot_store", str(tmp_path / "store")], tmp_path)
    return pool.store.root == str(tmp_path / "store") and pool.store.platform == "cpu"


def _wired_join(tmp_path, capsys):
    from factorvae_tpu_torch.serve.__main__ import main

    # the agent asks the (absent) router for its artifacts, and says so
    assert main(["--join", "http://127.0.0.1:9", "--device", "cpu",
                 "--aot_store", str(tmp_path / "join")]) == 2
    return "cannot reach the fleet's artifact service" in capsys.readouterr().err


def _wired_advertise_host(tmp_path, monkeypatch):
    from factorvae_tpu_torch.serve import __main__ as cli_main
    from factorvae_tpu_torch.serve import remote

    seen = {}
    monkeypatch.setattr(remote, "prepare_join", lambda args, parser: "cap")
    monkeypatch.setattr(remote, "register_when_healthy",
                        lambda url, port, cap, host: seen.update(host=host, cap=cap))
    # registration is wired; serving then stops at the missing panel
    assert cli_main.main(["--join", "http://127.0.0.1:9", "--advertise_host", "10.0.0.7",
                          "--device", "cpu"]) == 2
    return seen == {"host": "10.0.0.7", "cap": "cap"}


def _wired_slo_ms(tmp_path):
    _, router, scaler = _fleet_of(["--slo_ms", "50", "--autoscale", "4"], tmp_path)
    return router.slo_ms == 50.0 and scaler.slo_ms == 50.0


def _wired_hedge_ms(tmp_path):
    _, router, _ = _fleet_of(["--hedge_ms", "5"], tmp_path)
    measured = _fleet_of([], tmp_path)[1]
    return router._hedge_delay_s() == 0.005 and measured.hedge_ms == -1.0


def _wired_no_hedge(tmp_path):
    _, router, _ = _fleet_of(["--no_hedge"], tmp_path)
    return not router.hedge_enabled and router._hedge_delay_s() is None


def _wired_autoscale(tmp_path):
    _, router, scaler = _fleet_of(["--autoscale", "4"], tmp_path)
    return (router.autoscaler is scaler and (scaler.min_workers, scaler.max_workers)
            == (2, 4) and _fleet_of([], tmp_path)[2] is None)


def _wired_max_inflight(tmp_path):
    _, router, _ = _fleet_of(["--max_inflight", "8"], tmp_path)
    return router.max_inflight == 8


@pytest.mark.parametrize("wired,bad", [
    (_wired_workers, ["--workers", "0"]),
    (_wired_router_port, ["--workers", "2", "--model", "w", "--router_port", "70000"]),
    (_wired_aot_store, ["--workers", "2", "--model", "w", "--aot_store", __file__]),
    (_wired_join, ["--join", "u"]),
    (_wired_advertise_host, ["--join", "http://127.0.0.1:9", "--advertise_host", ""]),
    (_wired_slo_ms, ["--slo_ms", "-5"]),
    (_wired_hedge_ms, ["--hedge_ms", "-1"]),
    (_wired_no_hedge, ["--no_hedge", "--hedge_ms", "5"]),
    (_wired_autoscale, ["--workers", "2", "--model", "w", "--autoscale", "2"]),
    (_wired_max_inflight, ["--max_inflight", "-1"])],
    ids=lambda c: c.__name__[len("_wired_"):] if callable(c) else None)
def test_cli_wires_the_pool_flag(wired, bad, tmp_path, capsys, monkeypatch):
    """Each pool flag reaches the WorkerPool, Router or AutoScaler it
    configures (or the remote join); a bad value exits 2 naming the flag,
    before the dataset is read."""
    import inspect

    from factorvae_tpu_torch.serve.__main__ import main

    extra = {"capsys": capsys, "monkeypatch": monkeypatch}
    kw = {k: v for k, v in extra.items() if k in inspect.signature(wired).parameters}
    assert wired(tmp_path, **kw)
    capsys.readouterr()
    assert main(["--dataset", "/nonexistent.pkl", *bad]) == 2
    err = capsys.readouterr().err.strip()
    assert err.startswith("error: --") and len(err.splitlines()) == 1
    assert bad[-2] in err or bad[0] in err


# ---- the plan's serving knobs ----------------------------------------------


def _serve_row(tcfg, platform="cpu", n_min=10, n_max=20, **blocks):
    m = tcfg.model
    return {"platform": platform, "n_min": n_min, "n_max": n_max,
            "shape": {"c": m.num_features, "t": m.seq_len, "h": m.hidden_size,
                      "k": m.num_factors, "m": m.num_portfolios},
            "train": {"days_per_step": 1, "compute_dtype": "float32"},
            "source": "test row", **blocks}


SERVE_PLAN_CASES = [
    ("bf16_row", {"serve": {"precision": "bfloat16"}}, 16, None),
    ("int8_row", {"serve": {"precision": "int8", "tick_ms": 0}}, 16, None),
    ("no_serve_block", {}, 16, None),
    ("null_serve_block", {"serve": None}, 16, None),
    ("outside_the_envelope", {"serve": {"precision": "int8"}}, 40, None),
    ("no_width", {"serve": {"precision": "int8"}}, None, None),
    ("explicit_float32_wins", {"serve": {"precision": "int8"}}, 16, "float32"),
    ("explicit_bf16_wins", {}, 16, "bfloat16"),
    ("other_platform", {"platform": "gpu", "serve": {"precision": "int8"}}, 16, None),
]


@pytest.mark.parametrize("case,blocks,n,explicit", SERVE_PLAN_CASES,
                         ids=[c[0] for c in SERVE_PLAN_CASES])
def test_registry_precision_resolves_as_the_jax_registry(srv, case, blocks, n, explicit):
    """Explicit rung > the matched row's serve block > float32, on the same
    table as `JModelRegistry(plan_table=...)` (both on the CPU)."""
    jcfg, tcfg, params = srv["models"][0]
    table = [_serve_row(tcfg, **blocks)]
    jreg, treg = JModelRegistry(plan_table=table), ModelRegistry(device="cpu",
                                                                 plan_table=table)
    jk = jreg.register_params(params, jcfg, precision=explicit, n_stocks=n)
    tk = treg.register_params(flax_to_torch(params), tcfg, precision=explicit, n_stocks=n)
    assert treg.get(tk).precision == jreg.get(jk).precision
    assert tk.partition(":")[2] == jk.partition(":")[2]
    want = {"bf16_row": "bfloat16", "int8_row": "int8",
            "explicit_bf16_wins": "bfloat16"}.get(case, "float32")
    assert treg.get(tk).precision == want


@pytest.fixture
def serve_table(tmp_path, monkeypatch):
    from factorvae_tpu_torch import plan as tplan

    def write(*rows):
        path = str(tmp_path / "torch_table.json")
        tplan.save_rows(rows, path=path)
        monkeypatch.setenv(tplan.PLAN_TABLE_ENV, path)
    return write


def test_precision_plan_admits_at_the_rows_rung(srv, tmp_path, serve_table, capsys):
    from factorvae_tpu_torch.serve.__main__ import main

    _, path = _save_both(srv, 0, tmp_path, "w0")
    serve_table(_serve_row(srv["models"][0][1], serve={"precision": "bfloat16"}))
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text(json.dumps({"id": 1, "model": "w0", "day": 20}) + "\n"
                    + json.dumps({"cmd": "stats"}) + "\n")
    out = tmp_path / "out.jsonl"
    assert main(["--model", path, "--synthetic", "30,12", "--device", "cpu", "--batch",
                 str(reqs), "--out", str(out)]) == 0
    err = capsys.readouterr().err
    assert "(alias w0, bfloat16," in err and "at bfloat16" in err
    resp = [json.loads(x) for x in open(out)]
    assert resp[0]["ok"] and resp[0]["model"].endswith(":bfloat16")
    assert [e["precision"] for e in resp[1]["registry"]["entries"]] == ["bfloat16"]
    # an explicit rung wins over the row
    assert main(["--model", path, "--synthetic", "30,12", "--device", "cpu", "--batch",
                 str(reqs), "--out", str(out), "--precision", "float32"]) == 0
    assert [e["precision"] for e in [json.loads(x) for x in open(out)][1]["registry"][
        "entries"]] == ["float32"]


def test_scheduler_and_fleet_defaults_come_from_the_row(srv, tmp_path, serve_table):
    """--tick_ms / --max_batch (a --scheduler front) and --slo_ms /
    --hedge_ms (a fleet) take the row's values when unset, the flags when
    set, and the no-plan defaults without a row; a measured 0 survives."""
    from factorvae_tpu_torch.serve.__main__ import (
        build_parser,
        fleet_plan_defaults,
        scheduler_knobs,
        serving_plan,
    )

    _, path = _save_both(srv, 0, tmp_path, "w0")
    tcfg = srv["models"][0][1]
    serve_table(_serve_row(tcfg, serve={"tick_ms": 0, "max_tick_batch": 16,
                                        "slo_ms": 40.0, "hedge_ms": 0}))

    def args(*extra):
        return build_parser().parse_args(["--model", path, "--synthetic", "30,12",
                                          "--device", "cpu", *extra])

    pl = serving_plan(tcfg, 16, "cpu")
    assert scheduler_knobs(args(), pl) == (0.0, 16)
    assert scheduler_knobs(args("--tick_ms", "3", "--max_batch", "8"), pl) == (3.0, 8)
    assert scheduler_knobs(args(), serving_plan(None, 16, "cpu")) == (2.0, 64)
    assert scheduler_knobs(args(), serving_plan(tcfg, 40, "cpu")) == (2.0, 64)
    assert fleet_plan_defaults(args(), 16) == (40.0, 0.0)
    assert fleet_plan_defaults(args("--slo_ms", "10", "--hedge_ms", "7"), 16) == (10.0, 7.0)
    assert fleet_plan_defaults(args(), 40) == (0.0, -1.0)
    # the same values as the JAX planner on the same row
    from factorvae_tpu import plan as jplan

    jpl = jplan.plan_for_config(srv["models"][0][0], 16, platform="cpu",
                                table=[_serve_row(tcfg, serve={"tick_ms": 0,
                                                               "max_tick_batch": 16,
                                                               "slo_ms": 40.0,
                                                               "hedge_ms": 0})])
    assert (jpl.serve_tick_ms, jpl.serve_max_tick_batch, jpl.serve_slo_ms,
            jpl.serve_hedge_ms) == (pl.serve_tick_ms, pl.serve_max_tick_batch,
                                    pl.serve_slo_ms, pl.serve_hedge_ms)


def test_pool_hands_its_workers_the_compile_cache(tmp_path):
    pool, _, _ = _fleet_of(["--compile_cache", str(tmp_path / "cc")], tmp_path)
    cmd = pool._worker_cmd(pool.workers[0], ["m"])
    assert cmd[cmd.index("--compile_cache") + 1] == str(tmp_path / "cc")
    plain, _, _ = _fleet_of([], tmp_path)
    assert "--compile_cache" not in plain._worker_cmd(plain.workers[0], ["m"])
