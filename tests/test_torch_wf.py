"""The port's walk-forward refit (`factorvae_tpu_torch/wf`).

Stage by stage against the JAX package where the JAX stage runs on this
machine: the cycle journal's documents for the same call sequence (equal
but for timestamps), `holdout_day_indices`, `warm_refit` from the same warm
weights on a dataset built straight from a `Panel` (parameters at rtol 2e-5
/ atol 2e-6, losses at rtol 2e-5) and `refit_rank_ic`. The JAX cycle itself
fails here (its store reads the slab dates back wrong under pandas 3, so its
training split comes out empty), so the whole cycle is pinned on the port
alone: zero dropped requests under a client thread, the refit bitwise a
plain `warm_refit`, one trace tree, and `python -m factorvae_tpu_torch.wf` killed at the append,
the refit and the promotion in a subprocess, resuming to byte-identical
weights and slabs. Everything runs on the CPU at a small size (C 6, T 5,
H 8, K 4, M 8, 8 stocks, 14 + 2 days). The cycle rigs pass `min_margin` 2,
so that the gate promotes whatever the Rank-ICs of such a small model.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.train.trainer import Trainer as JTrainer
from factorvae_tpu.wf.journal import CycleJournal as JCycleJournal
from factorvae_tpu.wf.operator import holdout_day_indices as jholdout_day_indices
from factorvae_tpu.wf.operator import refit_rank_ic as jrefit_rank_ic
from factorvae_tpu.wf.operator import warm_refit as jwarm_refit
from factorvae_tpu_torch import chaos
from factorvae_tpu_torch.chaos import ops as chaos_ops
from factorvae_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from factorvae_tpu_torch.data.append import PanelStore
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel, panel_to_frame
from factorvae_tpu_torch.data.synthetic import continuation_panel, synthetic_panel_dense
from factorvae_tpu_torch.params import flax_to_torch, read_state_dict
from factorvae_tpu_torch.serve.daemon import ScoringDaemon
from factorvae_tpu_torch.serve.registry import ModelRegistry
from factorvae_tpu_torch.wf import (
    STAGES,
    CycleJournal,
    JournalError,
    WalkForwardError,
    WalkForwardOperator,
    holdout_day_indices,
    refit_rank_ic,
    warm_refit,
)
from factorvae_tpu_torch.wf.__main__ import main as wf_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, T, H, K, M = 6, 5, 8, 4, 8
PARAM_TOL = dict(rtol=2e-5, atol=2e-6)
LOSS_RTOL = 2e-5
# Parameters whose gradient is zero up to rounding (tests/test_torch_fleet.py):
# each package feeds Adam its own rounding noise there, so they are held to
# the sum of the run's learning rates instead.
ZERO_GRAD = ("factor_encoder.portfolio.bias", "factor_predictor.key_bias")


def tiny_cfg(run_name: str = "walkforward", **train) -> Config:
    return Config(
        model=ModelConfig(num_features=C, hidden_size=H, num_factors=K, num_portfolios=M,
                          seq_len=T, stochastic_inference=False),
        data=DataConfig(seq_len=T, start_time=None, fit_end_time=None,
                        val_start_time=None, val_end_time=None, panel_residency="stream"),
        train=TrainConfig(seed=0, run_name=run_name, **train))


def _strip_times(obj):
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if k not in ("started", "finished", "_ts")}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------


def _journal_calls(j):
    j.set_meta("incumbent_path", "/w/incumbent")
    j.begin_cycle("c00002", start="2015-01-22", end="2015-01-23", days=2)
    j.commit("append", {"slab": "slab_00002.npz", "n_days_total": 16})
    j.commit("judge", {"trigger": True, "reason": "force_refit", "rank_corr": None})
    j.mark("refit_started")
    j.commit("refit", {"winner": "warm", "holdout_days": [15]})
    j.commit("promote", {"promoted": True, "generation": 1})
    j.commit("verify", {"day": 15, "n": 8})
    j.finish_cycle()
    j.begin_cycle("c00003", days=2)
    j.commit("append", {"slab": "slab_00003.npz"})


class TestCycleJournal:
    def test_documents_equal_the_jax_journals(self, tmp_path):
        """The same call sequence leaves the same main and .bak documents in
        both packages, timestamps aside."""
        docs = {}
        for name, cls in (("port", CycleJournal), ("jax", JCycleJournal)):
            path = str(tmp_path / f"{name}_wf.json")
            _journal_calls(cls(path))
            docs[name] = [_strip_times(json.load(open(p))) for p in (path, path + ".bak")]
        assert docs["port"] == docs["jax"]
        assert STAGES == ("append", "judge", "refit", "promote", "verify")

    def test_commit_resume_roundtrip(self, tmp_path):
        path = str(tmp_path / "run_wf.json")
        j = CycleJournal(path)
        j.begin_cycle("c00002", days=2)
        j.commit("append", {"slab": "s2"})
        j2 = CycleJournal(path)
        assert j2.open_cycle()["id"] == "c00002"
        assert j2.committed("append")["slab"] == "s2" and j2.committed("judge") is None
        assert j2.begin_cycle("c00002")["id"] == "c00002"

    def test_committed_stages_are_immutable(self, tmp_path):
        j = CycleJournal(str(tmp_path / "j.json"))
        j.begin_cycle("c1")
        j.commit("append", {"x": 1})
        with pytest.raises(JournalError, match="immutable"):
            j.commit("append", {"x": 2})
        with pytest.raises(JournalError, match="unknown stage"):
            j.commit("nope", {})
        with pytest.raises(JournalError, match="uncommitted"):
            j.finish_cycle()
        with pytest.raises(JournalError, match="still open"):
            j.begin_cycle("c2")

    def test_torn_main_falls_back_to_bak(self, tmp_path):
        """The main document torn mid-line (the chaos kind torn_jsonl): the
        .bak holds the previous commit, so one stage re-runs."""
        path = str(tmp_path / "j.json")
        j = CycleJournal(path)
        j.begin_cycle("c1")
        j.commit("append", {"n": 1})
        j.commit("judge", {"n": 2})
        chaos_ops.tear_jsonl(path, keep_frac=0.5, rng_seed=0)
        j2 = CycleJournal(path)
        assert j2.recovered_from_backup
        assert j2.committed("append") is not None and j2.committed("judge") is None
        j2.commit("judge", {"n": 2})
        assert not CycleJournal(path).recovered_from_backup

    def test_both_documents_dead_is_actionable(self, tmp_path):
        path = str(tmp_path / "j.json")
        j = CycleJournal(path)
        j.begin_cycle("c1")
        j.commit("append", {})
        for p in (path, path + ".bak"):
            with open(p, "w") as fh:
                fh.write("{torn")
        with pytest.raises(JournalError, match="unreadable.*move the damaged file aside"):
            CycleJournal(path)


# ---------------------------------------------------------------------------
# the refit's stages against the JAX functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def panels():
    jp = synthetic_panel(num_days=30, num_instruments=10, num_features=C,
                         missing_prob=0.1, seed=2)
    values = jp.values.copy()
    values[:, -1, -1] = np.nan            # the last day has no labels
    values[:7, -2, -1] = np.nan           # the one before, 3 of 10
    jp = dataclasses.replace(jp, values=values)
    tp = Panel(values=values, valid=jp.valid, dates=jp.dates.values.astype("datetime64[D]"),
               instruments=np.asarray(jp.instruments))
    return jp, tp


def _jcfg(jp, save_dir, seed=3) -> jconfig.Config:
    d = [str(x.date()) for x in jp.dates]
    return jconfig.Config(
        model=jconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                  num_portfolios=M, seq_len=T, dropout_rate=0.0,
                                  recon_loss="nll", stochastic_inference=False),
        data=jconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[21],
                                val_start_time=d[22], val_end_time=d[29]),
        train=jconfig.TrainConfig(num_epochs=2, lr=1e-3, seed=seed, checkpoint_every=0,
                                  recover_after=0, save_dir=str(save_dir)))


class TestRefitStages:
    def test_holdout_day_indices_match_jax(self, panels):
        jp, tp = panels
        jds, tds = JPanelDataset(jp, seq_len=T), PanelDataset(tp, seq_len=T, device="cpu")
        for n in (1, 2, 3):
            assert holdout_day_indices(tds, n) == jholdout_day_indices(jds, n)
        assert holdout_day_indices(tds, 1) == [28]      # the day with 3 labels
        empty = dataclasses.replace(tp, values=np.where(
            np.arange(tp.values.shape[-1]) == tp.values.shape[-1] - 1, np.nan, tp.values))
        with pytest.raises(WalkForwardError, match="no day with >=3 finite labels"):
            holdout_day_indices(PanelDataset(empty, seq_len=T, device="cpu"))

    def test_warm_refit_and_rank_ic_match_jax(self, panels, tmp_path):
        """From the same warm weights (another seed's init), a fresh
        optimizer and schedule: the port's refit tracks the JAX one, and
        both packages judge the result with the same holdout Rank-IC."""
        jp, tp = panels
        jcfg = _jcfg(jp, tmp_path / "jax")
        jds = JPanelDataset(jp, seq_len=T)
        warm = JTrainer(_jcfg(jp, tmp_path / "w", seed=7), jds).init_state().params
        warm_sd = flax_to_torch(warm)
        jstate, jinfo, _ = jwarm_refit(jcfg, jds, warm_params=warm)
        tcfg = Config.from_dict(jcfg.to_dict())
        tcfg = dataclasses.replace(tcfg, train=dataclasses.replace(
            tcfg.train, save_dir=str(tmp_path / "port")))
        tds = PanelDataset(tp, seq_len=T, device="cpu")
        state, info, weights = warm_refit(tcfg, tds, warm_params=warm_sd)
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose([r[key] for r in info["history"]],
                                       [r[key] for r in jinfo["history"]], rtol=LOSS_RTOL)
        np.testing.assert_allclose(info["best_val"], jinfo["best_val"], rtol=LOSS_RTOL)
        want = flax_to_torch(jstate.params)
        lr_sum = tcfg.train.lr * info["history"][-1]["step"]
        for name, p in state.model.state_dict().items():
            if name in ZERO_GRAD:
                assert float((p - want[name]).abs().max()) <= lr_sum, name
            else:
                np.testing.assert_allclose(p.numpy(), want[name].numpy(), **PARAM_TOL,
                                           err_msg=name)
        assert os.path.isfile(os.path.join(weights, "weights.pt"))
        days = holdout_day_indices(tds, 3)
        model = type(state.model)(tcfg.model)
        model.load_state_dict(want)
        got = refit_rank_ic(model.eval(), tcfg, tds, days)
        np.testing.assert_allclose(got, jrefit_rank_ic(jstate.params, jcfg, jds, days),
                                   rtol=1e-6, atol=1e-7)
        assert np.isfinite(got)

    def test_a_probed_refit_tracks_the_jax_one_and_its_own_unprobed_run(self, panels,
                                                                         tmp_path):
        """`train.obs_probes` through the refit: the probes of each epoch
        within `tests/test_torch_probes.py`'s tolerances of the JAX refit's,
        and the weights bitwise the unprobed refit's."""
        from factorvae_tpu_torch.obs.probes import TRAIN_PROBE_KEYS

        jp, tp = panels
        jcfg = _jcfg(jp, tmp_path / "jax")
        jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train,
                                                                   obs_probes=True))
        jds = JPanelDataset(jp, seq_len=T)
        warm = JTrainer(_jcfg(jp, tmp_path / "w", seed=7), jds).init_state().params
        warm_sd = flax_to_torch(warm)              # before the JAX refit donates it
        _, jinfo, _ = jwarm_refit(jcfg, jds, warm_params=warm)
        tds = PanelDataset(tp, seq_len=T, device="cpu")
        runs = {}
        for on in (True, False):
            tcfg = Config.from_dict(jcfg.to_dict())
            tcfg = dataclasses.replace(tcfg, train=dataclasses.replace(
                tcfg.train, obs_probes=on, save_dir=str(tmp_path / f"port_{on}")))
            runs[on] = warm_refit(tcfg, tds, warm_params=warm_sd)
        rtol = {"grad_norm_max": 1e-4, "grad_norm_mean": 1e-4, "update_norm_mean": 5e-3,
                "param_norm_last": 2e-5, "factor_mu_spread": 2e-5, "factor_sigma_mean": 2e-5,
                "nonfinite_grads": 0.0, "nonfinite_loss": 0.0}
        for got, want in zip(runs[True][1]["history"], jinfo["history"]):
            for key in TRAIN_PROBE_KEYS:
                np.testing.assert_allclose(got[key], want[key], rtol=rtol[key], atol=0,
                                           err_msg=key)
        on_sd, off_sd = runs[True][0].model.state_dict(), runs[False][0].model.state_dict()
        assert all(torch.equal(on_sd[k], off_sd[k]) for k in on_sd)

    def test_a_refused_trainer_knob_is_an_operator_error(self, panels, tmp_path):
        """The refit trains with the caller's config: a stock mesh (ROADMAP
        Queue 1 item 12) is refused as a WalkForwardError. (`train.remat`
        trains: tests/test_torch_remat.py.)"""
        jp, tp = panels
        tcfg = Config.from_dict(_jcfg(jp, tmp_path).to_dict())
        tcfg = dataclasses.replace(tcfg, mesh=dataclasses.replace(tcfg.mesh, stock_axis=2))
        with pytest.raises(WalkForwardError, match="mesh.stock_axis.*item 12"):
            warm_refit(tcfg, PanelDataset(tp, seq_len=T, device="cpu"))


# ---------------------------------------------------------------------------
# the whole cycle, on the port alone
# ---------------------------------------------------------------------------


class TestWalkForwardCycle:
    @pytest.fixture(scope="class")
    def rig(self, tmp_path_factory):
        base = str(tmp_path_factory.mktemp("wf_cycle"))
        store = PanelStore.create(os.path.join(base, "store"),
                                  synthetic_panel_dense(14, 8, C, seed=0))
        ds = PanelDataset(store.load_panel(), seq_len=T, device="cpu", residency="stream")
        daemon = ScoringDaemon(ModelRegistry(device="cpu"), ds, stochastic=False)
        op = WalkForwardOperator(store, ds, daemon, tiny_cfg(num_epochs=1),
                                 os.path.join(base, "run"), force_refit=True,
                                 refit_epochs=1, drift_threshold=0.4, min_margin=2.0)
        op.ensure_incumbent(epochs=1)
        return op, base

    def test_cycle_completes_with_zero_dropped_requests(self, rig):
        op, _ = rig
        daemon = op.daemon
        probe_day = int(op.dataset.split_days(None, None)[-1])
        from factorvae_tpu_torch.train.trainer import Trainer

        # the warm start the cycle will take, read before the cycle moves on
        warm0 = op._warm_params(Trainer(op._candidate_config("probe"), op.dataset,
                                        device="cpu").init_state())
        stop = threading.Event()
        outcomes = []

        def client():
            while not stop.is_set():
                outcomes.append(bool(daemon.handle({"model": "prod",
                                                    "day": probe_day}).get("ok")))

        thread = threading.Thread(target=client)
        thread.start()
        try:
            piece = continuation_panel(op.store.instruments, op.store.end_date, 2, C,
                                       seed=21)
            summary = op.run_cycle(piece)
        finally:
            stop.set()
            thread.join(timeout=30)
        assert outcomes and all(outcomes)
        assert summary["triggered"] and summary["promoted"] and all(summary["ran"].values())
        assert summary["refit_to_serve_s"] > 0
        done = CycleJournal(op.journal.path).cycles()[-1]
        assert done["done"] and set(done["stages"]) == set(STAGES)
        resp = daemon.handle({"model": "prod", "day": probe_day})
        assert resp["model"] == done["stages"]["promote"]["model"]
        type(self).warm0 = warm0

    def test_refit_bitwise_plain_warm_refit(self, rig):
        op, base = rig
        done = CycleJournal(op.journal.path).cycles()[-1]
        refit = done["stages"]["refit"]
        cand = op._candidate_config(done["id"])
        plain = dataclasses.replace(cand, train=dataclasses.replace(
            cand.train, save_dir=os.path.join(base, "plain")))
        state, info, _ = warm_refit(plain, op.dataset, warm_params=type(self).warm0)
        cycle = read_state_dict(refit["warm"]["path"])
        plain_sd = state.model.state_dict()
        assert cycle.keys() == plain_sd.keys()
        assert all(torch.equal(cycle[k], plain_sd[k]) for k in cycle)
        assert info["best_val"] == refit["warm"]["best_val"]

    def test_holdout_day_indices(self, rig):
        op, _ = rig
        all_days = op.dataset.split_days(None, None)
        assert holdout_day_indices(op.dataset, 2) == [int(all_days[-2]), int(all_days[-1])]

    def test_cycle_is_one_trace_tree(self, rig, tmp_path):
        """A cycle under an installed timeline is one trace, `wf-<cycle>`:
        every stage span and the daemon's spans the stages cause (the judge's
        requests, the promotion's admission) hang under the cycle root."""
        from factorvae_tpu_torch.obs.trace import _tree_index, assemble_traces, load_records
        from factorvae_tpu_torch.utils.logging import MetricsLogger, Timeline, install_timeline

        op, _ = rig
        jsonl = str(tmp_path / "RUN_wf.jsonl")
        logger = MetricsLogger(jsonl_path=jsonl, echo=False, run_name="wf_trace")
        prev = install_timeline(Timeline(logger))
        try:
            piece = continuation_panel(op.store.instruments, op.store.end_date, 2, C,
                                       seed=22)
            summary = op.run_cycle(piece)
        finally:
            install_timeline(prev)
            logger.finish()
        assert summary["triggered"] and summary["promoted"], summary
        tid = f"wf-{summary['cycle']}"
        traces = assemble_traces(load_records([jsonl]))
        assert tid in traces, sorted(traces)
        children, roots = _tree_index(traces[tid])
        assert [r["name"] for r in roots] == ["wf_cycle"]
        assert {f"wf_{s}" for s in STAGES} <= {r["name"] for r in children["cycle"]}
        names, stack = set(), [roots[0]]
        while stack:
            rec = stack.pop()
            names.add(rec.get("name"))
            stack.extend(children.get(rec.get("span"), ()))
        assert {"serve_request", "serve_admit"} <= names, sorted(names)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _wf_argv(run_dir: str, cycles: int = 1) -> list:
    return ["--run_dir", run_dir, "--cycles", str(cycles), "--force_refit", "--epochs", "1",
            "--init_days", "14", "--new_days", "2", "--stocks", "8", "--features", str(C),
            "--hidden", str(H), "--factors", str(K), "--portfolios", "6", "--seq_len", str(T),
            "--min_margin", "2", "--device", "cpu"]


def _wf_run(run_dir: str, fault=None, cycles: int = 1):
    env = {k: v for k, v in os.environ.items() if k != chaos.ENV_VAR}
    if fault is not None:
        env[chaos.ENV_VAR] = chaos.ChaosPlan([fault]).to_json()
    r = subprocess.run([sys.executable, "-m", "factorvae_tpu_torch.wf",
                        *_wf_argv(run_dir, cycles)], capture_output=True, text=True,
                       timeout=300, env=env, cwd=REPO)
    return (r.returncode, [json.loads(ln) for ln in r.stdout.splitlines()
                           if ln.startswith("{")], r.stderr)


class TestCommand:
    def test_dataset_pickle_bootstrap_and_refusals(self, tmp_path, capsys, monkeypatch):
        """--dataset seeds the store from a reference-schema pickle; one cycle
        prints its JSON summary; --compile_cache DIR is honoured (the next
        cycle runs with the kernels' build directory there); --device cuda
        without a card exits 2."""
        from factorvae_tpu_torch import _build

        monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
        panel = synthetic_panel_dense(16, 8, C, seed=4)
        pkl = str(tmp_path / "panel.pkl")
        panel_to_frame(panel).to_pickle(pkl)
        run = str(tmp_path / "run")
        assert wf_main([*_wf_argv(run), "--dataset", pkl]) == 0
        out, err = capsys.readouterr()
        summary = json.loads(out.splitlines()[-1])
        assert summary["cycle"] == "c00002" and summary["promoted"]
        assert "[wf] created store" in err
        store = PanelStore(os.path.join(run, "store"))
        assert store.num_days == 18 and store.slabs[0]["start"] == str(panel.dates[0])
        assert wf_main([*_wf_argv(run), "--compile_cache", str(tmp_path / "c")]) == 0
        summary = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert summary["cycle"] == "c00003" and summary["promoted"]
        assert _build.BUILD_DIR == tmp_path / "c" and (tmp_path / "c").is_dir()
        if not torch.cuda.is_available():
            argv = _wf_argv(run)
            argv[argv.index("--device") + 1] = "cuda"
            assert wf_main(argv) == 2
            assert "no CUDA device" in capsys.readouterr().err


class TestCycleResumeKills:
    """SIGKILL the command at a journaled boundary; the unfaulted re-run
    resumes the open cycle and ends with the store's slabs and the refit's
    weights byte-identical to a run that was never killed."""

    FAULTS = {
        "append": chaos.Fault("kill_mid_append", step=1),
        "refit": chaos.Fault("kill_mid_refit", step=1),
        "promote": chaos.Fault("kill_between_admit_and_drain", request=2),
    }

    @pytest.fixture(scope="class")
    def reference(self, tmp_path_factory):
        run = str(tmp_path_factory.mktemp("wf_ref"))
        rc, summaries, err = _wf_run(run, cycles=2)
        assert rc == 0, err[-2000:]
        return run, summaries

    @pytest.mark.parametrize("boundary", ["append", "refit", "promote"])
    def test_kill_and_resume_bitwise(self, boundary, reference, tmp_path):
        ref_run, ref_summaries = reference
        run = str(tmp_path / "run")
        rc, _, err = _wf_run(run)
        assert rc == 0, err[-2000:]
        rc_kill, _, err = _wf_run(run, fault=self.FAULTS[boundary])
        assert rc_kill == -signal.SIGKILL, (rc_kill, err[-2000:])
        rc, summaries, err = _wf_run(run)
        assert rc == 0, err[-2000:]
        summary = summaries[-1]
        assert summary["cycle"] == "c00003" and summary["promoted"]
        if boundary == "refit":
            assert summary["ran"]["append"] is False and summary["ran"]["judge"] is False
            assert summary["ran"]["refit"] is True
        if boundary == "promote":
            assert summary["ran"]["refit"] is False and summary["ran"]["promote"] is True
        assert summary["stages"]["judge"]["failures"] == 0
        ref_store = PanelStore(os.path.join(ref_run, "store"))
        store = PanelStore(os.path.join(run, "store"))
        assert [s["sha256"] for s in store.slabs] == [s["sha256"] for s in ref_store.slabs]
        assert store.verify() is None
        ref_path = ref_summaries[-1]["stages"]["refit"]["warm"]["path"]
        path = summary["stages"]["refit"]["warm"]["path"]
        with open(os.path.join(ref_path, "weights.pt"), "rb") as a, \
                open(os.path.join(path, "weights.pt"), "rb") as b:
            assert a.read() == b.read()
