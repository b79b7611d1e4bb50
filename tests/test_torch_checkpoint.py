"""The port's checkpoint integrity and async saves against the JAX package's
`train/checkpoint.py` semantics.

The cases mirror the JAX `tests/test_chaos.py` classes `TestCheckpointIntegrity`
and `TestKillMidSave`: manifests, quarantine with fallback, the explicit-step
error, retention's "missing", manifest-less steps restoring unverified,
re-saves, a damaged manifest, the weights directory's manifest, and a save
killed in a subprocess. The manifests are also checked with the JAX
package's own `step_manifest` / `verify_manifest`, and the chaos kinds and
byte operators against `factorvae_tpu.chaos`. Everything runs on the CPU at
a small size (C 6, T 5, H 8, K 4, M 8, 12 stocks, 30 days).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys

import pytest
import torch

from factorvae_tpu import chaos as jchaos
from factorvae_tpu.train.checkpoint import step_manifest as jstep_manifest
from factorvae_tpu.train.checkpoint import verify_manifest as jverify_manifest
from factorvae_tpu_torch import chaos
from factorvae_tpu_torch.chaos import ops as chaos_ops
from factorvae_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
from factorvae_tpu_torch.models.factorvae import load_model
from factorvae_tpu_torch.params import save_weights
from factorvae_tpu_torch.serve.registry import ModelRegistry, RegistryError
from factorvae_tpu_torch.train.checkpoint import (
    CheckpointIntegrityError,
    Checkpointer,
    load_params,
    save_params,
    verify_params_dir,
)
from factorvae_tpu_torch.train.trainer import Trainer, init_train_state
from factorvae_tpu_torch.utils.logging import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, T, H, K, M, STOCKS, DAYS = 6, 5, 8, 4, 8, 12, 30


def tiny_config(save_dir: str, epochs: int = 3, **train) -> Config:
    dates = [str(d) for d in synthetic_panel_dense(DAYS, STOCKS, C, seed=1).dates]
    return Config(
        model=ModelConfig(num_features=C, hidden_size=H, num_factors=K, num_portfolios=M,
                          seq_len=T),
        data=DataConfig(seq_len=T, start_time=dates[0], fit_end_time=dates[21],
                        val_start_time=dates[22], val_end_time=dates[-1]),
        train=TrainConfig(num_epochs=epochs, lr=1e-3, seed=5, days_per_step=2,
                          save_dir=save_dir, **train))


def tiny_dataset() -> PanelDataset:
    return PanelDataset(synthetic_panel_dense(DAYS, STOCKS, C, seed=1), seq_len=T,
                        device="cpu")


def tiny_state(seed: int = 0):
    cfg = tiny_config("unused")
    return init_train_state(cfg.model, dataclasses.replace(cfg.train, seed=seed), 10, "cpu")


def _meta(step: int, best_val: float = 0.0) -> dict:
    return {"epoch": step, "best_val": best_val, "config": {"v": 1}, "clean": True}


def _saved(tmp_path, steps: int = 3, **kw):
    ck = Checkpointer(str(tmp_path / "ck"), async_save=False, **kw)
    state = tiny_state()
    for s in range(steps):
        state.step = s
        ck.save(s, state, _meta(s))
    return state, ck


def _sd_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


class TestCheckpointIntegrity:
    def test_manifest_written_and_verifies(self, tmp_path):
        _, ck = _saved(tmp_path)
        for s in range(3):
            assert ck.verify_step(s) == (True, None)
            m = ck.manifest(s)
            assert set(m) == {"config_hash", "files", "nbytes", "created", "step"}
            assert m["files"] and m["nbytes"] > 0 and m["config_hash"] and m["step"] == s
        ck.close()

    def test_manifest_agrees_with_the_jax_manifest_functions(self, tmp_path):
        """The JAX `step_manifest` over a directory holding only the payload
        gives the port's files and bytes; the JAX `verify_manifest` passes the
        port's manifest and fails it after a byte flip."""
        _, ck = _saved(tmp_path, steps=1)
        only = tmp_path / "only"
        only.mkdir()
        shutil.copy(os.path.join(ck.directory, "epoch_0.pt"), only / "epoch_0.pt")
        want = jstep_manifest(str(only))
        got = ck.manifest(0)
        assert (got["files"], got["nbytes"]) == (want["files"], want["nbytes"])
        assert jverify_manifest(ck.directory, got) is None
        chaos_ops.corrupt_checkpoint_step(ck.directory, 0)
        assert jverify_manifest(ck.directory, got) == "sha256 mismatch: epoch_0.pt"

    def test_corrupt_step_quarantined_with_fallback(self, tmp_path):
        state, ck = _saved(tmp_path)
        chaos_ops.corrupt_checkpoint_step(str(tmp_path / "ck"), 2, rng_seed=0)
        meta = ck.restore(state)                      # implicit: falls back
        assert meta["epoch"] == 1 and state.step == 1
        assert ck.quarantined_steps() == [2]
        assert ck.all_steps() == [0, 1] and ck.latest_step() == 1
        ck.close()

    def test_explicit_restore_of_corrupt_step_raises(self, tmp_path):
        state, ck = _saved(tmp_path)
        chaos_ops.corrupt_checkpoint_step(str(tmp_path / "ck"), 1, rng_seed=0)
        with pytest.raises(CheckpointIntegrityError, match="quarantined"):
            ck.restore(state, step=1)
        ck.close()

    def test_premanifest_step_restores_unverified(self, tmp_path):
        state, ck = _saved(tmp_path)
        os.unlink(os.path.join(str(tmp_path / "ck"), "manifests", "2.json"))
        assert ck.verify_step(2) == (True, "unverified")
        assert ck.restore(state)["epoch"] == 2
        assert ck.verified_steps() == [0, 1, 2]
        ck.close()

    def test_all_steps_quarantined_is_loud(self, tmp_path):
        state, ck = _saved(tmp_path, steps=2)
        for s in (0, 1):
            chaos_ops.corrupt_checkpoint_step(str(tmp_path / "ck"), s, rng_seed=s)
        with pytest.raises(FileNotFoundError, match="quarantined"):
            ck.restore(state)
        ck.close()

    def test_verified_steps_quarantines_eagerly(self, tmp_path):
        _, ck = _saved(tmp_path)
        chaos_ops.corrupt_checkpoint_step(str(tmp_path / "ck"), 0, rng_seed=0)
        assert ck.verified_steps() == [1, 2]
        assert ck.quarantined_steps() == [0]
        ck.close()

    def test_retention_evicted_step_is_missing_not_corrupt(self, tmp_path):
        state, ck = _saved(tmp_path, steps=4, keep=2)
        assert ck.all_steps() == [2, 3]
        assert ck.verify_step(1) == (False, "missing")
        with pytest.raises(FileNotFoundError, match="evicted"):
            ck.restore(state, step=1)
        assert ck.quarantined_steps() == []
        assert ck.restore(state)["epoch"] == 3
        ck.close()

    @pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
    def test_resave_overwrites_existing_step(self, tmp_path, async_save):
        ck = Checkpointer(str(tmp_path / "ck"), async_save=async_save)
        state = tiny_state()
        state.step = 7
        ck.save(0, state, _meta(0, 0.5))
        state.step = 11
        ck.save(0, state, _meta(0, 0.25))
        meta = ck.restore(state, step=0)
        assert state.step == 11 and meta["best_val"] == 0.25
        assert ck.verify_step(0) == (True, None)
        ck.close()

    def test_resave_clears_quarantine_marker(self, tmp_path):
        state, ck = _saved(tmp_path)
        chaos_ops.corrupt_checkpoint_step(str(tmp_path / "ck"), 2, rng_seed=0)
        ck.restore(state)
        assert ck.quarantined_steps() == [2]
        ck.save(2, state, _meta(2))
        assert ck.quarantined_steps() == [] and ck.verify_step(2) == (True, None)
        assert ck.restore(state)["epoch"] == 2
        ck.close()

    def test_corrupt_manifest_fails_verification(self, tmp_path):
        state, ck = _saved(tmp_path)
        with open(os.path.join(str(tmp_path / "ck"), "manifests", "2.json"), "w") as fh:
            fh.write('{"files": {tor')
        ok, reason = ck.verify_step(2)
        assert not ok and "manifest unreadable" in reason
        assert ck.restore(state)["epoch"] == 1
        assert ck.quarantined_steps() == [2]
        ck.close()

    def test_a_payload_that_will_not_load_is_quarantined(self, tmp_path):
        """Damage the manifest cannot see (a step without one) fails at load:
        quarantined, and the latest restore falls back."""
        state, ck = _saved(tmp_path)
        os.unlink(os.path.join(str(tmp_path / "ck"), "manifests", "2.json"))
        with open(os.path.join(str(tmp_path / "ck"), "epoch_2.pt"), "r+b") as fh:
            fh.truncate(64)
        with pytest.raises(CheckpointIntegrityError, match="failed to load"):
            ck.restore(state, step=2)
        assert ck.quarantined_steps() == [2]
        assert ck.restore(state)["epoch"] == 1
        ck.close()

    def test_save_params_manifest_roundtrip(self, tmp_path):
        cfg = tiny_config(str(tmp_path))
        model = load_model(cfg, device="cpu")
        path = save_params(str(tmp_path), "weights", model, cfg)
        assert verify_params_dir(path) is None
        assert _sd_equal(load_params(path), model.state_dict())
        chaos_ops.corrupt_file(os.path.join(path, "weights.pt"), rng_seed=0)
        assert verify_params_dir(path) == "sha256 mismatch: weights.pt"
        with open(path + ".manifest.json", "w") as fh:
            fh.write('{"files": {tor')
        bad = verify_params_dir(path)
        assert bad is not None and "manifest unreadable" in bad
        os.unlink(path + ".manifest.json")
        assert verify_params_dir(path) is None           # pre-manifest: unverified


class TestAsyncSaves:
    def test_async_and_sync_write_the_same_bytes(self, tmp_path):
        """The same states saved both ways: byte-identical payloads, and
        manifests equal but for their creation time."""
        dirs = {}
        for mode in (False, True):
            ck = Checkpointer(str(tmp_path / f"ck_{mode}"), async_save=mode)
            state = tiny_state()
            for s in range(3):
                state.step = s
                with torch.no_grad():
                    state.model.feature_extractor.proj.weight.add_(0.5)
                ck.save(s, state, _meta(s))
            ck.close()
            dirs[mode] = ck
        sync, asyn = dirs[False], dirs[True]
        assert sync.all_steps() == asyn.all_steps() == [0, 1, 2]
        for s in range(3):
            with open(sync._path(s), "rb") as a, open(asyn._path(s), "rb") as b:
                assert a.read() == b.read()
            ma, mb = sync.manifest(s), asyn.manifest(s)
            ma.pop("created"), mb.pop("created")
            assert ma == mb
        assert len(asyn.save_seconds) == 3 and len(asyn.manifest_seconds) == 3

    def test_the_snapshot_is_taken_at_save(self, tmp_path):
        """An async save keeps the values of the call even when the caller
        updates the state while the write is queued."""
        ck = Checkpointer(str(tmp_path / "ck"), async_save=True)
        state = tiny_state()
        want = {k: v.clone() for k, v in state.model.state_dict().items()}
        ck.save(0, state, _meta(0))
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
        fresh = tiny_state(seed=1)
        ck.restore(fresh, step=0)
        assert _sd_equal(fresh.model.state_dict(), want)
        ck.close()

    def test_many_queued_saves_under_a_short_switch_interval(self, tmp_path):
        """Saves queued faster than the writer commits them, with the
        interpreter switching threads every microsecond: retention, the
        manifests and the overwrite of a queued step stay consistent."""
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            ck = Checkpointer(str(tmp_path / "ck"), keep=3, async_save=True)
            state = tiny_state()
            for s in list(range(12)) + [11]:          # the last step saved twice
                state.step = 100 + s
                ck.save(s, state, _meta(s))
            assert ck.all_steps() == [9, 10, 11]
            assert all(ck.verify_step(s) == (True, None) for s in (9, 10, 11))
            assert sorted(os.listdir(os.path.join(ck.directory, "manifests"))) == [
                "10.json", "11.json", "9.json"]
            assert ck.restore(state)["epoch"] == 11 and state.step == 111
            ck.close()
            assert ck._worker is None
        finally:
            sys.setswitchinterval(interval)

    def test_trainer_wires_async_checkpointing(self, tmp_path):
        """`train.async_checkpointing` picks the mode; the layout event says
        which; a fit leaves every step committed with its manifest, and both
        modes save the same states (their configs differ in the knob)."""
        payloads = {}
        for mode in (True, False):
            recs = []

            class Recorder(MetricsLogger):
                def log(self, event, _echo=None, **fields):
                    recs.append((event, fields))

            cfg = tiny_config(str(tmp_path / str(mode)), async_checkpointing=mode)
            tr = Trainer(cfg, tiny_dataset(), device="cpu", logger=Recorder(echo=False))
            layout = dict(recs)["execution_layout"]
            assert layout["checkpoint_saves"] == ("async" if mode else "synchronous")
            tr.fit()
            ck = tr.last_checkpointer
            assert ck.async_save is mode and ck.all_steps() == [0, 1, 2]
            assert all(ck.verify_step(s) == (True, None) for s in range(3))
            payloads[mode] = torch.load(ck._path(2), weights_only=True)
        a, b = payloads[True], payloads[False]
        assert _sd_equal(a["model"], b["model"]) and a["step"] == b["step"]
        assert a["scheduler"] == b["scheduler"] and torch.equal(a["generator"], b["generator"])
        for i, st in a["optimizer"]["state"].items():
            assert all(torch.equal(st[k], b["optimizer"]["state"][i][k]) for k in st)


KILL_CHILD = """
import json, sys
sys.path.insert(0, {repo!r})
from factorvae_tpu_torch.config import Config
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
from factorvae_tpu_torch.train.trainer import Trainer
cfg = Config.from_dict(json.loads({cfg!r}))
ds = PanelDataset(synthetic_panel_dense({days}, {stocks}, {c}, seed=1), seq_len={t},
                  device="cpu")
Trainer(cfg, ds, device="cpu").fit()
raise SystemExit(3)   # not reached: the chaos fault SIGKILLs inside save(2)
"""


class TestKillMidSave:
    @pytest.mark.parametrize("async_save", [True, False], ids=["async", "sync"])
    def test_killed_save_loses_one_step_and_resumes_bitwise(self, tmp_path, async_save):
        """A run SIGKILLed inside the save of epoch 2 leaves epochs 0 and 1
        committed and verified, and epoch 2 whole (unverified, no manifest)
        or absent; the resumed run equals a never-killed one bitwise."""
        save_dir = str(tmp_path / "killed")
        env = {**os.environ, chaos.ENV_VAR: chaos.ChaosPlan(
            [chaos.Fault("kill_mid_save", step=2)]).to_json()}
        cfg = tiny_config(save_dir, epochs=4, async_checkpointing=async_save)
        child = KILL_CHILD.format(repo=REPO, cfg=json.dumps(cfg.to_dict()), days=DAYS,
                                  stocks=STOCKS, c=C, t=T)
        r = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                           timeout=300, env=env, cwd=REPO)
        assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-2000:])

        ck = Checkpointer(os.path.join(save_dir, cfg.checkpoint_name() + "_ckpt"))
        steps = ck.all_steps()
        assert {0, 1} <= set(steps) <= {0, 1, 2}, steps
        assert ck.verify_step(1) == (True, None)
        if 2 in steps:
            assert ck.verify_step(2) == (True, "unverified")
        if not async_save:
            assert steps == [0, 1, 2]          # the sync commit precedes the kill
        resumed, res_out = Trainer(cfg, tiny_dataset(), device="cpu").fit(resume=True)
        assert res_out["history"][0]["epoch"] == steps[-1] + 1
        ref_cfg = tiny_config(str(tmp_path / "ref"), epochs=4)
        ref, ref_out = Trainer(ref_cfg, tiny_dataset(), device="cpu").fit()
        assert _sd_equal(resumed.model.state_dict(), ref.model.state_dict())
        assert resumed.step == ref.step and res_out["best_val"] == ref_out["best_val"]


class TestChaosKinds:
    def test_kinds_equal_the_jax_tuple(self):
        assert chaos.KINDS == jchaos.KINDS
        for kind in ("kill_mid_save", "corrupt_checkpoint", "corrupt_artifact",
                     "torn_jsonl", "kill_mid_refit"):
            assert chaos.Fault(kind).kind == kind

    def test_an_unknown_kind_is_refused_as_jax_refuses_it(self):
        with pytest.raises(ValueError, match="choose from") as got:
            chaos.Fault("kill_everything")
        with pytest.raises(ValueError, match="choose from") as want:
            jchaos.Fault("kill_everything")
        assert str(got.value) == str(want.value)

    def test_byte_operators_equal_the_jax_ones(self, tmp_path):
        """`corrupt_checkpoint_step` flips the same offsets of the payload
        as the JAX operator flips in its largest payload file, and
        `tear_jsonl` cuts a stream at the same byte."""
        _, ck = _saved(tmp_path, steps=1)
        jdir = tmp_path / "jax_ck" / "0"
        jdir.mkdir(parents=True)
        shutil.copy(ck._path(0), jdir / "payload")
        chaos_ops.corrupt_checkpoint_step(ck.directory, 0, rng_seed=3)
        jchaos.ops.corrupt_checkpoint_step(str(tmp_path / "jax_ck"), 0, rng_seed=3)
        with open(ck._path(0), "rb") as a, open(jdir / "payload", "rb") as b:
            assert a.read() == b.read()
        lines = "".join(json.dumps({"i": i, "pad": "x" * i}) + "\n" for i in range(20))
        for name in ("port.jsonl", "jax.jsonl"):
            (tmp_path / name).write_text(lines)
        n = chaos_ops.tear_jsonl(str(tmp_path / "port.jsonl"), rng_seed=4)
        assert n == jchaos.ops.tear_jsonl(str(tmp_path / "jax.jsonl"), rng_seed=4)
        assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
        with pytest.raises(FileNotFoundError, match="committed"):
            chaos_ops.corrupt_checkpoint_step(ck.directory, 9)


class TestRegistryRefusesCorruptWeights:
    def test_corrupt_artifact_is_refused_with_a_quarantine_mark(self, tmp_path):
        from factorvae_tpu_torch.utils.logging import Timeline, install_timeline

        cfg = tiny_config(str(tmp_path))
        path = save_weights(load_model(cfg, device="cpu"), cfg, str(tmp_path / "w"))
        reg = ModelRegistry(device="cpu")
        key = reg.register_checkpoint(path)
        reg.retire(key)
        chaos_ops.corrupt_file(os.path.join(path, "weights.pt"), rng_seed=1)
        recs = []

        class Recorder(MetricsLogger):
            def log(self, event, _echo=None, **fields):
                recs.append(dict(fields, event=event))

        prev = install_timeline(Timeline(Recorder(echo=False)))
        try:
            with pytest.raises(RegistryError, match="failed manifest verification"):
                ModelRegistry(device="cpu").register_checkpoint(path)
        finally:
            install_timeline(prev)
        marks = [r for r in recs if r.get("name") == "serve_quarantine"]
        assert marks and marks[0]["reason"] == "sha256 mismatch: weights.pt"

    def test_a_cold_start_of_corrupted_weights_stays_refused(self, tmp_path):
        """An evicted entry whose weights were damaged on disk meanwhile: the
        cold start refuses them, and keeps refusing."""
        cfg = tiny_config(str(tmp_path))
        paths = []
        for seed in (1, 2):
            c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=seed))
            paths.append(save_weights(load_model(c, device="cpu"), c,
                                      str(tmp_path / f"w{seed}")))
        reg = ModelRegistry(device="cpu", budget_bytes=1)
        first = reg.register_checkpoint(paths[0])
        reg.register_checkpoint(paths[1])              # evicts the first
        chaos_ops.corrupt_file(os.path.join(paths[0], "weights.pt"), rng_seed=2)
        for _ in range(2):
            with pytest.raises(RegistryError, match="failed manifest verification"):
                reg.get(first)

    def test_a_premanifest_directory_admits_unverified(self, tmp_path):
        cfg = tiny_config(str(tmp_path))
        path = save_weights(load_model(cfg, device="cpu"), cfg, str(tmp_path / "w"))
        os.unlink(path + ".manifest.json")
        assert ModelRegistry(device="cpu").register_checkpoint(path)
