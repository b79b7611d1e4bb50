"""The training-health probes (`obs/probes.py`) of the port's trainers
against the JAX trainers' with `train.obs_probes`, and the probes' own
contracts within the port.

Everything runs on the CPU (the port's kernels run their plain versions,
the JAX ones Pallas in interpret mode), deterministic runs from the same
Flax weights (dropout 0, the NLL loss). Tolerances of the epoch records'
probe values against JAX (`PROBE_RTOL`): the losses' rtol 2e-5 of
`test_torch_train.py` for the parameter norm and the factor moments; the
gradient norms at rtol 1e-4, the one-step gradient tolerance of
`TestStepGradients`; the update norm at rtol 5e-3. Two things widen it:
the port takes it as the norm of (p + u) - p, which differs from optax's u
by up to half an ulp of p per element (with lr 1e-3 and |p| ~ 1, ~5e-5 of
|u|); and the parameters whose gradient is zero in exact arithmetic
(ROADMAP Queue 3: the portfolio bias, key-bias rows) get rounding noise in
both packages, which Adam turns into steps of up to lr whose size differs
between them (read up to 1.5e-3 on the fleet). The non-finite counts
exactly.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from factorvae_tpu import chaos as jchaos
from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.train.fleet import FleetTrainer as JFleetTrainer
from factorvae_tpu.train.fleet import unstack_state as junstack
from factorvae_tpu.train.trainer import Trainer as JTrainer
from factorvae_tpu.utils.logging import MetricsLogger as JMetricsLogger
from factorvae_tpu_torch import chaos
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.obs import probes
from factorvae_tpu_torch.obs.probes import EVAL_PROBE_KEYS, TRAIN_PROBE_KEYS
from factorvae_tpu_torch.params import flax_to_torch
from factorvae_tpu_torch.train import loop
from factorvae_tpu_torch.train.fleet import FleetTrainer
from factorvae_tpu_torch.train.trainer import Trainer
from factorvae_tpu_torch.utils.logging import MetricsLogger

C, T, H, K, M = 6, 5, 8, 4, 10
SEEDS = (3, 4)

PROBE_RTOL = {
    "grad_norm_max": 1e-4, "grad_norm_mean": 1e-4, "update_norm_mean": 5e-3,
    "param_norm_last": 2e-5, "factor_mu_spread": 2e-5, "factor_sigma_mean": 2e-5,
    "nonfinite_grads": 0.0, "nonfinite_loss": 0.0,
}


@pytest.fixture(scope="module")
def panels():
    jp = synthetic_panel(num_days=36, num_instruments=11, num_features=C,
                         missing_prob=0.2, seed=4)
    tp = Panel(values=jp.values, valid=jp.valid,
               dates=jp.dates.values.astype("datetime64[D]"),
               instruments=np.asarray(jp.instruments))
    return jp, tp


def _jconfig(tp, tmp_path, days_per_step=1, epochs=2, seed=3, train=None,
             **model) -> jconfig.Config:
    d = [str(x) for x in tp.dates]
    kw = dict(dropout_rate=0.0, recon_loss="nll")
    kw.update(model)
    tkw = dict(num_epochs=epochs, lr=1e-3, seed=seed, days_per_step=days_per_step,
               checkpoint_every=0, recover_after=0, save_dir=str(tmp_path / "jax"),
               obs_probes=True)
    tkw.update(train or {})
    return jconfig.Config(
        model=jconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                  num_portfolios=M, seq_len=T, **kw),
        data=jconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[24],
                                val_start_time=d[25], val_end_time=d[35]),
        train=jconfig.TrainConfig(**tkw))


def _port(jcfg: jconfig.Config, tmp_path, **train) -> tconfig.Config:
    cfg = tconfig.Config.from_dict(jcfg.to_dict())
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, save_dir=str(tmp_path / "port"), **train))


def _assert_probes(got: dict, want: dict, keys=TRAIN_PROBE_KEYS, prefix=""):
    for k in keys:
        g, w = np.asarray(got[prefix + k], np.float64), np.asarray(want[prefix + k], np.float64)
        np.testing.assert_allclose(g, w, rtol=PROBE_RTOL[k], atol=0, err_msg=prefix + k)


def _fit_both(jp, tp, jcfg, tmp_path, **port_train):
    jtr = JTrainer(jcfg, JPanelDataset(jp, seq_len=T))
    jstate = jtr.init_state()
    weights = flax_to_torch(jstate.params)
    _, jout = jtr.fit(state=jstate)
    tr = Trainer(_port(jcfg, tmp_path, **port_train),
                 PanelDataset(tp, seq_len=T, device="cpu"), device="cpu")
    state = tr.init_state()
    state.model.load_state_dict(weights)
    state, out = tr.fit(state=state)
    return jout, out, state, tr


class TestTrainerProbes:
    @pytest.mark.parametrize("days_per_step,layers", [(1, 1), (4, 1), (1, 2)],
                             ids=["dps1", "dps4", "stacked_L2"])
    def test_probes_track_the_jax_trainer(self, panels, tmp_path, days_per_step, layers):
        """Two epochs from the same weights: every probe of the epoch
        records, train and validation, within PROBE_RTOL of JAX's."""
        jp, tp = panels
        jcfg = _jconfig(tp, tmp_path, days_per_step=days_per_step, gru_layers=layers)
        jout, out, _, _ = _fit_both(jp, tp, jcfg, tmp_path)
        for got, want in zip(out["history"], jout["history"]):
            _assert_probes(got, want)
            _assert_probes(got, want, EVAL_PROBE_KEYS, prefix="val_")
            assert got["nonfinite_grads"] == got["nonfinite_loss"] == 0
            assert got["grad_norm_max"] >= got["grad_norm_mean"] > 0

    def test_a_poisoned_epoch_reads_nan_update_norm_as_jax_does(self, panels, tmp_path):
        """A `nan_grads` epoch under the finite guard: every step skipped,
        the update norm NaN (optax's un-gated update), the parameter norm
        that of the kept weights, the non-finite gradient count equal to
        JAX's (every element of every step)."""
        jp, tp = panels
        jcfg = _jconfig(tp, tmp_path, days_per_step=4)
        with jchaos.active(jchaos.ChaosPlan([jchaos.Fault("nan_grads", epoch=1)])):
            jtr = JTrainer(jcfg, JPanelDataset(jp, seq_len=T))
            jstate = jtr.init_state()
            weights = flax_to_torch(jstate.params)
            _, jout = jtr.fit(state=jstate)
        tr = Trainer(_port(jcfg, tmp_path), PanelDataset(tp, seq_len=T, device="cpu"),
                     device="cpu")
        state = tr.init_state()
        state.model.load_state_dict(weights)
        with chaos.active(chaos.ChaosPlan([chaos.Fault("nan_grads", epoch=1)])):
            _, out = tr.fit(state=state)
        got, want = out["history"][1], jout["history"][1]
        assert np.isnan(got["update_norm_mean"]) and np.isnan(want["update_norm_mean"])
        assert np.isnan(got["grad_norm_mean"]) and np.isnan(want["grad_norm_max"])
        n_params = sum(p.numel() for p in state.model.parameters())
        assert got["nonfinite_grads"] == want["nonfinite_grads"] == n_params * tr.steps_per_epoch
        assert got["skipped_steps"] == tr.steps_per_epoch
        np.testing.assert_allclose(got["param_norm_last"], want["param_norm_last"], rtol=2e-5)
        # the kept weights: epoch 1's parameter norm is epoch 0's
        assert got["param_norm_last"] == out["history"][0]["param_norm_last"]
        _assert_probes(out["history"][0], jout["history"][0])

    def test_a_skipped_step_reads_nan_update_norm(self, panels, tmp_path):
        _, tp = panels
        tr = Trainer(_port(_jconfig(tp, tmp_path), tmp_path),
                     PanelDataset(tp, seq_len=T, device="cpu"), device="cpu")
        state = tr.init_state()
        order = tr._order(tr.train_days, True, 0)
        clean = loop.train_step(state, tr.ds, order[0], guard=True, probes=True)
        assert float(clean["update_norm"]) > 0 and float(clean["skipped"]) == 0
        kept = [p.detach().clone() for p in state.model.parameters()]
        hook = state.model.factor_predictor.query.register_hook(lambda g: g * float("nan"))
        aux = loop.train_step(state, tr.ds, order[1], guard=True, probes=True)
        hook.remove()
        assert float(aux["skipped"]) == 1.0 and torch.isnan(aux["update_norm"])
        assert float(aux["nonfinite_grads"]) == state.model.factor_predictor.query.numel()
        assert float(aux["param_norm"]) == float(torch.linalg.vector_norm(
            probes.flatten(kept)))

    def test_probes_leave_the_run_bitwise_as_it_was(self, panels, tmp_path):
        """Probes on against off, with dropout and the sampled loss: the same
        weights, Adam state, losses and generator state, bit for bit."""
        _, tp = panels
        cfg = _port(_jconfig(tp, tmp_path, dropout_rate=0.1, recon_loss="mse"), tmp_path)
        runs = []
        for on in (False, True):
            c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, obs_probes=on))
            tr = Trainer(c, PanelDataset(tp, seq_len=T, device="cpu"), device="cpu")
            state, out = tr.fit()
            runs.append((state, out))
        (off, off_out), (on, on_out) = runs
        sd_off, sd_on = off.model.state_dict(), on.model.state_dict()
        assert all(torch.equal(sd_off[k], sd_on[k]) for k in sd_off)
        for a, b in zip(off.optimizer.state_dict()["state"].values(),
                        on.optimizer.state_dict()["state"].values()):
            assert all(torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
        assert torch.equal(off.generator.get_state(), on.generator.get_state())
        for a, b in zip(off_out["history"], on_out["history"]):
            for key in ("train_loss", "val_loss", "train_recon", "train_kl", "lr", "step"):
                assert a[key] == b[key], key
            assert set(TRAIN_PROBE_KEYS) <= set(b) and not set(TRAIN_PROBE_KEYS) & set(a)

    def test_probes_add_no_host_read_per_step(self, panels, tmp_path, monkeypatch):
        """The guard's one read per step stays the only one: an epoch with
        probes makes exactly the host reads of an epoch without them."""
        _, tp = panels
        cfg = _port(_jconfig(tp, tmp_path, epochs=1), tmp_path)
        reads = {"n": 0}
        for name in ("item", "tolist", "__bool__", "__float__", "numpy", "cpu"):
            orig = getattr(torch.Tensor, name)

            def counted(self, *a, _orig=orig, **kw):
                reads["n"] += 1
                return _orig(self, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, counted)
        counts = []
        for on in (False, True):
            c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, obs_probes=on))
            tr = Trainer(c, PanelDataset(tp, seq_len=T, device="cpu"), device="cpu")
            state = tr.init_state()
            reads["n"] = 0
            loop.train_epoch(state, tr._chunks(tr.train_days, True, 0), guard=True,
                             probes=on)
            counts.append(reads["n"])
        # (the CPU's plain kernel versions read some values of their own)
        assert counts[0] == counts[1] > tr.steps_per_epoch


class TestRecovery:
    @pytest.mark.parametrize("obs", [False, True], ids=["probes_off", "probes_on"])
    def test_nonfinite_grads_drive_the_rollback_as_in_jax(self, panels, tmp_path, obs):
        """One step per epoch and no finite guard: a poisoned epoch's loss is
        finite (taken before the update) and nothing is skipped, so only the
        probes' non-finite gradient count marks it bad. With probes the
        rollback fires at the poisoned epoch, without them one epoch later
        (the NaN weights' loss); the recovery trail equals JAX's."""
        jp, tp = panels
        jcfg = _jconfig(tp, tmp_path, days_per_step=32, epochs=4, train=dict(
            obs_probes=obs, finite_guard=False, recover_after=1, checkpoint_every=1))
        faults = [1]
        with jchaos.active(jchaos.ChaosPlan([jchaos.Fault("nan_grads", epoch=e)
                                             for e in faults])):
            jlogger = JMetricsLogger(jsonl_path=str(tmp_path / "j.jsonl"), echo=False)
            JTrainer(jcfg, JPanelDataset(jp, seq_len=T), logger=jlogger).fit()
            jlogger.finish()
        logger = MetricsLogger(jsonl_path=str(tmp_path / "t.jsonl"), echo=False)
        tr = Trainer(_port(jcfg, tmp_path), PanelDataset(tp, seq_len=T, device="cpu"),
                     device="cpu", logger=logger)
        assert tr.steps_per_epoch == 1
        with chaos.active(chaos.ChaosPlan([chaos.Fault("nan_grads", epoch=e)
                                           for e in faults])):
            tr.fit()
        logger.finish()

        def trail(path):
            return [(r["kind"], r["epoch"], r.get("restored_step"))
                    for r in map(json.loads, open(path)) if r["event"] == "recovery"]

        got, want = trail(tmp_path / "t.jsonl"), trail(tmp_path / "j.jsonl")
        assert got == want
        # without probes epoch 1 was saved as clean, so the rollback restores it
        assert got[0] == (("rollback", 1, 0) if obs else ("rollback", 2, 1))


def _fleet_cfg(tp, tmp_path, **train):
    jcfg = _jconfig(tp, tmp_path, train=train)
    return jcfg


class TestFleetProbes:
    def test_fleet_probes_track_the_jax_fleet(self, panels, tmp_path, monkeypatch):
        """S = 2 from the JAX fleet's weights: per-lane probe lists of the
        `fleet_epoch` records within PROBE_RTOL of the JAX fleet's."""
        jp, tp = panels
        jcfg = _jconfig(tp, tmp_path)
        jds = JPanelDataset(jp, seq_len=T)
        jft = JFleetTrainer(jcfg, jds, seeds=SEEDS, logger=JMetricsLogger(echo=False))
        weights = {s: flax_to_torch(junstack(jft.init_fleet_state().params, i))
                   for i, s in enumerate(SEEDS)}
        _, jout = JFleetTrainer(jcfg, jds, seeds=SEEDS, logger=JMetricsLogger(echo=False)).fit()
        init = FleetTrainer.init_lane_state

        def patched(self, i):
            st = init(self, i)
            st.model.load_state_dict(weights[self.seeds[i]])
            return st

        monkeypatch.setattr(FleetTrainer, "init_lane_state", patched)
        ft = FleetTrainer(_port(jcfg, tmp_path), PanelDataset(tp, seq_len=T, device="cpu"),
                          seeds=SEEDS, device="cpu")
        _, out = ft.fit()
        for got, want in zip(out["history"], jout["history"]):
            assert all(len(got[k]) == len(SEEDS) for k in TRAIN_PROBE_KEYS)
            _assert_probes(got, want)
            _assert_probes(got, want, EVAL_PROBE_KEYS, prefix="val_")

    def test_lane_probes_equal_their_solo_runs(self, panels, tmp_path):
        """Within the port: each lane's probes against its seed's solo
        `Trainer` at the fleet's tolerance (`test_torch_fleet.py`: rtol
        2e-5 for losses), and probes on leave the fleet bitwise."""
        _, tp = panels
        cfg = _port(_jconfig(tp, tmp_path), tmp_path)
        ds = PanelDataset(tp, seq_len=T, device="cpu")
        state, out = FleetTrainer(cfg, ds, seeds=SEEDS, device="cpu").fit()
        for i, seed in enumerate(SEEDS):
            solo_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=seed))
            _, solo = Trainer(solo_cfg, ds, device="cpu").fit()
            for got, want in zip(out["history"], solo["history"]):
                for k in TRAIN_PROBE_KEYS:
                    np.testing.assert_allclose(got[k][i], want[k],
                                               rtol=max(PROBE_RTOL[k], 1e-4), err_msg=k)
        off = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, obs_probes=False))
        state_off, out_off = FleetTrainer(off, ds, seeds=SEEDS, device="cpu").fit()
        assert all(torch.equal(state.params[n], state_off.params[n]) for n in state.params)
        assert [r["train_loss"] for r in out["history"]] == [
            r["train_loss"] for r in out_off["history"]]

    def test_a_poisoned_lane_counts_alone(self, panels, tmp_path):
        _, tp = panels
        cfg = _port(_jconfig(tp, tmp_path, epochs=1), tmp_path)
        ds = PanelDataset(tp, seq_len=T, device="cpu")
        with chaos.active(chaos.ChaosPlan([chaos.Fault("nan_grads", epoch=0, lane=1)])):
            _, out = FleetTrainer(cfg, ds, seeds=SEEDS, device="cpu").fit()
        rec = out["history"][0]
        assert rec["nonfinite_grads"][0] == 0 and rec["nonfinite_grads"][1] > 0
        assert np.isfinite(rec["update_norm_mean"][0]) and np.isnan(rec["update_norm_mean"][1])


class TestProbeFunctions:
    def test_global_norm_and_counts_per_lane(self):
        rng = np.random.default_rng(0)
        a, b = rng.normal(size=(3, 4, 5)), rng.normal(size=(3, 7))
        b[1, 2] = np.nan
        ta, tb = torch.tensor(a, dtype=torch.float32), torch.tensor(b, dtype=torch.float32)
        lanes = probes.grad_probes([ta, tb], lanes=3)
        for i in range(3):
            want = np.sqrt(np.sum(a[i] ** 2) + np.sum(b[i] ** 2))
            if i == 1:
                assert torch.isnan(lanes["grad_norm"][i])
            else:
                np.testing.assert_allclose(float(lanes["grad_norm"][i]), want, rtol=1e-6)
        assert lanes["nonfinite_grads"].tolist() == [0.0, 1.0, 0.0]
        assert lanes["probe_steps"].tolist() == [1.0, 1.0, 1.0]
        assert float(probes.grad_probes([ta, tb])["nonfinite_grads"]) == 1.0
        upd = probes.update_probes(probes.flatten([ta], 3), [ta + 1.0],
                                   torch.tensor([True, False, True]), 3)
        one = probes.update_probes(probes.flatten([ta[0], tb[0]]), [ta[0] + 1.0, tb[0]])
        np.testing.assert_allclose(float(one["update_norm"]), np.sqrt(20.0), rtol=1e-6)
        np.testing.assert_allclose(float(one["param_norm"]),
                                   np.sqrt(np.sum((a[0] + 1) ** 2) + np.sum(b[0] ** 2)),
                                   rtol=1e-6)
        np.testing.assert_allclose(upd["update_norm"][[0, 2]].numpy(), np.sqrt(20.0),
                                   rtol=1e-6)
        assert torch.isnan(upd["update_norm"][1])

    def test_std_is_ddof_zero_and_day_weighted(self):
        class Out:
            loss = torch.tensor([1.0, float("nan"), 2.0])
            factor_mu = torch.tensor([[1.0, 3.0], [0.0, 0.0], [2.0, 2.0]])
            factor_sigma = torch.tensor([[1.0, 3.0], [5.0, 5.0], [0.5, 0.5]])

        p = probes.loss_probes(Out, torch.tensor([1.0, 1.0, 0.0]))
        assert float(p["nf_loss"]) == 1.0
        assert float(p["mu_spread_sum"]) == 1.0          # std([1, 3]) with ddof 0
        assert float(p["sigma_mean_sum"]) == 2.0 + 5.0
