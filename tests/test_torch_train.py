"""The port's training slice against the JAX package: the epoch order, the
schedule, one step's gradients, and whole runs of the JAX `Trainer` and the
port's `Trainer` from the same weights; then the port's own finite guard and
resume.

Everything runs on the CPU, where the port's kernels run their plain
versions. Runs that compare the two packages are deterministic: dropout 0
and the NLL reconstruction, so no noise of either framework enters.
Tolerances: one step's gradients at rtol=1e-4, atol=1e-7 (f32 sums over
days, stocks and steps in another order than XLA's); per-epoch losses at
rtol=2e-5 (three epochs of Adam, whose update divides by sqrt(v) and so
magnifies rounding in small gradients; read at most 2.2e-6, so the starting
limit of 1e-4 was tightened).
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.models.factorvae import day_forward
from factorvae_tpu.train.loop import make_step_fns
from factorvae_tpu.train.state import learning_rate_at as jlearning_rate_at
from factorvae_tpu.train.trainer import Trainer as JTrainer
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.params import flax_to_torch
from factorvae_tpu_torch.train.loop import train_step, weighted_day_loss
from factorvae_tpu_torch.train.state import learning_rate_at, make_optimizer
from factorvae_tpu_torch.train.trainer import Trainer

C, T, H, K, M = 6, 5, 8, 4, 10


@pytest.fixture(scope="module")
def panels():
    jp = synthetic_panel(num_days=36, num_instruments=11, num_features=C,
                         missing_prob=0.2, seed=4)
    tp = Panel(values=jp.values, valid=jp.valid,
               dates=jp.dates.values.astype("datetime64[D]"),
               instruments=np.asarray(jp.instruments))
    return jp, tp


def _jconfig(tp, tmp_path, days_per_step=1, epochs=3, **model) -> jconfig.Config:
    d = [str(x) for x in tp.dates]
    kw = dict(dropout_rate=0.0, recon_loss="nll")
    kw.update(model)
    return jconfig.Config(
        model=jconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                  num_portfolios=M, seq_len=T, **kw),
        data=jconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[24],
                                val_start_time=d[25], val_end_time=d[35]),
        train=jconfig.TrainConfig(num_epochs=epochs, lr=1e-3, seed=3,
                                  days_per_step=days_per_step, checkpoint_every=0,
                                  recover_after=0, save_dir=str(tmp_path / "jax")))


def _port(jcfg: jconfig.Config, tmp_path, **train) -> tconfig.Config:
    cfg = tconfig.Config.from_dict(jcfg.to_dict())
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, save_dir=str(tmp_path / "port"), **train))


class TestEpochOrder:
    @pytest.mark.parametrize("pad_to", [0, 1, 4, 7])
    def test_equals_jax_bitwise(self, panels, pad_to):
        jp, tp = panels
        jds, tds = JPanelDataset(jp, seq_len=T), PanelDataset(tp, seq_len=T, device="cpu")
        days = tds.split_days(None, None)
        for shuffle, epoch in ((False, 0), (True, 0), (True, 5)):
            got = tds.epoch_order(days, shuffle=shuffle, seed=3, epoch=epoch, pad_to=pad_to)
            want = jds.epoch_order(days, shuffle=shuffle, seed=3, epoch=epoch, pad_to=pad_to)
            assert got.dtype == want.dtype and np.array_equal(got, want)


class TestSchedule:
    def test_lambda_lr_follows_optax_cosine(self):
        cfg = tconfig.TrainConfig(lr=3e-4)
        total = 17
        opt, sched = make_optimizer([torch.nn.Parameter(torch.zeros(2))], cfg, total)
        want = optax.cosine_decay_schedule(init_value=3e-4, decay_steps=total, alpha=0.0)
        jcfg = jconfig.TrainConfig(lr=3e-4)
        for step in range(total + 3):
            lr = sched.get_last_lr()[0]
            np.testing.assert_allclose(lr, float(want(step)), rtol=1e-6)
            assert lr == learning_rate_at(cfg, total, step)
            np.testing.assert_allclose(lr, jlearning_rate_at(jcfg, total, step), rtol=1e-12)
            opt.step()
            sched.step()
        assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
        flat = tconfig.TrainConfig(lr=3e-4, cosine_schedule=False)
        _, sched = make_optimizer([torch.nn.Parameter(torch.zeros(2))], flat, total)
        assert sched.get_last_lr() == [3e-4]


class TestStepGradients:
    @pytest.mark.parametrize("days", [[3, 7, -1, 20], [12]], ids=["padded_batch", "one_day"])
    def test_match_jax_value_and_grad(self, panels, tmp_path, days):
        jp, tp = panels
        jcfg = _jconfig(tp, tmp_path)
        jds = JPanelDataset(jp, seq_len=T)
        model_train = day_forward(jcfg.model, train=True)
        params = JTrainer(jcfg, jds).init_state().params
        fns = make_step_fns(model_train, day_forward(jcfg.model, train=False),
                            optax.adam(1e-3), T)
        jdays = jnp.asarray(days, jnp.int32)
        panel = (jds.values, jds.last_valid, jds.next_valid)
        key = jax.random.PRNGKey(0)

        def loss_fn(p):      # the JAX loop's weighted_day_loss, its loss term
            x, y, mask = fns.batch_for(jdays, panel)
            day_w = (jdays >= 0).astype(jnp.float32)
            out = model_train.apply(p, x, y, mask, rngs={"sample": key, "dropout": key})
            return jnp.sum(out.loss * day_w) / jnp.maximum(jnp.sum(day_w), 1.0)

        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        trainer = Trainer(_port(jcfg, tmp_path), PanelDataset(tp, seq_len=T, device="cpu"),
                          device="cpu")
        state = trainer.init_state()
        state.model.load_state_dict(flax_to_torch(params))
        loss, aux = weighted_day_loss(state.model, trainer.ds, torch.tensor(days), train=True,
                                      generator=state.generator)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        assert float(aux["days"]) == sum(d >= 0 for d in days)
        want = flax_to_torch(want_grads)
        for name, p in state.model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=name)


class TestTrainerParity:
    @pytest.mark.parametrize("days_per_step", [1, 4])
    def test_port_trainer_tracks_the_jax_trainer(self, panels, tmp_path, days_per_step):
        """Three epochs from the same weights: per-epoch train and val losses
        within rtol 2e-5; the same step count, days and schedule."""
        jp, tp = panels
        jcfg = _jconfig(tp, tmp_path, days_per_step=days_per_step)
        jtr = JTrainer(jcfg, JPanelDataset(jp, seq_len=T))
        jstate = jtr.init_state()
        weights = flax_to_torch(jstate.params)       # before fit donates the state
        _, jout = jtr.fit(state=jstate)

        tr = Trainer(_port(jcfg, tmp_path), PanelDataset(tp, seq_len=T, device="cpu"),
                     device="cpu")
        assert (tr.steps_per_epoch, tr.total_steps) == (jtr.steps_per_epoch, jtr.total_steps)
        state = tr.init_state()
        state.model.load_state_dict(weights)
        state, out = tr.fit(state=state)
        got = [(r["train_loss"], r["val_loss"]) for r in out["history"]]
        want = [(r["train_loss"], r["val_loss"]) for r in jout["history"]]
        np.testing.assert_allclose(got, want, rtol=2e-5)
        assert [r["step"] for r in out["history"]] == [r["step"] for r in jout["history"]]
        assert all(r["skipped_steps"] == 0 for r in out["history"])
        np.testing.assert_allclose(out["best_val"], jout["best_val"], rtol=2e-5)


class TestStackedTrainer:
    def test_an_l2_epoch_tracks_the_jax_trainer(self, panels, tmp_path):
        """One epoch at gru_layers = 2 from the same weights: train and val
        losses within the trainer's rtol 2e-5, the same step count."""
        jp, tp = panels
        jcfg = _jconfig(tp, tmp_path, epochs=1, gru_layers=2)
        jtr = JTrainer(jcfg, JPanelDataset(jp, seq_len=T))
        jstate = jtr.init_state()
        weights = flax_to_torch(jstate.params)
        _, jout = jtr.fit(state=jstate)
        tr = Trainer(_port(jcfg, tmp_path), PanelDataset(tp, seq_len=T, device="cpu"),
                     device="cpu")
        state = tr.init_state()
        state.model.load_state_dict(weights)
        state, out = tr.fit(state=state)
        got = [(r["train_loss"], r["val_loss"]) for r in out["history"]]
        want = [(r["train_loss"], r["val_loss"]) for r in jout["history"]]
        np.testing.assert_allclose(got, want, rtol=2e-5)
        assert [r["step"] for r in out["history"]] == [r["step"] for r in jout["history"]]


def _small_trainer(tp, tmp_path, name="run", **train):
    d = [str(x) for x in tp.dates]
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                  num_portfolios=M, seq_len=T),
        data=tconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[24],
                                val_start_time=d[25], val_end_time=d[35]),
        train=tconfig.TrainConfig(num_epochs=3, lr=1e-3, seed=9, days_per_step=2,
                                  save_dir=str(tmp_path / name), **train))
    return Trainer(cfg, PanelDataset(tp, seq_len=T, device="cpu"), device="cpu")


def _snapshot(state):
    return (copy.deepcopy(state.model.state_dict()),
            copy.deepcopy(state.optimizer.state_dict()),
            copy.deepcopy(state.scheduler.state_dict()), state.scheduler.get_last_lr())


def _assert_same(a, b):
    params_a, opt_a, sched_a, lr_a = a
    params_b, opt_b, sched_b, lr_b = b
    assert all(torch.equal(params_a[k], params_b[k]) for k in params_a)
    assert opt_a["state"].keys() == opt_b["state"].keys()
    for i, st in opt_a["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], opt_b["state"][i][key]), key
    assert sched_a == sched_b and lr_a == lr_b


class TestFiniteGuard:
    def test_a_poisoned_gradient_changes_nothing_and_is_counted(self, panels, tmp_path):
        _, tp = panels
        tr = _small_trainer(tp, tmp_path)
        state = tr.init_state()
        order = tr._order(tr.train_days, True, 0)
        assert train_step(state, tr.ds, order[0], guard=True)["skipped"] == 0
        before = _snapshot(state)
        param = state.model.factor_predictor.query
        hook = param.register_hook(lambda g: g * float("nan"))
        aux = train_step(state, tr.ds, order[1], guard=True)
        hook.remove()
        assert float(aux["skipped"]) == 1.0 and state.step == 2
        _assert_same(_snapshot(state), before)
        aux = train_step(state, tr.ds, order[1], guard=True)      # a clean step applies
        assert float(aux["skipped"]) == 0.0 and state.step == 3
        assert not torch.equal(state.model.factor_predictor.query, before[0][
            "factor_predictor.query"])
        assert state.scheduler.last_epoch == 2

    def test_a_poisoned_epoch_is_skipped_step_by_step(self, panels, tmp_path):
        _, tp = panels
        tr = _small_trainer(tp, tmp_path, checkpoint_every=0)
        state = tr.init_state()
        before = _snapshot(state)
        hook = state.model.feature_extractor.gru.hidden_kernel.register_hook(
            lambda g: g * float("nan"))
        state, out = tr.fit(state=state, num_epochs=1)
        hook.remove()
        rec = out["history"][0]
        assert rec["skipped_steps"] == tr.steps_per_epoch == state.step
        assert state.optimizer.state_dict()["state"] == {}        # Adam never stepped
        assert state.scheduler.last_epoch == 0
        assert all(torch.equal(v, before[0][k]) for k, v in state.model.state_dict().items())


class TestResume:
    def test_two_epochs_then_resume_equal_three_bitwise(self, panels, tmp_path):
        """With dropout and the sampled MSE loss, so that the noise
        generator's state must round-trip through the checkpoint too."""
        _, tp = panels
        full_tr = _small_trainer(tp, tmp_path, "full")
        full, full_out = full_tr.fit()
        part_tr = _small_trainer(tp, tmp_path, "part")
        _, part_out = part_tr.fit(num_epochs=2)
        assert part_tr.total_steps == full_tr.total_steps
        resumed, res_out = _small_trainer(tp, tmp_path, "part").fit(resume=True)
        assert [r["epoch"] for r in res_out["history"]] == [2]
        assert resumed.step == full.step
        for key in ("train_loss", "val_loss", "lr"):
            assert res_out["history"][0][key] == full_out["history"][2][key]
        assert part_out["history"] == full_out["history"][:2] or all(
            a[k] == b[k] for a, b in zip(part_out["history"], full_out["history"])
            for k in ("train_loss", "val_loss"))
        full_sd, res_sd = full.model.state_dict(), resumed.model.state_dict()
        assert all(torch.equal(full_sd[k], res_sd[k]) for k in full_sd)
        assert res_out["best_val"] == full_out["best_val"]

    def test_evaluate_score_and_refusals(self, panels, tmp_path):
        _, tp = panels
        tr = _small_trainer(tp, tmp_path, checkpoint_every=0)
        state, out = tr.fit(num_epochs=1)
        m = tr.evaluate(state.model)
        assert m["days"] == len(tr.val_days) and np.isfinite(m["loss"])
        assert m == tr.evaluate(state.model)                       # seeded noise
        frame = tr.score(state.model, stochastic=False)
        assert len(frame) == int(tp.valid.sum()) and np.isfinite(frame["score"]).all()
        with pytest.raises(ValueError):
            Trainer(tr.cfg, tr.ds, device="meta")
        bf16 = dataclasses.replace(tr.cfg, model=dataclasses.replace(
            tr.cfg.model, compute_dtype="bfloat16"))
        mixed = Trainer(bf16, tr.ds, device="cpu")        # bf16 now trains (mixed)
        assert mixed.mixed and mixed.train_dtype == "bfloat16"
        int8 = dataclasses.replace(tr.cfg, train=dataclasses.replace(
            tr.cfg.train, compute_dtype="int8"))
        with pytest.raises(ValueError, match="serving rung"):
            Trainer(int8, tr.ds, device="cpu")

    def test_remat_is_refused_naming_item_15(self, panels, tmp_path):
        """Rematerialization is ported (ROADMAP Queue 1 item 15): "dots"
        and "full" train, bitwise the weights of "none" after an epoch
        (tests/test_torch_remat.py holds them step by step); a rung that
        does not exist is still refused, with the JAX package's message."""
        _, tp = panels
        tr = _small_trainer(tp, tmp_path, checkpoint_every=0)
        state, _ = tr.fit(num_epochs=1)
        for rung in ("dots", "full"):
            remat = dataclasses.replace(tr.cfg, train=dataclasses.replace(
                tr.cfg.train, remat=rung))
            rstate, _ = Trainer(remat, tr.ds, device="cpu").fit(num_epochs=1)
            _assert_same(_snapshot(rstate), _snapshot(state))
        bad = dataclasses.replace(tr.cfg, train=dataclasses.replace(tr.cfg.train,
                                                                    remat="some"))
        with pytest.raises(ValueError, match="expected 'none', 'dots' or 'full'"):
            Trainer(bad, tr.ds, device="cpu")
