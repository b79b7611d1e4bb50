"""Rematerialization (`TrainConfig.remat`) in the port against the JAX
package and against the port's own remat "none".

Shapes: C 8, T 5, H 8, K 4, M 8 on a 36-day synthetic panel of 11 stocks;
on the CPU the kernels run their plain versions inside the same
`autograd.Function`s the card uses, so the checkpoint drops and recomputes
the same saved tensors.

- The port's `Trainer` under "dots" and "full" against the JAX `Trainer`
  under the same rung, 3 epochs from the same Flax weights: per-epoch
  losses at rtol 2e-5 (the trainer parity test's tolerance).
- Within the port, "dots" and "full" against "none": one step's loss, aux,
  gradients, weights and the generator's state after it, bitwise (serial
  f32 with and without dropout, the mixed step, a probed step); the seed
  fleet after an epoch; the walk-forward refit. Every step draws its noise
  first; "none" against a forward that draws it itself, bitwise.
- The recompute: K1's residual variant and K4 run twice per rematerialized
  step, the walk once; "dots" recomputes no matrix product, "full" does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.train.trainer import Trainer as JTrainer
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.ops.kernels import attention as attention_mod
from factorvae_tpu_torch.ops.kernels import gru as gru_mod
from factorvae_tpu_torch.params import flax_to_torch
from factorvae_tpu_torch.train.fleet import FleetTrainer
from factorvae_tpu_torch.train.loop import (
    DOT_OPS,
    check_remat,
    rematerialized,
    train_step,
    weighted_day_loss,
)
from factorvae_tpu_torch.train.state import cast_compute
from factorvae_tpu_torch.train.trainer import Trainer, init_train_state
from factorvae_tpu_torch.wf.operator import warm_refit

C, T, H, K, M = 8, 5, 8, 4, 8
RUNGS = ("dots", "full")
LOSS_SCALE = (2.0, 0.5, 2000, 1.0)


@pytest.fixture(scope="module")
def panels():
    jp = synthetic_panel(num_days=36, num_instruments=11, num_features=C,
                         missing_prob=0.2, seed=4)
    tp = Panel(values=jp.values, valid=jp.valid,
               dates=jp.dates.values.astype("datetime64[D]"),
               instruments=np.asarray(jp.instruments))
    return jp, tp


@pytest.fixture(scope="module")
def ds(panels):
    return PanelDataset(panels[1], seq_len=T, device="cpu")


def _jconfig(tp, tmp_path, remat="none", epochs=3) -> jconfig.Config:
    d = [str(x) for x in tp.dates]
    return jconfig.Config(
        model=jconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                  num_portfolios=M, seq_len=T, dropout_rate=0.0,
                                  recon_loss="nll"),
        data=jconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[24],
                                val_start_time=d[25], val_end_time=d[35]),
        train=jconfig.TrainConfig(num_epochs=epochs, lr=1e-3, seed=3, days_per_step=2,
                                  checkpoint_every=0, recover_after=0, remat=remat,
                                  save_dir=str(tmp_path / "jax")))


def _model_cfg(**kw) -> tconfig.ModelConfig:
    return tconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                               num_portfolios=M, seq_len=T, **kw)


def _with_remat(cfg, remat):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat=remat))


class TestAgainstJax:
    @pytest.mark.parametrize("remat", RUNGS)
    def test_port_trainer_tracks_the_jax_trainer_under_the_rung(self, panels, tmp_path,
                                                                remat):
        jp, tp = panels
        jcfg = _jconfig(tp, tmp_path, remat=remat)
        jtr = JTrainer(jcfg, JPanelDataset(jp, seq_len=T))
        jstate = jtr.init_state()
        weights = flax_to_torch(jstate.params)
        _, jout = jtr.fit(state=jstate)
        cfg = tconfig.Config.from_dict(jcfg.to_dict())
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, save_dir=str(tmp_path / "port")))
        assert cfg.train.remat == remat
        tr = Trainer(cfg, PanelDataset(tp, seq_len=T, device="cpu"), device="cpu")
        state = tr.init_state()
        state.model.load_state_dict(weights)
        _, out = tr.fit(state=state)
        got = [(r["train_loss"], r["val_loss"]) for r in out["history"]]
        want = [(r["train_loss"], r["val_loss"]) for r in jout["history"]]
        np.testing.assert_allclose(got, want, rtol=2e-5)
        assert [r["step"] for r in out["history"]] == [r["step"] for r in jout["history"]]

    def test_a_bad_rung_raises_the_jax_message(self, panels, tmp_path, ds):
        jp, tp = panels
        jcfg = _jconfig(tp, tmp_path, remat="some")
        with pytest.raises(ValueError) as want:
            JTrainer(jcfg, JPanelDataset(jp, seq_len=T))
        with pytest.raises(ValueError) as got:
            check_remat("some")
        assert str(got.value) == str(want.value)
        cfg = tconfig.Config.from_dict(jcfg.to_dict())
        with pytest.raises(ValueError, match="remat='some': expected"):
            Trainer(cfg, ds, device="cpu")


# one step, within the port


CASES = {
    "f32": dict(model=dict(dropout_rate=0.0, recon_loss="nll")),
    "dropout_mse": dict(model=dict(dropout_rate=0.3, recon_loss="mse")),
    "mixed": dict(model=dict(dropout_rate=0.3, compute_dtype="bfloat16")),
    "probes": dict(model=dict(dropout_rate=0.3), probes=True),
}


def _step(ds, case: str, remat: str):
    """(loss aux, grads, weights, generator state) after one step of a
    4-day batch with a padding day, under `remat`."""
    spec = CASES[case]
    mcfg = _model_cfg(**spec["model"])
    state = init_train_state(mcfg, tconfig.TrainConfig(seed=3), 100, "cpu")
    aux = train_step(state, ds, torch.tensor([3, 7, 9, -1]), guard=True,
                     compute_dtype=mcfg.dtype, loss_scale_cfg=LOSS_SCALE,
                     probes=spec.get("probes", False), remat=remat)
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    weights = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    return aux, grads, weights, state.generator.get_state().clone()


def _forward_draws_step(ds, case: str):
    """The loss aux, gradients and generator state of `_step`'s batch when
    the forward draws its own noise from the state's generator (eps, then
    the keep mask, inside `day_batched_forward`): the plain graph that
    remat "none" must stay bitwise."""
    spec = CASES[case]
    mcfg = _model_cfg(**spec["model"])
    state = init_train_state(mcfg, tconfig.TrainConfig(seed=3), 100, "cpu")
    mixed = mcfg.dtype != torch.float32
    loss, aux = weighted_day_loss(state.model, ds, torch.tensor([3, 7, 9, -1]), train=True,
                                  generator=state.generator,
                                  params=cast_compute(state.model, mcfg.dtype) if mixed
                                  else None, probes=spec.get("probes", False))
    if mixed:
        (loss * float(state.loss_scale)).backward()
        for p in state.model.parameters():
            p.grad.mul_(float(np.float32(1.0) / state.loss_scale))
    else:
        loss.backward()
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return aux, grads, state.generator.get_state().clone()


def _same(a, b) -> bool:
    if torch.is_tensor(a):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b


class TestStepBitwise:
    @pytest.mark.parametrize("case", list(CASES))
    @pytest.mark.parametrize("remat", RUNGS)
    def test_equals_remat_none(self, ds, case, remat):
        """Loss, aux sums (probes included, counted once), every gradient,
        the weights after Adam and the generator's state: bitwise "none"'s.
        The noise is drawn before the checkpoint and nothing inside it
        draws, so the checkpoint keeps no RNG state (`preserve_rng_state`
        off) and still recomputes the same forward."""
        want, got = _step(ds, case, "none"), _step(ds, case, remat)
        for a, b in zip(got[:3], want[:3]):
            assert a.keys() == b.keys()
            assert all(_same(a[k], b[k]) for k in a), [k for k in a if not _same(a[k], b[k])]
        assert torch.equal(got[3], want[3])
        if case == "probes":
            assert "grad_norm_max" in got[0] and "mu_spread_sum" in got[0]

    @pytest.mark.parametrize("case", list(CASES))
    def test_none_is_the_forward_drawing_its_own_noise(self, ds, case):
        """Every step draws its noise before the day loss (`day_noise`); under
        "none" that leaves the step bitwise the one whose forward draws the
        same noise itself: the loss aux, every gradient and the generator's
        state."""
        got, want = _step(ds, case, "none"), _forward_draws_step(ds, case)
        assert all(_same(got[0][k], want[0][k]) for k in want[0]), case
        assert all(_same(got[1][k], want[1][k]) for k in want[1]), case
        assert torch.equal(got[3], want[2])


class _Count:
    def __init__(self, monkeypatch, module, name):
        self.n = 0
        fn = getattr(module, name)

        def counted(*a, **kw):
            self.n += 1
            return fn(*a, **kw)

        monkeypatch.setattr(module, name, counted)


class _DotCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in DOT_OPS
        return func(*args, **(kwargs or {}))


class TestRecompute:
    @pytest.mark.parametrize("remat", ("none",) + RUNGS)
    def test_the_backward_reruns_the_forward(self, ds, monkeypatch, remat):
        """The training forward's kernels (here their plain versions, behind
        the same Functions): K1's residual variant and K4 once per step
        under "none", twice under "dots" and "full" (the recompute takes
        the residual variant again, grad mode being on); the walk once."""
        residual = _Count(monkeypatch, gru_mod, "gru_fwd_residuals")
        walk = _Count(monkeypatch, gru_mod, "gru_bwd")
        k4 = _Count(monkeypatch, attention_mod, "attention_fwd")
        _step(ds, "f32", remat)
        twice = 1 if remat == "none" else 2
        assert (residual.n, k4.n, walk.n) == (twice, twice, 1)

    def test_dots_keeps_the_products(self, ds):
        """The backward of "dots" runs the matrix products of "none"'s (the
        gradients' own: the recompute takes the kept products) and fewer than
        "full", which recomputes them."""
        mcfg = _model_cfg(dropout_rate=0.0, recon_loss="nll")
        counts = {}
        for remat in ("none",) + RUNGS:
            state = init_train_state(mcfg, tconfig.TrainConfig(seed=3), 100, "cpu")
            loss, _ = rematerialized(remat, weighted_day_loss, state.model, ds,
                                     torch.tensor([3, 7]), train=True,
                                     eps=torch.zeros(2, ds.n_max))
            with _DotCounter() as mode:
                loss.backward()
            counts[remat] = mode.n
        assert counts["none"] == counts["dots"] < counts["full"], counts


class TestFleetAndRefit:
    @pytest.mark.parametrize("remat", RUNGS)
    def test_seed_fleet_equals_remat_none(self, panels, tmp_path, ds, remat):
        """A seed fleet of 3 with dropout, an epoch at days_per_step 2: the
        stacked weights and the history bitwise those of "none" (the
        checkpoint wraps the vmapped `lane_day_loss`, the lanes' noise drawn
        before it)."""
        _, tp = panels
        d = [str(x) for x in tp.dates]
        base = tconfig.Config(
            model=_model_cfg(dropout_rate=0.3),
            data=tconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[24],
                                    val_start_time=d[25], val_end_time=d[35]),
            train=tconfig.TrainConfig(num_epochs=1, lr=1e-3, seed=3, days_per_step=2,
                                      checkpoint_every=0, save_dir=str(tmp_path)))
        runs = [FleetTrainer(c, ds, seeds=[3, 4, 5], device="cpu").fit()
                for c in (base, _with_remat(base, remat))]
        (plain, plain_out), (got, got_out) = runs
        assert all(torch.equal(plain.params[k], got.params[k]) for k in plain.params)
        strip = ("seconds", "days_per_sec", "seed_days_per_sec")
        assert ([{k: v for k, v in r.items() if k not in strip} for r in got_out["history"]]
                == [{k: v for k, v in r.items() if k not in strip}
                    for r in plain_out["history"]])

    def test_refit_trains_under_the_callers_remat(self, panels, tmp_path, ds):
        """`warm_refit` under "full" from the same warm weights: the weights
        and best validation loss of the refit under "none"."""
        jp, tp = panels
        cfg = tconfig.Config.from_dict(_jconfig(tp, tmp_path, epochs=2).to_dict())
        warm = init_train_state(cfg.model, dataclasses.replace(cfg.train, seed=11), 10,
                                "cpu").model.state_dict()
        plain, plain_info, _ = warm_refit(cfg, ds, warm_params=warm)
        full, full_info, _ = warm_refit(_with_remat(cfg, "full"), ds, warm_params=warm)
        a, b = plain.model.state_dict(), full.model.state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert plain_info["best_val"] == full_info["best_val"]
