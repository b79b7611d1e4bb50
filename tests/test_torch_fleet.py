"""The port's fleets of models against the JAX package's.

On the CPU the port's kernels run their plain versions lane by lane; the
JAX kernels run in Pallas interpret mode, as the JAX package's own tests
run them, under `jax.vmap` over per-lane weights (Pallas's batching rule,
the JAX fleet's path). Inputs come from numpy; the port's lanes start from
the JAX fleet's Flax weights (`params.flax_to_torch`), and runs that
compare the two packages are deterministic (dropout 0, the NLL loss).

Tolerances:
- the lane-axis kernels at the kernel tests' (`test_torch_kernels.py`):
  rtol 1e-5 / atol 1e-6, the GRU's and the attention's weight gradients,
  summed over rows, steps and days, at rtol 2e-5 / atol 5e-6;
- fleets, sweeps and PBT at the port trainer's rtol 2e-5 for losses and
  best_val (`test_torch_train.py`), parameters after two epochs of Adam at
  rtol 2e-5 / atol 2e-6 and scores at the CLI test's rtol 2e-5 / atol 2e-6
  (Adam magnifies rounding in small gradients);
- within the port: S = 1 against the `Trainer`, homogeneous lanes against
  the seed fleet and a group resume against the unbroken run, bitwise.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import panel_to_frame as jpanel_to_frame
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.eval.predict import fleet_prediction_scores as jfleet_scores
from factorvae_tpu.eval.sweep import grid_sweep as jgrid_sweep
from factorvae_tpu.eval.sweep import seed_sweep as jseed_sweep
from factorvae_tpu.ops.pallas.attention import multihead_cross_section_attention
from factorvae_tpu.ops.pallas.attention_grad import fused_attention
from factorvae_tpu.ops.pallas.gru import _SEG_MAX, gru_scan
from factorvae_tpu.train.fleet import FleetTrainer as JFleetTrainer
from factorvae_tpu.train.fleet import unstack_state as junstack
from factorvae_tpu.train.pbt import pbt_fit as jpbt_fit
from factorvae_tpu.train.trainer import Trainer as JTrainer
from factorvae_tpu.utils.logging import MetricsLogger as JMetricsLogger
from factorvae_tpu_torch import chaos, cli
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.eval import sweep
from factorvae_tpu_torch.eval.predict import (
    fleet_prediction_scores,
    predict_panel,
    predict_panel_fleet,
)
from factorvae_tpu_torch.models.factorvae import model_from_params
from factorvae_tpu_torch.ops.kernels.attention import attention, attention_bwd, attention_fwd
from factorvae_tpu_torch.ops.kernels.gru import (
    gru,
    gru_bwd,
    gru_dwh,
    gru_fwd,
    gru_fwd_residuals,
    launch_shape,
)
from factorvae_tpu_torch.params import flax_to_torch, read_state_dict
from factorvae_tpu_torch.train.fleet import (
    FleetTrainer,
    lane_label,
    select_best,
    stack_states,
    unstack_state,
    validate_lane_configs,
)
from factorvae_tpu_torch.train.pbt import pbt_fit, perturb_factor
from factorvae_tpu_torch.train.state import learning_rate_at
from factorvae_tpu_torch.train.trainer import Trainer
from factorvae_tpu_torch.utils.logging import MetricsLogger

C, T, H, K, M = 8, 5, 8, 4, 8
S = 3
SEEDS = [3, 4, 5]
TOL = dict(rtol=1e-5, atol=1e-6)
SUM_TOL = dict(rtol=2e-5, atol=5e-6)
LOSS_RTOL = 2e-5
PARAM_TOL = dict(rtol=2e-5, atol=2e-6)
SCORE_TOL = dict(rtol=2e-5, atol=2e-6)
HYPER = [(1e-3, 1.0), (3e-3, 0.1), (2e-3, 0.5)]        # (lr, kl_weight) per lane


# ---- the kernels' lane axis -------------------------------------------------


def _np_lanes(rng, *shapes, scale=1.0):
    return [(rng.normal(size=(S,) + s) * scale).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


class TestGruLanes:
    @pytest.mark.parametrize("n,t", [(7, 6), (5, _SEG_MAX + 6)], ids=["K2", "K3"])
    def test_plain_lanes_match_vmapped_pallas(self, rng, n, t):
        """K1 and the backward (K2 at T <= 24, K3's segmented kernel above)
        with a lane axis against jax.vmap of the Pallas gru_scan and its
        VJP over per-lane weights."""
        h = 4
        xi, = _np_lanes(rng, (n, t, 3 * h), scale=0.5)
        wh, = _np_lanes(rng, (h, 3 * h), scale=0.3)
        bh, = _np_lanes(rng, (3 * h,), scale=0.1)
        dh, = _np_lanes(rng, (n, h))
        want_h = np.asarray(jax.vmap(gru_scan)(*map(jnp.asarray, (xi, wh, bh))))
        grad = jax.vmap(jax.grad(lambda x, w, b, d: jnp.sum(gru_scan(x, w, b) * d),
                                 argnums=(0, 1, 2)))
        want = [np.asarray(g) for g in grad(*map(jnp.asarray, (xi, wh, bh, dh)))]
        tx, tw, tb, tdh = _t(xi, wh, bh, dh)
        np.testing.assert_allclose(gru_fwd(tx, tw, tb).numpy(), want_h, **TOL)
        h_res, hseq, gseq = gru_fwd_residuals(tx, tw, tb)
        assert torch.equal(h_res, gru_fwd(tx, tw, tb))
        assert hseq.shape == (S, n, t, h) and gseq.shape == (S, n, t, 3 * h)
        got = gru_bwd(tx, tw, tb, tdh, residuals=(hseq, gseq))
        np.testing.assert_allclose(got[0].numpy(), want[0], **TOL)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), w, **SUM_TOL)
        # each lane of the lane-axis call is its one-model call, bitwise
        for s in range(S):
            one = gru_bwd(tx[s], tw[s], tb[s], tdh[s])
            assert all(torch.equal(a[s], b) for a, b in zip(got, one))
        dgn = torch.from_numpy(rng.normal(size=(S, n, t, h)).astype(np.float32))
        dwh = gru_dwh(hseq, got[0], dgn)
        for s in range(S):
            assert all(torch.equal(a[s], b) for a, b in zip(dwh, gru_dwh(hseq[s], got[0][s],
                                                                          dgn[s])))

    def test_vmap_of_the_function_equals_a_loop_over_lanes(self, rng):
        n, t, h = 6, 5, 4
        arrays = _t(*_np_lanes(rng, (n, t, 3 * h), (h, 3 * h), (3 * h,), scale=0.4))
        leaves = [a.clone().requires_grad_() for a in arrays]
        out = torch.func.vmap(gru)(*leaves)
        dh = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
        grads = torch.autograd.grad(out, leaves, dh)
        for s in range(S):
            one = [a[s].detach().clone().requires_grad_() for a in arrays]
            o = gru(*one)
            assert torch.equal(o, out[s])
            for g, w in zip(grads, torch.autograd.grad(o, one, dh[s])):
                assert torch.equal(g[s], w)
        with torch.no_grad():                       # the serving variant
            assert torch.equal(torch.func.vmap(gru)(*arrays), out)

    def test_launch_shape_sees_every_lane(self):
        # one flagship day: 38 tiles of 8 rows fill 132 SMs at 4 lanes
        # without a cluster split, and need a split of 4 at one lane
        assert launch_shape(304, 64, 132) == (8, 4)
        assert launch_shape(304, 64, 132, lanes=4) == (8, 1)
        assert launch_shape(304, 64, 132, lanes=8) == (16, 1)

    def test_wrappers_reject_mismatched_lanes(self):
        with pytest.raises(ValueError):
            gru_fwd(torch.zeros(2, 3, 4, 6), torch.zeros(3, 2, 6), torch.zeros(2, 6))
        with pytest.raises(ValueError):
            gru_bwd(torch.zeros(2, 3, 4, 6), torch.zeros(2, 2, 6), torch.zeros(2, 6),
                    torch.zeros(3, 2))


def _att_lanes(rng, b, n, k, h):
    latent = rng.normal(size=(S, b, n, h)).astype(np.float32)
    mask = rng.random((S, b, n)) > 0.25
    q = rng.normal(size=(S, k, h)).astype(np.float32)
    wk = (rng.normal(size=(S, k, h, h)) / np.sqrt(h)).astype(np.float32)
    bk = (rng.normal(size=(S, k, h)) * 0.1).astype(np.float32)
    wv = (rng.normal(size=(S, k, h, h)) / np.sqrt(h)).astype(np.float32)
    bv = (rng.normal(size=(S, k, h)) * 0.1).astype(np.float32)
    keep = ((rng.random((S, b, k, n)) > 0.2) / 0.8).astype(np.float32)
    return latent, mask, q, wk, bk, wv, bv, keep


class TestAttentionLanes:
    B, N = 2, 9

    @pytest.mark.parametrize("poison", [False, True], ids=["clean", "nan_lane"])
    def test_plain_lanes_match_vmapped_pallas(self, rng, poison):
        """K4 and K5's six gradients with a lane axis against jax.vmap of
        the Pallas kernels over per-lane weights; a NaN latent in lane 1
        changes no other lane (the guard stays in its lane)."""
        latent, mask, q, wk, bk, wv, bv, keep = _att_lanes(rng, self.B, self.N, K, H)
        dctx = rng.normal(size=(S, self.B, K, H)).astype(np.float32)
        if poison:
            latent[1, 0, 2, 0] = np.nan
            mask[1, 0, 2] = True

        def lane_fwd(lat, m, q_, wk_, bk_, wv_, bv_, kp):
            return jnp.stack([multihead_cross_section_attention(
                lat[d], m[d], q_, wk_, bk_, wv_, bv_, dropout_mask=kp[d])
                for d in range(self.B)])

        def lane_vjp(lat, m, q_, wk_, bk_, wv_, bv_, kp, dc):
            def f(lat_, q2, wk2, bk2, wv2, bv2):
                return jnp.stack([fused_attention(lat_[d], m[d].astype(jnp.float32), q2,
                                                  wk2, bk2, wv2, bv2, kp[d])
                                  for d in range(self.B)])
            return jax.vjp(f, lat, q_, wk_, bk_, wv_, bv_)[1](dc)

        args = (latent, mask, q, wk, bk, wv, bv, keep)
        want = np.asarray(jax.vmap(lane_fwd)(*map(jnp.asarray, args)))
        want_g = [np.asarray(g) for g in jax.vmap(lane_vjp)(*map(jnp.asarray, args + (dctx,)))]
        targs = _t(*args)
        got = attention_fwd(*targs[:7], keep=targs[7])
        grads = attention_bwd(*targs[:7], _t(dctx)[0], keep=targs[7])
        clean = [s for s in range(S) if not (poison and s == 1)]
        np.testing.assert_allclose(got.numpy()[clean], want[clean], **TOL)
        np.testing.assert_allclose(grads[0].numpy()[clean], want_g[0][clean], **TOL)
        for g, w in zip(grads[1:], want_g[1:]):
            np.testing.assert_allclose(g.numpy()[clean], w[clean], **SUM_TOL)
        if poison:
            # the guarded day of lane 1: zero context and zero gradients
            # there, by a select (the Pallas kernel's 0 * NaN leaks NaN)
            assert (got[1, 0] == 0).all() and (grads[0][1, 0] == 0).all()
            assert all(torch.isfinite(g).all() for g in grads)
        for s in range(S):
            one = attention_bwd(*(a[s] for a in targs[:7]), _t(dctx)[0][s], keep=targs[7][s])
            assert all(torch.equal(a[s], b) for a, b in zip(grads, one))

    def test_vmap_of_the_function_equals_a_loop_over_lanes(self, rng):
        arrays = _t(*_att_lanes(rng, self.B, self.N, K, H))
        leaves = [a.clone().requires_grad_() if i not in (1, 7) else a
                  for i, a in enumerate(arrays)]
        out = torch.func.vmap(attention)(*leaves)
        dctx = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
        diff = [a for a in leaves if a.requires_grad]
        grads = torch.autograd.grad(out, diff, dctx)
        for s in range(S):
            one = [a[s].detach().clone().requires_grad_() if a.requires_grad else a[s]
                   for a in leaves]
            o = attention(*one)
            assert torch.equal(o, out[s])
            for g, w in zip(grads, torch.autograd.grad(
                    o, [a for a in one if a.requires_grad], dctx[s])):
                assert torch.equal(g[s], w)
        # a mask shared by the lanes (the scoring fleet's) and no keep-mask
        shared = torch.func.vmap(lambda lat, *w: attention(lat, arrays[1][0], *w),
                                 in_dims=(0, 0, 0, 0, 0, 0))(*(a.detach() for a in
                                                               (arrays[0], *arrays[2:7])))
        assert torch.equal(shared[2], attention(arrays[0][2], arrays[1][0],
                                                *(a[2] for a in arrays[2:7])))


# ---- fleets against the JAX fleets ------------------------------------------


@pytest.fixture(scope="module")
def panels():
    jp = synthetic_panel(num_days=30, num_instruments=10, num_features=C,
                         missing_prob=0.1, seed=0)
    tp = Panel(values=jp.values, valid=jp.valid,
               dates=jp.dates.values.astype("datetime64[D]"),
               instruments=np.asarray(jp.instruments))
    return jp, tp, JPanelDataset(jp, seq_len=T), PanelDataset(tp, seq_len=T, device="cpu")


def _jcfg(jp, save_dir, epochs=2, checkpoint_every=0, seed=SEEDS[0]) -> jconfig.Config:
    d = [str(x.date()) for x in jp.dates]
    return jconfig.Config(
        model=jconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                  num_portfolios=M, seq_len=T, dropout_rate=0.0,
                                  recon_loss="nll"),
        data=jconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[19],
                                val_start_time=d[20], val_end_time=d[29]),
        train=jconfig.TrainConfig(num_epochs=epochs, lr=1e-3, seed=seed,
                                  checkpoint_every=checkpoint_every, recover_after=0,
                                  save_dir=str(save_dir)))


def _port(jcfg: jconfig.Config, save_dir) -> tconfig.Config:
    cfg = tconfig.Config.from_dict(jcfg.to_dict())
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              save_dir=str(save_dir)))


def _score_days(jp):
    d = [str(x.date()) for x in jp.dates]
    return d[5], d[29]


@pytest.fixture(scope="module")
def jax_weights(panels, tmp_path_factory):
    """Each seed's initial Flax weights (the JAX fleet's vmapped init), as
    torch state dicts."""
    jp = panels[0]
    jft = JFleetTrainer(_jcfg(jp, tmp_path_factory.mktemp("jinit")), panels[2],
                        seeds=SEEDS, logger=JMetricsLogger(echo=False))
    state = jft.init_fleet_state()
    return {s: flax_to_torch(junstack(state.params, i))
            for i, s in enumerate(SEEDS)}


@pytest.fixture()
def from_jax_weights(monkeypatch, jax_weights):
    """Every port fleet lane starts from its seed's Flax weights."""
    init = FleetTrainer.init_lane_state

    def patched(self, i):
        st = init(self, i)
        st.model.load_state_dict(jax_weights[self.seeds[i]])
        return st

    monkeypatch.setattr(FleetTrainer, "init_lane_state", patched)


@pytest.fixture(scope="module")
def jax_seed_fleet(panels, tmp_path_factory):
    jp, _, jds, _ = panels
    jcfg = _jcfg(jp, tmp_path_factory.mktemp("jfleet"))
    state, out = JFleetTrainer(jcfg, jds, seeds=SEEDS,
                               logger=JMetricsLogger(echo=False)).fit()
    start, end = _score_days(jp)
    frames = jfleet_scores(out["best_params"], jcfg, jds, start=start, end=end,
                           stochastic=False)
    return {"cfg": jcfg, "history": out["history"], "best_val": np.asarray(out["best_val"]),
            "final": [flax_to_torch(junstack(state.params, i)) for i in range(S)],
            "scores": [f["score"].to_numpy() for f in frames]}


# Parameters whose gradient is zero in exact arithmetic (ROADMAP Queue 3):
# the portfolio softmax is shift-invariant, and a head whose valid scores
# are all positive ignores its key bias. Both packages feed Adam rounding
# noise there, which it turns into steps of up to lr; such a parameter is
# held to the sum of the run's learning rates, every other one to PARAM_TOL.
ZERO_GRAD = ("factor_encoder.portfolio.bias", "factor_predictor.key_bias")


def _assert_params(got: dict, want: list, cfg, epochs: int, steps: int):
    lr_sum = cfg.train.lr * epochs * steps
    for i, lane in enumerate(want):
        for name, w in lane.items():
            g = got[name][i].detach().numpy()
            if name in ZERO_GRAD:
                assert np.abs(g - w.numpy()).max() <= lr_sum, name
            else:
                np.testing.assert_allclose(g, w.numpy(), err_msg=name, **PARAM_TOL)


def _assert_history(got, want):
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want],
                                   rtol=LOSS_RTOL, err_msg=key)
    assert [r["step"] for r in got] == [r["step"] for r in want]


class TestSeedFleet:
    def test_matches_the_jax_fleet(self, panels, jax_seed_fleet, from_jax_weights, tmp_path):
        """S = 3 from the JAX fleet's weights: per-lane per-epoch losses,
        final parameters, best_val and best-val scores."""
        jp, _, _, ds = panels
        cfg = _port(jax_seed_fleet["cfg"], tmp_path)
        state, out = FleetTrainer(cfg, ds, seeds=SEEDS, device="cpu").fit()
        _assert_history(out["history"], jax_seed_fleet["history"])
        np.testing.assert_allclose(out["best_val"], jax_seed_fleet["best_val"],
                                   rtol=LOSS_RTOL)
        _assert_params(state.params, jax_seed_fleet["final"], cfg, len(out["history"]),
                       FleetTrainer(cfg, ds, seeds=SEEDS, device="cpu").steps_per_epoch)
        days = ds.split_days(*_score_days(jp))
        scores = predict_panel_fleet(out["best_params"], cfg, ds, days, stochastic=False)
        frames = fleet_prediction_scores(out["best_params"], cfg, ds, *_score_days(jp),
                                         stochastic=False, with_labels=True)
        for i in range(S):
            np.testing.assert_allclose(frames[i]["score"].to_numpy(),
                                       jax_seed_fleet["scores"][i], **SCORE_TOL)
            np.testing.assert_array_equal(frames[i]["score"].to_numpy(),
                                          scores[i][ds.valid[days]])
            # lane i's best weights on disk are its snapshot, under its name
            lane = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                      seed=SEEDS[i]))
            sd = read_state_dict(os.path.join(str(tmp_path), lane.checkpoint_name()))
            assert all(torch.equal(sd[n], p[i]) for n, p in out["best_params"].items())
            # a lane scored alone (the serial path) is within rounding of
            # the lane-batched pass
            alone = predict_panel(model_from_params(cfg.model, out["best_params"], i), cfg,
                                  ds, days, stochastic=False)
            np.testing.assert_allclose(scores[i], alone, **TOL)

    def test_seed_sweep_matches_the_jax_sweep(self, panels, from_jax_weights, tmp_path):
        jp, _, jds, ds = panels
        start, end = _score_days(jp)
        jcfg = _jcfg(jp, tmp_path / "jax")
        want = jseed_sweep(jcfg, jds, SEEDS, score_start=start, score_end=end, fleet=True)
        records = []
        got = sweep.seed_sweep(_port(jcfg, tmp_path / "port"), ds, SEEDS, score_start=start,
                               score_end=end, fleet=True, device="cpu",
                               on_seed=records.append)
        assert list(got.index) == list(want.index) == SEEDS
        assert [r["seed"] for r in records] == SEEDS
        np.testing.assert_allclose(got["best_val"], want["best_val"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[["rank_ic", "rank_ic_ir"]], want[["rank_ic",
                                                                         "rank_ic_ir"]],
                                   rtol=1e-4, atol=1e-5)
        # a finished seed is adopted without training, in the caller's order
        # (the other two train as a fleet of two, whose batched products sum
        # in another order than the fleet of three's)
        adopted = sweep.seed_sweep(_port(jcfg, tmp_path / "port2"), ds, SEEDS,
                                   score_start=start, score_end=end, fleet=True,
                                   device="cpu", prior_records={4: 0.5})
        assert list(adopted.index) == SEEDS and adopted.loc[4, "rank_ic"] == 0.5
        np.testing.assert_allclose(adopted.loc[[3, 5]].to_numpy(),
                                   got.loc[[3, 5]].to_numpy(), rtol=LOSS_RTOL)


    def test_seed_sweep_in_programs_matches_the_jax_sweep(self, panels, from_jax_weights,
                                                          tmp_path):
        """`seeds_per_program=2`: the seeds train as fleets [3, 4] then [5],
        in order, and the frame equals the JAX sweep's at the same width."""
        jp, _, jds, ds = panels
        start, end = _score_days(jp)
        jcfg = _jcfg(jp, tmp_path / "jax")
        want = jseed_sweep(jcfg, jds, SEEDS, score_start=start, score_end=end, fleet=True,
                           seeds_per_program=2)
        log = str(tmp_path / "port.jsonl")
        logger = MetricsLogger(jsonl_path=log, echo=False)
        got = sweep.seed_sweep(_port(jcfg, tmp_path / "port"), ds, SEEDS, score_start=start,
                               score_end=end, fleet=True, seeds_per_program=2,
                               logger=logger, device="cpu")
        logger.finish()
        with open(log) as fh:
            layouts = [e["seeds"] for e in map(json.loads, fh)
                       if e["event"] == "fleet_execution_layout"]
        assert layouts == [SEEDS[:2], SEEDS[2:]]
        assert list(got.index) == list(want.index) == SEEDS
        np.testing.assert_allclose(got["best_val"], want["best_val"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[["rank_ic", "rank_ic_ir"]], want[["rank_ic",
                                                                         "rank_ic_ir"]],
                                   rtol=1e-4, atol=1e-5)


def _lane_cfgs(cfg, scalars, seeds=None):
    return [sweep._point_config(cfg, {"lr": lr, "kl_weight": klw,
                                      **({"seed": seeds[i]} if seeds else {})},
                                sweep.point_label({"lr": lr, "kl_weight": klw}))
            for i, (lr, klw) in enumerate(scalars)]


class TestHyperFleet:
    def test_grid_sweep_and_its_fleet_match_jax(self, panels, from_jax_weights, tmp_path):
        """The hyper-fleet under `grid_sweep` on the same per-lane lr and
        kl_weight as the JAX one: its per-lane per-epoch losses (the
        `fleet_epoch` records), and the frame."""
        jp, _, jds, ds = panels
        start, end = _score_days(jp)
        points = [{"lr": lr, "kl_weight": klw} for lr, klw in HYPER]
        jlog = str(tmp_path / "jax.jsonl")
        jcfg = _jcfg(jp, tmp_path / "jax")
        want = jgrid_sweep(jcfg, jds, points, score_start=start, score_end=end,
                           logger=JMetricsLogger(jsonl_path=jlog, echo=False))
        log = str(tmp_path / "port.jsonl")
        logger = MetricsLogger(jsonl_path=log, echo=False)
        got = sweep.grid_sweep(_port(jcfg, tmp_path / "port"), ds, points, score_start=start,
                               score_end=end, logger=logger, device="cpu")
        logger.finish()
        assert list(got.index) == list(want.index)
        assert got.attrs["summary"]["best_label"] == want.attrs["summary"]["best_label"]
        np.testing.assert_allclose(got["best_val"], want["best_val"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[["rank_ic", "rank_ic_ir"]],
                                   want[["rank_ic", "rank_ic_ir"]], rtol=1e-4, atol=1e-5)

        def epochs(path):
            with open(path) as fh:
                return [e for e in map(json.loads, fh) if e["event"] == "fleet_epoch"]

        got_e, want_e = epochs(log), epochs(jlog)
        _assert_history(got_e, want_e)
        np.testing.assert_allclose([r["lr"] for r in got_e], [r["lr"] for r in want_e],
                                   rtol=1e-12)
        # the labels' config hashes differ: the two packages' configs have
        # other fields (the Pallas knobs, the save_dir)
        def labels(events):
            return [[lbl.rsplit(" cfg=", 1)[0] for lbl in r["lane_labels"]] for r in events]

        assert labels(got_e) == labels(want_e)

    def test_grid_sweep_in_programs_matches_jax(self, panels, from_jax_weights, tmp_path):
        """`lanes_per_program=2`: the grid trains as hyper-fleets of two
        lanes then one, in order; the frame equals the JAX sweep's."""
        jp, _, jds, ds = panels
        start, end = _score_days(jp)
        points = [{"lr": lr, "kl_weight": klw} for lr, klw in HYPER]
        jcfg = _jcfg(jp, tmp_path / "jax")
        want = jgrid_sweep(jcfg, jds, points, score_start=start, score_end=end,
                           lanes_per_program=2)
        log = str(tmp_path / "port.jsonl")
        logger = MetricsLogger(jsonl_path=log, echo=False)
        got = sweep.grid_sweep(_port(jcfg, tmp_path / "port"), ds, points, score_start=start,
                               score_end=end, logger=logger, lanes_per_program=2,
                               device="cpu")
        logger.finish()
        with open(log) as fh:
            events = list(map(json.loads, fh))
        assert [len(e["seeds"]) for e in events if e["event"] == "fleet_execution_layout"] \
            == [2, len(HYPER) - 2]
        assert [e["lanes_per_program"] for e in events if e["event"] == "grid_bucket"] == [2]
        assert list(got.index) == list(want.index)
        assert got.attrs["summary"]["best_label"] == want.attrs["summary"]["best_label"]
        np.testing.assert_allclose(got["best_val"], want["best_val"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[["rank_ic", "rank_ic_ir"]],
                                   want[["rank_ic", "rank_ic_ir"]], rtol=1e-4, atol=1e-5)

    def test_homogeneous_lanes_fold_to_the_seed_fleet_bitwise(self, panels, tmp_path):
        jp, _, _, ds = panels
        cfg = _port(_jcfg(jp, tmp_path), tmp_path)
        lanes = _lane_cfgs(cfg, [(1e-3, 1.0)] * S, seeds=SEEDS)
        hyper = FleetTrainer(cfg, ds, lane_configs=lanes, device="cpu")
        assert not hyper.hyper
        st_h, out_h = hyper.fit()
        st_s, out_s = FleetTrainer(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, save_dir=str(tmp_path / "seed"))), ds, seeds=SEEDS, device="cpu").fit()
        for key in ("train_loss", "val_loss"):
            assert [r[key] for r in out_h["history"]] == [r[key] for r in out_s["history"]]
        assert all(torch.equal(st_h.params[n], st_s.params[n]) for n in st_s.params)
        assert FleetTrainer(cfg, ds, lane_configs=lanes, device="cpu", force_hyper=True).hyper

    def test_lane_validation(self, panels, tmp_path):
        jp, _, _, ds = panels
        cfg = _port(_jcfg(jp, tmp_path), tmp_path)
        lanes = _lane_cfgs(cfg, HYPER)
        validate_lane_configs(cfg, lanes)
        wide = dataclasses.replace(lanes[1], model=dataclasses.replace(lanes[1].model,
                                                                       hidden_size=16))
        with pytest.raises(ValueError, match="model.hidden_size"):
            validate_lane_configs(cfg, [lanes[0], wide])
        bf16 = dataclasses.replace(lanes[1], train=dataclasses.replace(
            lanes[1].train, compute_dtype="bfloat16"))
        with pytest.raises(ValueError, match="compute_dtype"):
            validate_lane_configs(cfg, [lanes[0], bf16])
        same = dataclasses.replace(lanes[1], train=dataclasses.replace(
            lanes[1].train, run_name=lanes[0].train.run_name))
        with pytest.raises(ValueError, match="collide"):
            validate_lane_configs(cfg, [lanes[0], same])
        assert lane_label(lanes[1], False) == f"seed={cfg.train.seed}"
        assert lane_label(lanes[1], True).startswith(f"seed={cfg.train.seed} lr=0.003 klw=0.1 ")
        for rung in ("dots", "full"):     # ported: tests/test_torch_remat.py
            remat = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat=rung))
            assert FleetTrainer(remat, ds, seeds=SEEDS, device="cpu").cfg.train.remat == rung
        bad = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat="some"))
        with pytest.raises(ValueError, match="expected 'none', 'dots' or 'full'"):
            FleetTrainer(bad, ds, seeds=SEEDS, device="cpu")
        mesh = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, stock_axis=2))
        with pytest.raises(NotImplementedError, match="item 12"):
            FleetTrainer(mesh, ds, seeds=SEEDS, device="cpu")
        # stream residency is taken from the dataset (tests/test_torch_stream.py)
        stream_ds = PanelDataset(ds.panel, seq_len=ds.seq_len, device="cpu",
                                 residency="stream")
        streamed = FleetTrainer(cfg, stream_ds, seeds=SEEDS, device="cpu")
        assert streamed.stream and streamed.steps_per_chunk == max(
            1, cfg.data.stream_chunk_days // streamed.batch_days)
        with pytest.raises(ValueError, match="duplicate seeds"):
            FleetTrainer(cfg, ds, seeds=[1, 1], device="cpu")

    def test_shape_buckets_and_labels(self):
        points = sweep.parse_hyper_grid("1e-3:1,3e-3:0.1:bfloat16, 2e-3:0.5")
        assert points[1] == {"lr": 3e-3, "kl_weight": 0.1, "compute_dtype": "bfloat16"}
        assert [sweep.point_label(p) for p in points] == [
            "lr0.001_kl1", "lr0.003_kl0.1_dtbfloat16", "lr0.002_kl0.5"]
        assert [[i for i, _ in m] for _, m in sweep.shape_buckets(points)] == [[0, 2], [1]]
        with pytest.raises(ValueError):
            sweep.parse_hyper_grid("1e-3")


class TestPBT:
    LANES = [(3, 1e-3, 1.0), (4, 3e-3, 0.1)]

    def _lanes(self, cfg):
        out = []
        for i, (seed, lr, klw) in enumerate(self.LANES):
            out.append(dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, kl_weight=klw),
                train=dataclasses.replace(cfg.train, seed=seed, lr=lr,
                                          run_name=f"{cfg.train.run_name}_lane{i}")))
        return out

    def test_two_generations_match_jax(self, panels, from_jax_weights, tmp_path):
        jp, _, jds, ds = panels
        jcfg = _jcfg(jp, tmp_path / "jax", epochs=2, checkpoint_every=1)
        _, want = jpbt_fit(jcfg, jds, self._lanes(jcfg), generations=2,
                           epochs_per_generation=1, logger=JMetricsLogger(echo=False))
        cfg = _port(jcfg, tmp_path / "port")
        _, got = pbt_fit(cfg, ds, self._lanes(cfg), generations=2, epochs_per_generation=1,
                         device="cpu")
        assert len(got["generations"]) == 2
        for g, w in zip(got["generations"], want["generations"]):
            np.testing.assert_allclose(g["fitness"], w["fitness"], rtol=LOSS_RTOL)
            assert g["winners"] == w["winners"]
            assert [(e["lane"], e["from"], e["perturb_factor"]) for e in g["exploited"]] == [
                (e["lane"], e["from"], e["perturb_factor"]) for e in w["exploited"]]
        assert got["generations"][0]["exploited"]
        assert [(c.train.lr, c.model.kl_weight) for c in got["lane_configs"]] == pytest.approx(
            [(c.train.lr, c.model.kl_weight) for c in want["lane_configs"]], rel=1e-12)
        np.testing.assert_allclose(got["best_val"], np.asarray(want["best_val"]),
                                   rtol=LOSS_RTOL)

    def test_resume_after_a_kill_equals_the_unbroken_run(self, panels, tmp_path):
        jp, _, _, ds = panels
        kw = dict(generations=2, epochs_per_generation=1, device="cpu")
        cfg_a = _port(_jcfg(jp, tmp_path, checkpoint_every=1), tmp_path / "a")
        _, res_a = pbt_fit(cfg_a, ds, self._lanes(cfg_a), **kw)
        cfg_b = _port(_jcfg(jp, tmp_path, checkpoint_every=1), tmp_path / "b")
        pbt_fit(cfg_b, ds, self._lanes(cfg_b), stop_after=0, **kw)
        _, res_b = pbt_fit(cfg_b, ds, self._lanes(cfg_b), resume=True, **kw)
        assert [r["generation"] for r in res_b["generations"]] == [1]
        assert all(torch.equal(res_a["state"].params[n], res_b["state"].params[n])
                   for n in res_a["state"].params)
        np.testing.assert_array_equal(res_a["best_val"], res_b["best_val"])
        assert ([(c.train.lr, c.model.kl_weight) for c in res_a["lane_configs"]]
                == [(c.train.lr, c.model.kl_weight) for c in res_b["lane_configs"]])
        with open(os.path.join(cfg_b.train.save_dir, f"{cfg_b.train.run_name}_pbt.json")) as f:
            assert json.load(f)["generation"] == 2
        assert {perturb_factor(g, ln) for g in range(2) for ln in range(2)} == {
            0.8, 1.25}


# ---- within the port ----------------------------------------------------------


def _cfg(panels, tmp_path, **train):
    jp = panels[0]
    cfg = _port(_jcfg(jp, tmp_path), tmp_path)
    model = dataclasses.replace(cfg.model, dropout_rate=0.1, recon_loss="mse")
    return dataclasses.replace(cfg, model=model,
                               train=dataclasses.replace(cfg.train, **train))


class TestWithinThePort:
    def test_one_lane_equals_the_trainer_bitwise(self, panels, tmp_path):
        """With dropout and the sampled loss, so that the noise stream must
        be the solo run's too."""
        ds = panels[3]
        cfg = _cfg(panels, tmp_path / "fleet", checkpoint_every=1)
        st_f, out_f = FleetTrainer(cfg, ds, seeds=[7], device="cpu").fit()
        solo = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, seed=7, save_dir=str(tmp_path / "solo")))
        st_s, out_s = Trainer(solo, ds, device="cpu").fit()
        for f, s in zip(out_f["history"], out_s["history"]):
            for key in ("train_loss", "val_loss", "train_recon", "train_kl"):
                assert f[key] == [s[key]]
            assert (f["step"], f["lr"]) == (s["step"], s["lr"])
        assert out_f["best_val"][0] == out_s["best_val"]
        assert all(torch.equal(st_f.params[n][0], p) for n, p in st_s.model.named_parameters())
        name = solo.checkpoint_name()
        a = read_state_dict(os.path.join(str(tmp_path / "fleet"), name))
        b = read_state_dict(os.path.join(str(tmp_path / "solo"), name))
        assert all(torch.equal(a[k], b[k]) for k in b)

    def test_lanes_track_their_solo_runs(self, panels, tmp_path):
        """S = 3 with dropout: each lane draws its solo run's noise, so its
        losses follow the solo `Trainer` within f32 rounding."""
        ds = panels[3]
        cfg = _cfg(panels, tmp_path / "fleet")
        _, out = FleetTrainer(cfg, ds, seeds=SEEDS, device="cpu").fit()
        for i, seed in enumerate(SEEDS):
            solo = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, seed=seed, save_dir=str(tmp_path / f"solo{seed}")))
            _, o = Trainer(solo, ds, device="cpu").fit()
            for key in ("train_loss", "val_loss"):
                np.testing.assert_allclose([r[key][i] for r in out["history"]],
                                           [r[key] for r in o["history"]], rtol=LOSS_RTOL)

    def test_group_resume_equals_the_unbroken_run_bitwise(self, panels, tmp_path):
        ds = panels[3]
        full_cfg = _cfg(panels, tmp_path / "full", checkpoint_every=1, num_epochs=3)
        st_a, out_a = FleetTrainer(full_cfg, ds, seeds=SEEDS, device="cpu").fit()
        cfg = _cfg(panels, tmp_path / "part", checkpoint_every=1, num_epochs=3)
        FleetTrainer(cfg, ds, seeds=SEEDS, device="cpu").fit(num_epochs=2)
        # a member one epoch ahead: the group rewinds to the common epoch
        lane0 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=SEEDS[0]))
        ckpt_dir = os.path.join(cfg.train.save_dir, f"{lane0.checkpoint_name()}_ckpt")
        os.remove(os.path.join(ckpt_dir, "epoch_1.pt"))
        logger = MetricsLogger(echo=False)
        st_b, out_b = FleetTrainer(cfg, ds, seeds=SEEDS, device="cpu",
                                   logger=logger).fit(resume=True)
        assert [r["epoch"] for r in out_b["history"]] == [1, 2]
        assert out_b["history"] == [
            dict(r, seconds=b["seconds"], seed_days_per_sec=b["seed_days_per_sec"])
            for r, b in zip(out_a["history"][1:], out_b["history"])]
        assert all(torch.equal(st_a.params[n], st_b.params[n]) for n in st_a.params)
        np.testing.assert_array_equal(out_a["best_val"], out_b["best_val"])
        # a serial Trainer resumes a fleet member from its checkpoint
        solo = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=SEEDS[1]))
        st_s, out_s = Trainer(solo, ds, device="cpu").fit(resume=True)
        assert out_s["history"] == []                  # already at its last epoch
        assert all(torch.equal(st_b.params[n][1], p) for n, p in st_s.model.named_parameters())

    def test_group_resume_takes_the_largest_common_verified_step(self, panels, tmp_path):
        """A corrupt member step (the chaos kind corrupt_checkpoint) is
        quarantined by the resume's scan, and the group settles on the
        largest epoch every lane has verified, bitwise the unbroken run."""
        from factorvae_tpu_torch.chaos import ops as chaos_ops

        ds = panels[3]
        full_cfg = _cfg(panels, tmp_path / "full", checkpoint_every=1, num_epochs=3)
        st_a, out_a = FleetTrainer(full_cfg, ds, seeds=SEEDS[:2], device="cpu").fit()
        cfg = _cfg(panels, tmp_path / "part", checkpoint_every=1, num_epochs=3)
        FleetTrainer(cfg, ds, seeds=SEEDS[:2], device="cpu").fit(num_epochs=2)
        lane1 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=SEEDS[1]))
        ckpt_dir = os.path.join(cfg.train.save_dir, f"{lane1.checkpoint_name()}_ckpt")
        chaos_ops.corrupt_checkpoint_step(ckpt_dir, 1, rng_seed=0)
        trainer = FleetTrainer(cfg, ds, seeds=SEEDS[:2], device="cpu")
        assert trainer._restore_checkpoints()[2] == 1      # epoch 0 is the common step
        assert trainer.lane_checkpointer(1).quarantined_steps() == [1]
        assert trainer.lane_checkpointer(0).quarantined_steps() == []
        st_b, out_b = trainer.fit(resume=True)
        assert [r["epoch"] for r in out_b["history"]] == [1, 2]
        # the replayed epoch 1 replaced the damaged bytes and lifted the mark
        assert trainer.lane_checkpointer(1).verify_step(1) == (True, None)
        assert all(torch.equal(st_a.params[n], st_b.params[n]) for n in st_a.params)

    def test_stacked_gru_lanes_track_their_solo_runs(self, panels, tmp_path):
        """gru_layers = 2: a fleet of 2 seeds runs the lower layers under
        torch.func.vmap; each lane's losses follow its solo Trainer, and
        predict_panel_fleet's lanes follow predict_panel."""
        ds = panels[3]
        cfg = _cfg(panels, tmp_path / "fleet")
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, gru_layers=2))
        st, out = FleetTrainer(cfg, ds, seeds=SEEDS[:2], device="cpu").fit()
        days = ds.split_days(None, None)
        scores = predict_panel_fleet(st.params, cfg, ds, days, stochastic=False)
        for i, seed in enumerate(SEEDS[:2]):
            solo = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, seed=seed, save_dir=str(tmp_path / f"solo{seed}")))
            st_s, o = Trainer(solo, ds, device="cpu").fit()
            for key in ("train_loss", "val_loss"):
                np.testing.assert_allclose([r[key][i] for r in out["history"]],
                                           [r[key] for r in o["history"]], rtol=LOSS_RTOL)
            _assert_params({n: p[i:i + 1] for n, p in st.params.items()},
                           [{n: p.detach() for n, p in st_s.model.named_parameters()}],
                           cfg, len(o["history"]), o["history"][0]["step"])
            want = predict_panel(st_s.model, solo, ds, days, stochastic=False)
            np.testing.assert_allclose(scores[i], want, **SCORE_TOL)

    def test_stack_unstack_round_trip_and_select_best(self, panels, tmp_path):
        ds = panels[3]
        tr = FleetTrainer(_cfg(panels, tmp_path), ds, seeds=SEEDS, device="cpu")
        fleet = tr.init_fleet_state()
        solo = [unstack_state(fleet, i, tr.model_cfg, tr._lane_train_cfg(i), tr.total_steps)
                for i in range(S)]
        again = stack_states(solo)
        assert all(torch.equal(again.params[n], fleet.params[n]) for n in fleet.params)
        assert list(again.counts) == [0] * S and list(again.steps) == [0] * S
        best = {n: torch.zeros_like(p) for n, p in fleet.params.items()}
        new, val = select_best(best, torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64),
                               fleet.params, torch.tensor([1.0, 1.5, np.nan],
                                                          dtype=torch.float64))
        assert val.tolist()[:2] == [1.0, 1.5] and val.tolist()[2] == 3.0
        for n, p in new.items():
            assert (p[0] == 0).all() and torch.equal(p[1], fleet.params[n][1].detach())
            assert (p[2] == 0).all()

    def test_a_poisoned_lane_rolls_back_alone(self, panels, tmp_path):
        """nan_grads on lane 1 at epochs 1 and 2: only lane 1 skips its
        steps and rolls back to its epoch-0 checkpoint; lanes 0 and 2 equal
        an unpoisoned fleet's bitwise."""
        ds = panels[3]
        cfg = _cfg(panels, tmp_path / "clean", checkpoint_every=1, num_epochs=3,
                   recover_after=2)
        st_c, out_c = FleetTrainer(cfg, ds, seeds=SEEDS, device="cpu").fit()
        cfg = _cfg(panels, tmp_path / "sick", checkpoint_every=1, num_epochs=3,
                   recover_after=2)
        logger = MetricsLogger(echo=False)
        plan = chaos.ChaosPlan([chaos.Fault("nan_grads", epoch=1, lane=1),
                                chaos.Fault("nan_grads", epoch=2, lane=1)])
        events = []
        logger.log = lambda event, **kw: events.append((event, kw))
        with chaos.active(plan):
            st_p, out_p = FleetTrainer(cfg, ds, seeds=SEEDS, device="cpu",
                                       logger=logger).fit()
        steps = FleetTrainer(cfg, ds, seeds=SEEDS, device="cpu").steps_per_epoch
        assert [r["skipped_steps"] for r in out_p["history"]] == [
            [0.0] * 3, [0.0, steps, 0.0], [0.0, steps, 0.0]]
        rolls = [kw for e, kw in events if e == "recovery"]
        assert [(r["kind"], r["lane"], r["restored_step"]) for r in rolls] == [
            ("lane_rollback", 1, 0)]
        for n in st_c.params:
            for i in (0, 2):
                assert torch.equal(st_c.params[n][i], st_p.params[n][i])

    def test_mixed_fleet_tracks_its_solo_runs(self, panels, tmp_path):
        """bfloat16 compute over float32 masters, one loss scale per lane;
        one lane equals the mixed `Trainer` bitwise."""
        ds = panels[3]
        cfg = _cfg(panels, tmp_path / "fleet")
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                 compute_dtype="bfloat16"))
        _, out = FleetTrainer(cfg, ds, seeds=SEEDS[:2], device="cpu").fit()
        for i, seed in enumerate(SEEDS[:2]):
            solo = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, seed=seed, save_dir=str(tmp_path / f"solo{seed}")))
            _, o = Trainer(solo, ds, device="cpu").fit()
            np.testing.assert_allclose([r["train_loss"][i] for r in out["history"]],
                                       [r["train_loss"] for r in o["history"]], rtol=1e-4)
            assert [r["loss_scale"][i] for r in out["history"]] == [
                r["loss_scale"] for r in o["history"]]
        _, one = FleetTrainer(cfg, ds, seeds=[SEEDS[0]], device="cpu").fit()
        solo = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, seed=SEEDS[0], save_dir=str(tmp_path / f"solo{SEEDS[0]}")))
        _, o = Trainer(solo, ds, device="cpu").fit()
        assert [r["train_loss"] for r in one["history"]] == [[r["train_loss"]]
                                                             for r in o["history"]]


class TestRescaleSchedule:
    def test_matches_the_jax_trainer(self, panels, tmp_path):
        """fit(num_epochs=1, rescale_schedule=True) decays the cosine to its
        floor at the end of that epoch; a later fit without it goes back to
        the config's horizon; num_epochs=0 trains nothing
        (`tests/test_train.py` of the JAX package)."""
        jp, _, jds, ds = panels
        jcfg = _jcfg(jp, tmp_path / "jax")
        jtr = JTrainer(jcfg, jds, logger=JMetricsLogger(echo=False))
        _, jout1 = jtr.fit(num_epochs=1, rescale_schedule=True)
        tr = Trainer(_port(jcfg, tmp_path / "port"), ds, device="cpu")
        assert tr.total_steps == tr.steps_per_epoch * 2
        state, out1 = tr.fit(num_epochs=1, rescale_schedule=True)
        assert tr.total_steps == tr.steps_per_epoch == jtr.steps_per_epoch
        assert len(out1["history"]) == 1 and out1["history"][-1]["lr"] < jcfg.train.lr * 1e-6
        _, out2 = tr.fit()
        assert tr.total_steps == tr.steps_per_epoch * 2 and out2["history"][0]["lr"] > 0
        np.testing.assert_allclose([r["lr"] for r in out1["history"]],
                                   [r["lr"] for r in jout1["history"]], rtol=1e-6, atol=1e-12)
        assert [r["step"] for r in out1["history"]] == [r["step"] for r in jout1["history"]]
        assert [r["lr"] for r in out2["history"]] == [
            learning_rate_at(tr.cfg.train, tr.total_steps, tr.steps_per_epoch * (e + 1))
            for e in range(2)]
        # a state made for the config's horizon follows the new one
        st = tr.init_state()
        _, out3 = tr.fit(state=st, num_epochs=1, rescale_schedule=True)
        assert out3["history"][-1]["lr"] == out1["history"][-1]["lr"]
        state0, out0 = Trainer(_port(jcfg, tmp_path / "zero"), ds, device="cpu").fit(
            num_epochs=0)
        assert out0["history"] == [] and state0.step == 0


# ---- the CLI ------------------------------------------------------------------


@pytest.fixture(scope="module")
def pickle_path(panels, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "panel.pkl")
    jpanel_to_frame(panels[0]).to_pickle(path)
    return path


def _argv(panels, pickle_path, out, *extra):
    d = [str(x.date()) for x in panels[0].dates]
    return ["--dataset", pickle_path, "--num_latent", str(C), "--hidden_size", str(H),
            "--num_factor", str(K), "--num_portfolio", str(M), "--seq_len", str(T),
            "--start_time", d[0], "--fit_end_time", d[19], "--val_start_time", d[20],
            "--val_end_time", d[29], "--score_start", d[5], "--score_end", d[29],
            "--num_epochs", "2", "--lr", "1e-3", "--seed", "3", "--run_name", "fl",
            "--recon_loss", "nll", "--deterministic_scores", "--device", "cpu",
            "--save_dir", f"{out}/models", "--score_dir", f"{out}/scores",
            "--metrics_jsonl", f"{out}/run.jsonl", *extra]


def _events(out, name):
    with open(os.path.join(out, "run.jsonl")) as fh:
        return [e for e in map(json.loads, fh) if e["event"] == name]


class TestCli:
    def test_fleet_seeds_picks_the_winner_and_score_only_agrees(self, panels, pickle_path,
                                                                tmp_path):
        out = str(tmp_path)
        assert cli.main(_argv(panels, pickle_path, out, "--fleet_seeds", "3",
                              "--backtest")) == 0
        sweep_ev, = _events(out, "fleet_sweep")
        seeds = [e["seed"] for e in _events(out, "sweep_seed")]
        assert sweep_ev["seeds"] == seeds == [3, 4, 5]
        ics = {e["seed"]: e["rank_ic"] for e in _events(out, "sweep_seed")}
        assert sweep_ev["best_seed"] == max(ics, key=ics.get)
        scores, = _events(out, "scores")
        assert os.path.exists(scores["path"])
        assert _events(out, "backtest")
        assert np.isclose(scores["rank_ic"], ics[sweep_ev["best_seed"]], rtol=1e-6)
        # --score_only on the winning seed reads its best weights
        again = str(tmp_path / "again")
        argv = _argv(panels, pickle_path, again, "--score_only")
        argv[argv.index("--seed") + 1] = str(sweep_ev["best_seed"])
        argv[argv.index("--save_dir") + 1] = f"{out}/models"
        assert cli.main(argv) == 0
        assert _events(again, "scores")[0]["rank_ic"] == scores["rank_ic"]

    def test_hyper_grid_picks_the_winner(self, panels, pickle_path, tmp_path):
        out = str(tmp_path)
        assert cli.main(_argv(panels, pickle_path, out, "--hyper_grid",
                              "1e-3:1,3e-3:0.1")) == 0
        hyper, = _events(out, "hyper_grid")
        points = {e["label"]: e["rank_ic"] for e in _events(out, "grid_point")}
        assert hyper["points"] == ["lr0.001_kl1", "lr0.003_kl0.1"] == list(points)
        assert hyper["best_label"] == max(points, key=points.get)
        scores, = _events(out, "scores")
        assert f"fl_{hyper['best_label']}" in os.path.basename(scores["path"])
        assert np.isclose(scores["rank_ic"], points[hyper["best_label"]], rtol=1e-6)
        assert cli.main(_argv(panels, pickle_path, str(tmp_path / "bad"),
                              "--hyper_grid", ",")) == 2
