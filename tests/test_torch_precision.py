"""The port's precision ladder against the JAX package on the CPU: int8
weight-only quantization, bfloat16 and int8 scoring, the mixed-cast kernel
boundaries, the training dtype's resolution, the dynamic loss scale, mixed
training against the JAX `Trainer`, mixed resume, and the registry's
precision keys; then the refusals of this slice (a hidden size above the
kernels' maximum on a CUDA device, config knobs the port does not port).

Shapes: C 8, T 5, H 8, K 4, M 6 (`tests/test_mixed.py`), on synthetic
panels with missing rows. Weights from the JAX `load_model` or `Trainer`,
carried across with `flax_to_torch`. The JAX side runs its Pallas kernels in
interpret mode (`use_pallas_*=True`). Tolerances:

- int8: `q` and `s` bitwise; int8 scores at rtol 1e-5 / atol 1e-6 (the
  compute is float32).
- bfloat16 scores: the port's distance from JAX-bf16 at most half of
  JAX-bf16's distance from JAX-f32 (max abs; read 6e-8 against 3.5e-4 on the
  serving rig), and at most BF16_SCORE_ATOL; per-day Spearman >= 0.999.
- the kernel boundaries under the mixed cast: gradients at rtol 2e-5 /
  atol 5e-6. A port that lets autograd round the kernels' float32 weight
  gradients to bfloat16 (the naive cast) misses that by orders of
  magnitude; the test shows it does.
- the GRU layer's input-projection bias: rtol 2^-5 (4 bfloat16 ulps; XLA
  reduces its bfloat16 cotangent in bfloat16, the port in float32; read 2
  ulps).
- mixed training: the loss scale and the skipped counts equal JAX's step
  for step; each step's loss at rtol 1e-3 (read 8.6e-5 over 12 steps: a
  bfloat16 rounding that XLA's fusions keep and the port's ops drop, or the
  other way round, moves a step's gradient by an ulp, and Adam carries it
  on), the per-epoch losses at rtol 1e-4 (read 4e-7 over 3 epochs).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.eval.predict import predict_panel as jpredict_panel
from factorvae_tpu.models.factorvae import load_model as jload_model
from factorvae_tpu.models.layers import GRU as JGRU
from factorvae_tpu.ops import quant as jquant
from factorvae_tpu.ops.pallas.attention_grad import fused_attention
from factorvae_tpu.train.loop import make_step_fns
from factorvae_tpu.train.state import cast_compute as jcast_compute
from factorvae_tpu.train.state import resolve_train_dtype as jresolve_train_dtype
from factorvae_tpu.train.trainer import Trainer as JTrainer
from factorvae_tpu.utils.logging import MetricsLogger as JMetricsLogger
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.eval.predict import predict_panel
from factorvae_tpu_torch.models.factorvae import FactorVAE, load_model
from factorvae_tpu_torch.models.layers import GRU
from factorvae_tpu_torch.ops import quant
from factorvae_tpu_torch.ops.kernels import MAX_HIDDEN
from factorvae_tpu_torch.ops.kernels.attention import attention
from factorvae_tpu_torch.params import flax_to_torch
from factorvae_tpu_torch.serve.registry import (
    PRECISIONS,
    ModelRegistry,
    RegistryError,
    precision_config,
)
from factorvae_tpu_torch.train.loop import train_step
from factorvae_tpu_torch.train.state import cast_compute, resolve_train_dtype
from factorvae_tpu_torch.train.trainer import Trainer

C, T, H, K, M = 8, 5, 8, 4, 6
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_SCORE_ATOL = 1e-5
GRAD_TOL = dict(rtol=2e-5, atol=5e-6)
BF16_BIAS_RTOL = 2 ** -5          # 4 bfloat16 ulps
MIXED_STEP_RTOL = 1e-3
MIXED_EPOCH_RTOL = 1e-4


def _spearman(a, b) -> float:
    ra, rb = np.argsort(np.argsort(a)), np.argsort(np.argsort(b))
    return float(np.corrcoef(ra, rb)[0, 1])


def _jmodel(**kw) -> jconfig.ModelConfig:
    return jconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                               num_portfolios=M, seq_len=T, use_pallas_gru=True,
                               use_pallas_attention=True, **kw)


def _port(jcfg: jconfig.Config, **train) -> tconfig.Config:
    cfg = tconfig.Config.from_dict(jcfg.to_dict())
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


@pytest.fixture(scope="module")
def rig():
    jp = synthetic_panel(num_days=30, num_instruments=13, num_features=C,
                         missing_prob=0.15, seed=2)
    tp = Panel(values=jp.values, valid=jp.valid,
               dates=jp.dates.values.astype("datetime64[D]"),
               instruments=np.asarray(jp.instruments))
    jcfg = jconfig.Config(model=_jmodel(), data=jconfig.DataConfig(seq_len=T))
    _, params = jload_model(jcfg, n_max=8)
    tcfg = tconfig.Config.from_dict(jcfg.to_dict())
    model = FactorVAE(tcfg.model)
    model.load_state_dict(flax_to_torch(params))
    return dict(jcfg=jcfg, params=params, tcfg=tcfg, model=model.eval(),
                jds=JPanelDataset(jp, seq_len=T),
                tds=PanelDataset(tp, seq_len=T, device="cpu"))


def _at(cfg, dtype):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype))


# ---------------------------------------------------------------------------
# ops/quant.py


def _jax_leaves(tree) -> dict:
    """name -> JAX QTensor or array, named as the port's state_dict."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jquant.QTensor))[0]
    out = {}
    for path, leaf in flat:
        keys = [str(getattr(p, "key", p)) for p in path][2:]       # params/model
        if keys[-2:-1] == ["Dense_0"]:
            keys = keys[:-2] + ["weight" if keys[-1] == "kernel" else "bias"]
        elif keys[-2:-1] == ["LayerNorm_0"]:
            keys = keys[:-2] + ["layer_norm", "weight" if keys[-1] == "scale" else "bias"]
        out[".".join(keys)] = leaf
    return out


class TestQuantization:
    @pytest.mark.parametrize("min_size", [1, 64, 256, 10 ** 6])
    def test_q_and_s_bitwise_jax(self, rig, min_size):
        """Every quantized parameter's q and s equal JAX's (transposed for a
        Dense, whose port layout is (out, in)); the same parameters stay
        float, the role exclusion (bias, query) and min_size included."""
        got = quant.quantize_params(rig["model"], min_size=min_size)
        want = _jax_leaves(jquant.quantize_params(rig["params"], min_size=min_size))
        assert set(got) == set(want)
        q_got = {k for k, v in got.items() if isinstance(v, quant.QTensor)}
        assert q_got == {k for k, v in want.items() if isinstance(v, jquant.QTensor)}
        assert not any("bias" in k or "query" in k for k in q_got)
        if min_size == 10 ** 6:
            assert q_got == set()
        for name in q_got:
            g, w = got[name], want[name]
            wq, ws = np.asarray(w.q), np.asarray(w.s)
            if name.endswith("weight"):
                wq, ws = wq.T, ws.T
            assert g.q.dtype == torch.int8 and g.s.dtype == torch.float32
            assert np.array_equal(g.q.numpy(), wq), name
            assert np.array_equal(g.s.numpy(), ws), name
            assert g.q.shape == rig["model"].state_dict()[name].shape

    def test_the_3d_stack_scales_per_last_axis_channel(self, rig):
        qp = quant.quantize_params(rig["model"], min_size=1)
        for name in ("factor_predictor.key_kernel", "factor_predictor.value_kernel"):
            assert tuple(qp[name].s.shape) == (1, 1, H)
        assert tuple(qp["feature_extractor.proj.weight"].s.shape) == (C, 1)
        assert tuple(qp["feature_extractor.gru.hidden_kernel"].s.shape) == (1, 3 * H)
        w = rig["model"].state_dict()["factor_predictor.key_kernel"]
        err = (qp["factor_predictor.key_kernel"].dequantize() - w).abs()
        assert float((err / qp["factor_predictor.key_kernel"].s).max()) <= 0.5 + 1e-6

    def test_idempotent_dequantize_and_bytes(self, rig):
        qp = quant.ensure_quantized(rig["model"], min_size=64)
        assert quant.is_quantized(qp) and quant.ensure_quantized(qp) is qp
        assert not quant.is_quantized(rig["model"].state_dict())
        dense = quant.dequantize_params(qp, torch.bfloat16)
        jdense = jax.tree_util.tree_leaves(jquant.dequantize_params(
            jquant.ensure_quantized(rig["params"], min_size=64), jnp.bfloat16))
        assert sorted(str(t.dtype).split(".")[-1] for t in dense.values()) == \
            sorted(str(x.dtype) for x in jdense)
        want = _jax_leaves(jquant.dequantize_params(
            jquant.quantize_params(rig["params"], min_size=64), jnp.bfloat16))
        for name, t in dense.items():
            w = np.asarray(want[name].astype(jnp.float32))
            assert np.array_equal(t.float().numpy(), w.T if name.endswith("weight")
                                  and t.ndim == 2 else w), name
        assert quant.tree_nbytes(qp) == jquant.tree_nbytes(
            jquant.quantize_params(rig["params"], min_size=64))
        assert quant.tree_nbytes(rig["model"]) == jquant.tree_nbytes(rig["params"])


# ---------------------------------------------------------------------------
# bfloat16 and int8 scoring


class TestPrecisionScoring:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_int8_scores_match_jax(self, rig, dtype):
        days = rig["tds"].split_days(None, None)
        want = jpredict_panel(rig["params"], _at(rig["jcfg"], dtype), rig["jds"], days,
                              stochastic=False, int8=True)
        got = predict_panel(rig["model"], _at(rig["tcfg"], dtype), rig["tds"], days,
                            stochastic=False, int8=True)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, **SCORE_TOL)
        f32 = predict_panel(rig["model"], rig["tcfg"], rig["tds"], days, stochastic=False)
        assert np.nanmax(np.abs(got - f32)) > 0         # a rung of its own
        # a quantized tree passes through; the model's own weights stay f32
        qp = quant.quantize_params(rig["model"])
        again = predict_panel(rig["model"], _at(rig["tcfg"], dtype), rig["tds"], days,
                              stochastic=False, int8=True, params=qp)
        assert np.array_equal(again, got, equal_nan=True)
        assert all(p.dtype == torch.float32 for p in rig["model"].parameters())

    def test_bf16_scores_within_half_the_rung_distance(self, rig):
        days = rig["tds"].split_days(None, None)
        jf32 = jpredict_panel(rig["params"], rig["jcfg"], rig["jds"], days, stochastic=False)
        jbf16 = jpredict_panel(rig["params"], _at(rig["jcfg"], "bfloat16"), rig["jds"], days,
                               stochastic=False)
        got = predict_panel(rig["model"], _at(rig["tcfg"], "bfloat16"), rig["tds"], days,
                            stochastic=False)
        valid = ~np.isnan(jf32)
        assert np.array_equal(np.isnan(got), ~valid)
        rung = float(np.abs(jbf16 - jf32)[valid].max())
        dist = float(np.abs(got - jbf16)[valid].max())
        assert rung > 0
        assert dist <= 0.5 * rung and dist <= BF16_SCORE_ATOL, (dist, rung)
        for d in range(len(days)):
            v = valid[d]
            assert _spearman(got[d, v], jbf16[d, v]) >= 0.999
        assert all(p.dtype == torch.float32 for p in rig["model"].parameters())


# ---------------------------------------------------------------------------
# the kernel boundaries under the mixed cast (fact: JAX does not round the
# kernels' float32 gradients to bfloat16)


def _naive(params: dict) -> dict:
    """The cast a naive port would make: every parameter to bf16, leaving
    autograd to round the kernels' f32 gradients to the input's dtype."""
    return {k: v.to(torch.bfloat16) for k, v in params.items()}


class TestMixedKernelBoundaries:
    def test_gru_layer_gradients_match_jax(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((12, T, C)).astype(np.float32)
        layer = JGRU(H, dtype=jnp.bfloat16, use_pallas=True)
        params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))

        def jloss(p):
            h = layer.apply(jcast_compute(p, jnp.bfloat16), jnp.asarray(x))
            return jnp.sum(h.astype(jnp.float32) ** 2)

        jgrads = flax_to_torch(jax.jit(jax.grad(jloss))(params)["params"])
        port = GRU(C, H, dtype=torch.bfloat16)
        port.load_state_dict(flax_to_torch(params["params"]))

        def grads(cast):
            port.zero_grad()
            h = torch.func.functional_call(port, cast(port), (torch.from_numpy(x),))
            (h.float() ** 2).sum().backward()
            return {k: p.grad.clone() for k, p in port.named_parameters()}

        got = grads(lambda m: cast_compute(m, torch.bfloat16))
        for name, g in got.items():
            assert g.dtype == torch.float32
            # XLA reduces the input projection's bias cotangent in bfloat16,
            # the port in float32: they differ by a few bfloat16 ulps
            tol = dict(rtol=BF16_BIAS_RTOL) if name == "input_proj.bias" else GRAD_TOL
            np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), **tol, err_msg=name)
        # the kernel's weight gradients are not bf16-representable, as in JAX
        wh = got["hidden_kernel"]
        assert not torch.equal(wh, wh.to(torch.bfloat16).float())
        naive = grads(lambda m: _naive(dict(m.named_parameters())))["hidden_kernel"]
        assert torch.equal(naive, naive.to(torch.bfloat16).float())
        err = float((naive - jgrads["hidden_kernel"]).abs().max())
        assert err > 10 * (GRAD_TOL["atol"] + GRAD_TOL["rtol"]
                           * float(jgrads["hidden_kernel"].abs().max()))

    def test_attention_gradients_match_jax(self):
        rng = np.random.default_rng(3)
        n = 11
        latent = rng.standard_normal((n, H)).astype(np.float32)
        mask = np.ones(n, np.float32)
        mask[-3:] = 0
        ws = {"query": rng.standard_normal((K, H)),
              "key_kernel": rng.uniform(-0.4, 0.4, (K, H, H)),
              "key_bias": rng.uniform(-0.4, 0.4, (K, H)),
              "value_kernel": rng.uniform(-0.4, 0.4, (K, H, H)),
              "value_bias": rng.uniform(-0.4, 0.4, (K, H))}
        ws = {k: v.astype(np.float32) for k, v in ws.items()}
        names = list(ws)

        def jloss(lat, *w):
            ctx = fused_attention(lat, jnp.asarray(mask), *[a.astype(jnp.bfloat16) for a in w],
                                  None)
            return jnp.sum(ctx ** 2)

        jgrads = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
            jnp.asarray(latent), *[jnp.asarray(ws[k]) for k in names])
        model = FactorVAE(tconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                              num_portfolios=M, seq_len=T))
        pred = model.factor_predictor
        with torch.no_grad():
            for k in names:
                getattr(pred, k).copy_(torch.from_numpy(ws[k]))
        lat = torch.from_numpy(latent).requires_grad_()

        def run(cast):
            pred.zero_grad()
            lat.grad = None
            w = cast(pred)
            ctx = attention(lat[None], torch.from_numpy(mask > 0)[None],
                            *[w[k] for k in names])
            (ctx ** 2).sum().backward()
            return [lat.grad.clone()] + [getattr(pred, k).grad.clone() for k in names]

        got = run(lambda m: cast_compute(m, torch.bfloat16))
        for name, g, w in zip(["latent"] + names, got, jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL, err_msg=name)
        naive = run(lambda m: _naive(dict(m.named_parameters())))[2]       # key_kernel
        want = np.asarray(jgrads[2])
        assert float(np.abs(naive.numpy() - want).max()) > 10 * (
            GRAD_TOL["atol"] + GRAD_TOL["rtol"] * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# train/state.py: the training dtype


class TestResolveTrainDtype:
    def test_train_knob_wins_none_inherits(self):
        bf16 = tconfig.ModelConfig(compute_dtype="bfloat16")
        cases = [(tconfig.TrainConfig(), bf16, "bfloat16"),
                 (tconfig.TrainConfig(compute_dtype="float32"), bf16, "float32"),
                 (tconfig.TrainConfig(compute_dtype="bfloat16"), tconfig.ModelConfig(),
                  "bfloat16"),
                 (tconfig.TrainConfig(), tconfig.ModelConfig(), "float32")]
        for train, model, want in cases:
            assert resolve_train_dtype(train, model) == want
            assert jresolve_train_dtype(
                jconfig.TrainConfig(compute_dtype=train.compute_dtype),
                jconfig.ModelConfig(compute_dtype=model.compute_dtype)) == want

    def test_serving_rungs_rejected_loudly(self):
        with pytest.raises(ValueError, match="serv"):
            resolve_train_dtype(tconfig.TrainConfig(compute_dtype="int8"),
                                tconfig.ModelConfig())
        with pytest.raises(ValueError, match="compute_dtype"):
            tconfig.ModelConfig(compute_dtype="int8")
        with pytest.raises(ValueError, match="loss scale"):
            tconfig.TrainConfig(loss_scale_backoff=2.0)


# ---------------------------------------------------------------------------
# mixed training


@pytest.fixture(scope="module")
def panels():
    jp = synthetic_panel(num_days=20, num_instruments=6, num_features=C,
                         missing_prob=0.1, seed=0)
    tp = Panel(values=jp.values, valid=jp.valid,
               dates=jp.dates.values.astype("datetime64[D]"),
               instruments=np.asarray(jp.instruments))
    return jp, tp


def _jmixed(tp, tmp_path, epochs=2, model_dtype="bfloat16", deterministic=True,
            **train) -> jconfig.Config:
    d = [str(x) for x in tp.dates]
    model = dict(dropout_rate=0.0, recon_loss="nll") if deterministic else {}
    kw = dict(num_epochs=epochs, lr=1e-3, seed=0, checkpoint_every=0, recover_after=0,
              save_dir=str(tmp_path / "jax"))
    kw.update(train)
    return jconfig.Config(
        model=_jmodel(compute_dtype=model_dtype, **model),
        data=jconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[12],
                                val_start_time=d[13], val_end_time=d[19]),
        train=jconfig.TrainConfig(**kw))


class TestLossScale:
    def _rig(self, tp, tmp_path, **train):
        cfg = _port(_jmixed(tp, tmp_path, **train), save_dir=str(tmp_path / "port"))
        tr = Trainer(cfg, PanelDataset(tp, seq_len=T, device="cpu"), device="cpu")
        t = cfg.train
        knobs = dict(compute_dtype=torch.bfloat16, loss_scale_cfg=(
            t.loss_scale_growth, t.loss_scale_backoff, t.loss_scale_growth_interval,
            t.loss_scale_floor))
        return tr, tr.init_state(), torch.tensor([0]), knobs, t

    def test_overflow_skips_keeps_params_and_backs_off(self, panels, tmp_path):
        tr, state, days, knobs, tc = self._rig(panels[1], tmp_path)
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        aux = train_step(state, tr.ds, days, guard=False, poison=True, **knobs)
        assert float(aux["skipped"]) == 1.0 and state.step == 1
        assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
        assert state.optimizer.state_dict()["state"] == {}
        assert state.scheduler.last_epoch == 0
        assert state.loss_scale == tc.loss_scale_init * tc.loss_scale_backoff
        assert state.good_steps == 0

    def test_clean_step_updates_and_grows_at_interval(self, panels, tmp_path):
        tr, state, days, knobs, tc = self._rig(panels[1], tmp_path,
                                               loss_scale_growth_interval=1)
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        aux = train_step(state, tr.ds, days, guard=False, **knobs)
        assert float(aux["skipped"]) == 0.0
        assert any(not torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
        assert state.loss_scale == tc.loss_scale_init * tc.loss_scale_growth
        assert state.good_steps == 0
        assert all(p.dtype == torch.float32 for p in state.model.parameters())

    def test_backoff_clamps_at_floor(self, panels, tmp_path):
        tr, state, days, knobs, tc = self._rig(panels[1], tmp_path)
        state.loss_scale = np.float32(tc.loss_scale_floor)
        train_step(state, tr.ds, days, guard=False, poison=True, **knobs)
        assert state.loss_scale == tc.loss_scale_floor

    def test_walk_equals_jax_step_for_step(self, panels, tmp_path):
        """The same poison schedule through the JAX step and the port's:
        equal scales, good-step counts and skips at every step, and losses
        within MIXED_STEP_RTOL."""
        jp, tp = panels
        jcfg = _jmixed(tp, tmp_path, loss_scale_init=64.0, loss_scale_growth_interval=2,
                       loss_scale_floor=16.0)
        jtr = JTrainer(jcfg, JPanelDataset(jp, seq_len=T), logger=JMetricsLogger(echo=False))
        t = jcfg.train
        ls_cfg = (t.loss_scale_growth, t.loss_scale_backoff, t.loss_scale_growth_interval,
                  t.loss_scale_floor)
        fns = make_step_fns(jtr.model, jtr.model_eval, jtr.tx, T,
                            inject_nan=True, compute_dtype="bfloat16",
                            loss_scale_cfg=ls_cfg)
        jstep = jax.jit(fns.train_step)
        jstate = jtr.init_state()
        weights = flax_to_torch(jstate.params)
        tr = Trainer(_port(jcfg, save_dir=str(tmp_path / "port")),
                     PanelDataset(tp, seq_len=T, device="cpu"), device="cpu")
        state = tr.init_state()
        state.model.load_state_dict(weights)
        schedule = [0, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 0]
        order = tr._order(tr.train_days, True, 0)
        for i, poisoned in enumerate(schedule):
            days = order[i % order.shape[0]]
            jstate, jaux = jstep(jstate, jnp.asarray(days.numpy(), jnp.int32),
                                          jtr.panel_args(),
                                          jnp.float32(np.nan if poisoned else 1.0))
            aux = train_step(state, tr.ds, days, guard=True, poison=bool(poisoned),
                             compute_dtype=torch.bfloat16, loss_scale_cfg=ls_cfg)
            assert float(aux["skipped"]) == float(jaux["skipped"]) == poisoned, i
            assert state.loss_scale == float(jstate.loss_scale), i
            assert state.good_steps == int(jstate.good_steps), i
            np.testing.assert_allclose(float(aux["loss_sum"]), float(jaux["loss_sum"]),
                                       rtol=MIXED_STEP_RTOL, err_msg=str(i))
        assert float(jstate.loss_scale) != t.loss_scale_init


class TestMixedTrainer:
    def test_tracks_the_jax_mixed_trainer(self, panels, tmp_path):
        """Three mixed epochs from the same weights, with nan_grads at
        epoch 1: per-epoch losses within MIXED_EPOCH_RTOL, the loss scale,
        its floor steps and the skipped counts equal; the masters and
        Adam's moments stay float32."""
        from factorvae_tpu import chaos as jchaos
        from factorvae_tpu_torch import chaos

        jp, tp = panels
        jcfg = _jmixed(tp, tmp_path, epochs=3, loss_scale_growth_interval=4)
        # the JAX Trainer compiles its chaos trace only if a plan is
        # installed when it is built
        with jchaos.active(jchaos.ChaosPlan([jchaos.Fault("nan_grads", epoch=1)])):
            jtr = JTrainer(jcfg, JPanelDataset(jp, seq_len=T),
                           logger=JMetricsLogger(echo=False))
            jstate = jtr.init_state()
            weights = flax_to_torch(jstate.params)
            _, jout = jtr.fit(state=jstate)
        tr = Trainer(_port(jcfg, save_dir=str(tmp_path / "port")),
                     PanelDataset(tp, seq_len=T, device="cpu"), device="cpu")
        assert tr.mixed and tr.model_cfg.compute_dtype == "bfloat16"
        state = tr.init_state()
        state.model.load_state_dict(weights)
        with chaos.active(chaos.ChaosPlan([chaos.Fault("nan_grads", epoch=1)])):
            state, out = tr.fit(state=state)
        got, want = out["history"], jout["history"]
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want],
                                       rtol=MIXED_EPOCH_RTOL, err_msg=key)
        for key in ("skipped_steps", "loss_scale", "loss_scale_floor_steps", "step"):
            assert [r[key] for r in got] == [r[key] for r in want], key
        assert got[1]["skipped_steps"] == tr.steps_per_epoch
        assert all(p.dtype == torch.float32 for p in state.model.parameters())
        for st in state.optimizer.state_dict()["state"].values():
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32

    def test_mixed_rollback_trail_matches_jax(self, panels, tmp_path):
        """nan_grads at epochs 1 and 2 of 4: each poisoned epoch skips every
        step, past the mixed skip budget (steps // interval + 1), so the
        streak rolls back to epoch 0 at half the lr, in both packages."""
        from factorvae_tpu import chaos as jchaos
        from factorvae_tpu_torch import chaos

        jp, tp = panels
        jcfg = _jmixed(tp, tmp_path, epochs=4, checkpoint_every=1, recover_after=2)
        with jchaos.active(jchaos.ChaosPlan([jchaos.Fault("nan_grads", epoch=e)
                                             for e in (1, 2)])):
            jtr = JTrainer(jcfg, JPanelDataset(jp, seq_len=T),
                           logger=JMetricsLogger(echo=False))
            jstate = jtr.init_state()
            weights = flax_to_torch(jstate.params)
            _, jout = jtr.fit(state=jstate)
        tr = Trainer(_port(jcfg, save_dir=str(tmp_path / "port")),
                     PanelDataset(tp, seq_len=T, device="cpu"), device="cpu")
        state = tr.init_state()
        state.model.load_state_dict(weights)
        with chaos.active(chaos.ChaosPlan([chaos.Fault("nan_grads", epoch=e)
                                           for e in (1, 2)])):
            _, out = tr.fit(state=state)
        got, want = out["history"], jout["history"]
        assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1, 2, 1, 2, 3]
        for key in ("skipped_steps", "loss_scale", "step"):
            assert [r[key] for r in got] == [r[key] for r in want], key
        np.testing.assert_allclose([r["train_loss"] for r in got],
                                   [r["train_loss"] for r in want], rtol=MIXED_EPOCH_RTOL)

    def test_execution_layout_and_f32_default(self, panels, tmp_path):
        from factorvae_tpu_torch.utils.logging import MetricsLogger

        _, tp = panels
        events = []
        logger = MetricsLogger(echo=False)
        logger.log = lambda name, **kw: events.append((name, kw))
        cfg = _port(_jmixed(tp, tmp_path), save_dir=str(tmp_path / "p"))
        Trainer(cfg, PanelDataset(tp, seq_len=T, device="cpu"), device="cpu", logger=logger)
        f32 = _port(_jmixed(tp, tmp_path, model_dtype="float32"), save_dir=str(tmp_path / "q"))
        tr = Trainer(f32, PanelDataset(tp, seq_len=T, device="cpu"), device="cpu",
                     logger=logger)
        layouts = [kw for name, kw in events if name == "execution_layout"]
        assert [(e["compute_dtype"], e["mixed_precision"]) for e in layouts] == [
            ("bfloat16", True), ("float32", False)]
        # train.async_checkpointing defaults to True: saves go to the writer thread
        assert cfg.train.async_checkpointing and f32.train.async_checkpointing
        assert all(e["checkpoint_saves"] == "async" for e in layouts)
        state = tr.init_state()
        assert state.loss_scale is None and state.good_steps is None


class TestMixedCheckpoints:
    def _trainer(self, tp, tmp_path, name):
        cfg = _port(_jmixed(tp, tmp_path, epochs=3, deterministic=False,
                            checkpoint_every=1, loss_scale_growth_interval=3),
                    save_dir=str(tmp_path / name))
        return Trainer(cfg, PanelDataset(tp, seq_len=T, device="cpu"), device="cpu")

    def test_mixed_resume_bitwise(self, panels, tmp_path):
        """2 mixed epochs + resume == 3 straight, with dropout and the
        sampled MSE; the loss scale and its counter ride the checkpoint."""
        _, tp = panels
        full, full_out = self._trainer(tp, tmp_path, "full").fit()
        self._trainer(tp, tmp_path, "part").fit(num_epochs=2)
        resumed, res_out = self._trainer(tp, tmp_path, "part").fit(resume=True)
        assert [r["epoch"] for r in res_out["history"]] == [2]
        assert res_out["history"][0]["loss_scale"] == full_out["history"][2]["loss_scale"]
        for key in ("train_loss", "val_loss", "lr"):
            assert res_out["history"][0][key] == full_out["history"][2][key]
        assert (resumed.loss_scale, resumed.good_steps, resumed.step) == (
            full.loss_scale, full.good_steps, full.step)
        assert full.loss_scale > 32768.0                           # it grew
        full_sd, res_sd = full.model.state_dict(), resumed.model.state_dict()
        assert all(torch.equal(full_sd[k], res_sd[k]) for k in full_sd)

    def test_mixed_best_weights_load_into_f32_serving(self, panels, tmp_path):
        import os

        _, tp = panels
        tr = self._trainer(tp, tmp_path, "best")
        tr.fit(num_epochs=1)
        best = os.path.join(tr.cfg.train.save_dir, tr.cfg.checkpoint_name())
        f32 = _at(tr.cfg, "float32")
        model = load_model(f32, best, device="cpu")
        assert all(p.dtype == torch.float32 for p in model.parameters())
        days = tr.ds.split_days(None, None)
        scores = predict_panel(model, f32, tr.ds, days, stochastic=False)
        assert np.isfinite(scores[tr.ds.valid[days]]).all()


# ---------------------------------------------------------------------------
# the registry's precision ladder


class TestRegistryPrecision:
    def test_keys_bytes_and_scores(self, rig):
        reg = ModelRegistry(device="cpu")
        keys = {p: reg.admit(rig["model"], rig["tcfg"], alias=p, precision=p)
                for p in PRECISIONS}
        base = keys["float32"]
        assert keys["bfloat16"] == base + ":bfloat16" and keys["int8"] == base + ":int8"
        desc = {e["precision"]: e for e in reg.stats()["entries"]}
        assert set(desc) == set(PRECISIONS)
        assert desc["bfloat16"]["nbytes"] == desc["float32"]["nbytes"]
        assert desc["int8"]["nbytes"] == quant.tree_nbytes(quant.quantize_params(rig["model"]))
        assert desc["int8"]["nbytes"] < desc["float32"]["nbytes"]
        assert reg.get("int8").model.feature_extractor.proj.weight.is_meta
        days = rig["tds"].split_days(None, None)[:6]
        for p in PRECISIONS:
            got = reg.score(reg.get(p), rig["tds"], days)
            want = predict_panel(rig["model"], precision_config(rig["tcfg"], p), rig["tds"],
                                 days, stochastic=False, int8=p == "int8")
            assert np.array_equal(got, want, equal_nan=True), p
        assert precision_config(rig["tcfg"], "int8").model.compute_dtype == "float32"
        with pytest.raises(RegistryError, match="precision"):
            reg.admit(rig["model"], rig["tcfg"], precision="fp8")


# ---------------------------------------------------------------------------
# refusals


class TestRefusals:
    def test_hidden_above_the_kernels_max_on_cuda(self, panels, tmp_path):
        _, tp = panels
        wide = _port(_jmixed(tp, tmp_path), save_dir=str(tmp_path / "w"))
        wide = dataclasses.replace(wide, model=dataclasses.replace(
            wide.model, hidden_size=MAX_HIDDEN + 32))
        ds = PanelDataset(tp, seq_len=T, device="cpu")
        with pytest.raises(ValueError, match="Limits"):
            Trainer(wide, ds, device="cuda")
        model = FactorVAE(wide.model)
        with pytest.raises(RegistryError, match="Limits"):
            ModelRegistry(device="cuda").admit(model, wide)
        # the CPU takes any hidden size
        assert Trainer(wide, ds, device="cpu").model_cfg.hidden_size == MAX_HIDDEN + 32
        ModelRegistry(device="cpu").admit(model, wide)

    @pytest.mark.parametrize("knob,item", [
        (dict(mesh=dict(stock_axis=2)), 12),
        (dict(train=dict(remat="dots")), None)], ids=["mesh_stock", "remat"])
    def test_unported_config_knobs(self, panels, tmp_path, knob, item):
        """A stock mesh is refused naming its ROADMAP item; remat (item 15,
        ported) trains a mixed epoch bitwise the one of remat "none"."""
        _, tp = panels
        base = _port(_jmixed(tp, tmp_path), save_dir=str(tmp_path / "k"))
        cfg = dataclasses.replace(base, **{sec: dataclasses.replace(getattr(base, sec), **kw)
                                           for sec, kw in knob.items()})
        ds = PanelDataset(tp, seq_len=T, device="cpu")
        if item is not None:
            with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}\\)"):
                Trainer(cfg, ds, device="cpu")
            return
        runs = [Trainer(c, ds, device="cpu").fit(num_epochs=1) for c in (base, cfg)]
        (plain, plain_out), (remat, remat_out) = runs
        assert plain_out["history"][0]["train_loss"] == remat_out["history"][0]["train_loss"]
        a, b = plain.model.state_dict(), remat.model.state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert plain.loss_scale == remat.loss_scale

    def test_stream_residency_is_accepted(self, panels, tmp_path):
        """A mixed trainer on a stream-resident dataset streams its epochs
        (bitwise the hbm ones: tests/test_torch_stream.py)."""
        _, tp = panels
        cfg = _port(_jmixed(tp, tmp_path), save_dir=str(tmp_path / "s"))
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, panel_residency="stream", stream_chunk_days=6))
        tr = Trainer(cfg, PanelDataset(tp, seq_len=T, device="cpu", residency="stream"),
                     device="cpu")
        assert tr.stream and tr.mixed and tr.steps_per_chunk == 6 // tr.batch_days

    def test_async_checkpointing_is_accepted(self, panels, tmp_path):
        _, tp = panels
        cfg = _port(_jmixed(tp, tmp_path), save_dir=str(tmp_path / "a"),
                    async_checkpointing=True)
        Trainer(cfg, PanelDataset(tp, seq_len=T, device="cpu"), device="cpu")


# ---------------------------------------------------------------------------
# the CLI


class TestCliPrecision:
    def test_bf16_int8_scores_trains_mixed_and_writes_int8_scores(self, panels, tmp_path):
        import csv
        import json
        import os

        from factorvae_tpu_torch import cli
        from factorvae_tpu_torch.data.panel import panel_to_frame

        _, tp = panels
        pkl = str(tmp_path / "panel.pkl")
        panel_to_frame(tp).to_pickle(pkl)
        d = [str(x) for x in tp.dates]
        argv = ["--dataset", pkl, "--num_latent", str(C), "--hidden_size", str(H),
                "--num_factor", str(K), "--num_portfolio", str(M), "--seq_len", str(T),
                "--start_time", d[0], "--fit_end_time", d[12], "--val_start_time", d[13],
                "--val_end_time", d[19], "--score_start", d[5], "--score_end", d[19],
                "--num_epochs", "2", "--lr", "1e-3", "--seed", "1",
                "--save_dir", str(tmp_path / "models"), "--score_dir", str(tmp_path / "scores"),
                "--metrics_jsonl", str(tmp_path / "run.jsonl"), "--deterministic_scores",
                "--device", "cpu", "--bf16", "--int8_scores"]
        assert cli.main(argv) == 0
        with open(tmp_path / "run.jsonl") as fh:
            events = [json.loads(line) for line in fh]
        (layout,) = [e for e in events if e["event"] == "execution_layout"]
        assert layout["compute_dtype"] == "bfloat16" and layout["mixed_precision"]
        epochs = [e for e in events if e["event"] == "epoch"]
        assert len(epochs) == 2 and all(e["loss_scale"] == 32768.0 for e in epochs)
        (scores,) = [e for e in events if e["event"] == "scores"]
        with open(scores["path"], newline="") as fh:
            rows = list(csv.reader(fh))[1:]
        got = np.array([float(r[2]) for r in rows], np.float32)
        cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        assert cfg.model.compute_dtype == "bfloat16"
        ds = PanelDataset(tp, seq_len=T, device="cpu")
        days = ds.split_days(d[5], d[19])
        model = load_model(cfg, os.path.join(cfg.train.save_dir, cfg.checkpoint_name()),
                           device="cpu")
        want = predict_panel(model, cfg, ds, days, int8=True)[ds.valid[days]]
        assert np.array_equal(got, want)
        f32 = predict_panel(model, _at(cfg, "float32"), ds, days)[ds.valid[days]]
        assert not np.array_equal(got, f32)


# ---------------------------------------------------------------------------
# the daemon


@pytest.mark.parametrize("precision", ["bfloat16", "int8", "plan"])
def test_daemon_admits_at_the_precision_flag(precision):
    import json
    import subprocess
    import sys

    reqs = "\n".join([json.dumps({"id": 1, "model": "flagship", "day": 25, "top": 2}),
                      json.dumps({"cmd": "stats"})])
    proc = subprocess.run(
        [sys.executable, "-m", "factorvae_tpu_torch.serve", "--synthetic", "30,10",
         "--device", "cpu", "--precision", precision], input=reqs, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    resp = [json.loads(s) for s in proc.stdout.splitlines()]
    assert resp[0]["ok"] and resp[0]["n"] == 2
    (entry,) = resp[1]["registry"]["entries"]
    want = "float32" if precision == "plan" else precision
    assert entry["precision"] == want
    assert entry["key"].endswith(f":{want}") == (want != "float32")
