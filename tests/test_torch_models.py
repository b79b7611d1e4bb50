"""The port's config, masked ops and model modules against the JAX package.

Weights come from the JAX `load_model` factory and are copied in with
`params.flax_to_torch`; inputs are made with numpy. Every module is run on
the JAX side with its Pallas kernels (interpret mode on the CPU) and with
the XLA path. Tolerance: f32 with rtol=1e-5, atol=1e-6, the repo's
torch-oracle tolerance (tests/test_models.py).
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorvae_tpu import config as jconfig
from factorvae_tpu import presets as jpresets
from factorvae_tpu.models.decoder import FactorDecoder as JDecoder
from factorvae_tpu.models.encoder import FactorEncoder as JEncoder
from factorvae_tpu.models.extractor import FeatureExtractor as JExtractor
from factorvae_tpu.models.factorvae import FactorVAE as JFactorVAE
from factorvae_tpu.models.factorvae import load_model as jload_model
from factorvae_tpu.models.predictor import FactorPredictor as JPredictor
from factorvae_tpu.ops.kl import gaussian_kl_sum as jgaussian_kl_sum
from factorvae_tpu.ops.masked import masked_gaussian_nll as jmasked_gaussian_nll
from factorvae_tpu.ops.masked import masked_mean as jmasked_mean
from factorvae_tpu.ops.masked import masked_mse as jmasked_mse
from factorvae_tpu.ops.masked import masked_softmax as jmasked_softmax
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch import presets as tpresets
from factorvae_tpu_torch.models.factorvae import FactorVAE, load_model
from factorvae_tpu_torch.ops.kl import gaussian_kl_sum
from factorvae_tpu_torch.ops.masked import (
    masked_gaussian_nll,
    masked_mean,
    masked_mse,
    masked_softmax,
)
from factorvae_tpu_torch.params import flax_to_torch, torch_to_flax

TOL = dict(rtol=1e-5, atol=1e-6)
C, T, H, K, M, N, B = 12, 6, 8, 4, 10, 16, 3
PALLAS = pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "xla"])


def _jcfg(pallas: bool) -> jconfig.ModelConfig:
    return jconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                               num_portfolios=M, seq_len=T,
                               use_pallas_gru=pallas, use_pallas_attention=pallas)


@pytest.fixture(scope="module")
def weights():
    """(JAX model-level param tree, the port's FactorVAE with those weights)."""
    _, params = jload_model(jconfig.Config(model=_jcfg(False)), n_max=8)
    tree = params["params"]["model"]
    cfg = tconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                              num_portfolios=M, seq_len=T)
    model = FactorVAE(cfg)
    model.load_state_dict(flax_to_torch(params))
    return tree, model.eval()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, T, C)).astype(np.float32)
    mask = rng.random((B, N)) > 0.2
    mask[:, -2:] = False
    return rng, x, mask


class TestConfig:
    def test_fields_and_defaults_match_the_jax_config(self):
        for jtp, ttp in ((jconfig.ModelConfig, tconfig.ModelConfig),
                         (jconfig.DataConfig, tconfig.DataConfig),
                         (jconfig.TrainConfig, tconfig.TrainConfig),
                         (jconfig.MeshConfig, tconfig.MeshConfig)):
            jd = {f.name: f.default for f in dataclasses.fields(jtp)}
            td = {f.name: f.default for f in dataclasses.fields(ttp)}
            for name in ("use_pallas_attention", "use_pallas_gru"):
                jd.pop(name, None)      # no kernel switch in the port
            assert jd == td

    def test_json_round_trip_and_jax_config_loads(self):
        cfg = tpresets.get_preset("csi300-k60")
        assert tconfig.Config.from_json(cfg.to_json()) == cfg
        jcfg = jpresets.get_preset("csi300-k60")
        loaded = tconfig.Config.from_json(jcfg.to_json())
        assert dataclasses.replace(loaded.model, compute_dtype="float32") == cfg.model
        assert loaded.train == cfg.train and loaded.data == cfg.data
        assert cfg.model.dtype == torch.float32

    def test_presets_have_the_jax_widths(self):
        assert set(tpresets.PRESETS) == set(jpresets.PRESETS)
        for name, cfg in tpresets.PRESETS.items():
            jm = dataclasses.asdict(jpresets.PRESETS[name].model)
            tm = dataclasses.asdict(cfg.model)
            for key in ("num_features", "hidden_size", "num_factors",
                        "num_portfolios", "seq_len"):
                assert jm[key] == tm[key], (name, key)
            assert tm["compute_dtype"] == "float32"
        flag = tpresets.get_preset("flagship").model
        assert (flag.num_features, flag.seq_len, flag.hidden_size,
                flag.num_factors, flag.num_portfolios) == (158, 20, 64, 96, 128)


class TestMaskedOps:
    def test_masked_softmax_and_mean(self, rng):
        x = rng.normal(size=(4, 7)).astype(np.float32)
        mask = rng.random((4, 7)) > 0.3
        mask[2] = False                               # fully masked row
        for dim in (0, 1):
            got = masked_softmax(_t(x), _t(mask), dim=dim).numpy()
            want = np.asarray(jmasked_softmax(jnp.asarray(x), jnp.asarray(mask), axis=dim))
            np.testing.assert_allclose(got, want, **TOL)
        assert (masked_softmax(_t(x), _t(mask), dim=1).numpy()[2] == 0).all()
        for dim in (None, 1):
            np.testing.assert_allclose(
                masked_mean(_t(x), _t(mask), dim=dim).numpy(),
                np.asarray(jmasked_mean(jnp.asarray(x), jnp.asarray(mask), axis=dim)), **TOL)


class TestLosses:
    def test_masked_mse_nll_and_kl_match_jax(self, rng):
        pred, target = (rng.normal(size=(3, 9)).astype(np.float32) for _ in range(2))
        sigma = np.abs(rng.normal(size=(3, 9))).astype(np.float32)
        sigma[0, 0] = 0.0                              # var = eps
        mask = rng.random((3, 9)) > 0.3
        mask[2] = False
        for d in range(3):
            args = (pred[d], target[d], mask[d])
            np.testing.assert_allclose(masked_mse(*map(_t, args)).numpy(),
                                       np.asarray(jmasked_mse(*args)), **TOL)
            nll = (pred[d], sigma[d], target[d], mask[d])
            np.testing.assert_allclose(masked_gaussian_nll(*map(_t, nll)).numpy(),
                                       np.asarray(jmasked_gaussian_nll(*nll)), **TOL)
        np.testing.assert_allclose(
            masked_mse(_t(pred), _t(target), _t(mask), dim=-1).numpy(),
            [float(jmasked_mse(pred[d], target[d], mask[d])) for d in range(3)], **TOL)
        mu1, mu2 = (rng.normal(size=(2, K)).astype(np.float32) for _ in range(2))
        s1, s2 = (np.abs(rng.normal(size=(2, K))).astype(np.float32) + 0.1 for _ in range(2))
        s2[0, 1] = 0.0                                 # the prior-sigma guard
        got = gaussian_kl_sum(*map(_t, (mu1, s1, mu2, s2)), dim=-1).numpy()
        want = [float(jgaussian_kl_sum(mu1[d], s1[d], mu2[d], s2[d])) for d in range(2)]
        np.testing.assert_allclose(got, want, **TOL)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(gaussian_kl_sum(*map(_t, (mu1, s1, mu2, s2))).numpy(),
                                   float(jgaussian_kl_sum(mu1, s1, mu2, s2)), **TOL)


class TestModules:
    @PALLAS
    def test_extractor(self, weights, pallas):
        tree, model = weights
        _, x, _ = _inputs()
        flat = x.reshape(B * N, T, C)
        want = JExtractor(_jcfg(pallas)).apply(
            {"params": tree["feature_extractor"]}, jnp.asarray(flat))
        got = model.feature_extractor(_t(flat)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), **TOL)

    @PALLAS
    def test_extractor_gradient_walks_from_the_forward_residuals(self, weights, pallas,
                                                                 monkeypatch):
        """The extractor's input gradient through the GRU Function, whose
        forward keeps the residuals its backward walks from, against
        jax.grad of the JAX extractor; under no_grad nothing is kept."""
        from factorvae_tpu_torch.ops.kernels import gru as gru_module

        tree, model = weights
        rng, x, _ = _inputs()
        flat = x.reshape(B * N, T, C)
        cot = rng.normal(size=(B * N, H)).astype(np.float32)
        jext = JExtractor(_jcfg(pallas))
        want = jax.grad(lambda a: jnp.sum(jext.apply(
            {"params": tree["feature_extractor"]}, a) * jnp.asarray(cot)))(jnp.asarray(flat))
        calls = []
        real = gru_module.gru_fwd_residuals
        monkeypatch.setattr(gru_module, "gru_fwd_residuals",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        leaf = _t(flat).requires_grad_()
        (got,) = torch.autograd.grad(model.feature_extractor(leaf), leaf, _t(cot))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert calls == [1]
        with torch.no_grad():
            model.feature_extractor(leaf)
        assert calls == [1]

    @PALLAS
    def test_predictor(self, weights, pallas):
        tree, model = weights
        rng, _, mask = _inputs()
        latent = rng.normal(size=(B, N, H)).astype(np.float32)
        mask[1] = False                                 # an all-padding day
        jp = JPredictor(_jcfg(pallas))
        v = {"params": tree["factor_predictor"]}
        want_b = jp.apply(v, jnp.asarray(latent), jnp.asarray(mask),
                          method=JPredictor.day_batched)
        got_b = model.factor_predictor.day_batched(_t(latent), _t(mask))
        want_1 = jp.apply(v, jnp.asarray(latent[0]), jnp.asarray(mask[0]))
        got_1 = model.factor_predictor(_t(latent[0]), _t(mask[0]))
        for got, want in ((got_b, want_b), (got_1, want_1)):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)

    def test_decoder(self, weights):
        tree, model = weights
        rng = np.random.default_rng(5)
        latent = rng.normal(size=(B, N, H)).astype(np.float32)
        fmu = rng.normal(size=(B, K)).astype(np.float32)
        fsig = np.abs(rng.normal(size=(B, K))).astype(np.float32)
        fsig[0, 1] = 0.0                                # the zero-sigma guard
        want = JDecoder(_jcfg(False)).apply(
            {"params": tree["factor_decoder"]}, jnp.asarray(latent),
            jnp.asarray(fmu), jnp.asarray(fsig), method=JDecoder.distribution)
        dec = model.factor_decoder
        got = dec.distribution(_t(latent), _t(fmu), _t(fsig))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
        mu, sigma = got
        mean, _ = dec(_t(latent), _t(fmu), _t(fsig), sample=False)
        assert torch.equal(mean, mu)

    def test_stochastic_decoder_takes_eps(self, weights):
        _, model = weights
        rng = np.random.default_rng(6)
        latent = _t(rng.normal(size=(B, N, H)).astype(np.float32))
        fmu = _t(rng.normal(size=(B, K)).astype(np.float32))
        fsig = _t(np.abs(rng.normal(size=(B, K))).astype(np.float32))
        eps = _t(rng.normal(size=(B, N)).astype(np.float32))
        dec = model.factor_decoder
        sample, (mu, sigma) = dec(latent, fmu, fsig, sample=True, eps=eps)
        assert torch.equal(sample, mu + eps * sigma)
        zero, _ = dec(latent, fmu, fsig, sample=True, eps=torch.zeros_like(eps))
        mean, _ = dec(latent, fmu, fsig, sample=False)
        assert torch.equal(zero, mean)
        with pytest.raises(ValueError):
            dec(latent, fmu, fsig, sample=True)        # no eps, no generator
        g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
        assert torch.equal(dec(latent, fmu, fsig, generator=g1)[0],
                           dec(latent, fmu, fsig, generator=g2)[0])

    def test_encoder(self, weights):
        tree, model = weights
        rng, _, mask = _inputs(7)
        latent = rng.normal(size=(B, N, H)).astype(np.float32)
        returns = rng.normal(size=(B, N)).astype(np.float32)
        je = JEncoder(_jcfg(False))
        v = {"params": tree["factor_encoder"]}
        want_b = je.apply(v, jnp.asarray(latent), jnp.asarray(returns),
                          jnp.asarray(mask), method=JEncoder.day_batched)
        want_1 = je.apply(v, jnp.asarray(latent[0]), jnp.asarray(returns[0]),
                          jnp.asarray(mask[0]))
        enc = model.factor_encoder
        got_b = enc.day_batched(_t(latent), _t(returns), _t(mask))
        got_1 = enc(_t(latent[0]), _t(returns[0]), _t(mask[0]))
        for got, want in ((got_b, want_b), (got_1, want_1)):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


class TestTrainingForward:
    """The training forward and its losses against the JAX
    `day_batched_forward`, with the JAX kernels on (Pallas, interpret mode)
    and off (XLA). 'nll' takes no noise, so recon, kl and loss compare
    directly; with 'mse' the port takes eps from numpy and its recon is held
    against the JAX decoder's own distribution with that eps."""

    def _inputs(self, seed):
        rng, x, mask = _inputs(seed)
        returns = rng.normal(size=(B, N)).astype(np.float32)
        returns[0, 2] = np.nan                        # a missing label on a valid row
        mask[0, 2] = True
        mask[2] = False                               # an all-padding day
        return rng, x, returns, mask

    def _jax(self, tree, recon_loss, pallas, x, returns, mask):
        cfg = dataclasses.replace(_jcfg(pallas), recon_loss=recon_loss, dropout_rate=0.0)
        k = jax.random.PRNGKey(0)
        return JFactorVAE(cfg).apply(
            {"params": tree}, jnp.asarray(x), jnp.asarray(returns), jnp.asarray(mask),
            train=True, rngs={"sample": k, "dropout": k},
            method=JFactorVAE.day_batched_forward)

    @PALLAS
    def test_nll_losses_match_jax(self, weights, pallas):
        tree, model = weights
        rng, x, returns, mask = self._inputs(13)
        want = self._jax(tree, "nll", pallas, x, returns, mask)
        port = FactorVAE(dataclasses.replace(model.cfg, recon_loss="nll",
                                             dropout_rate=0.0))
        port.load_state_dict(model.state_dict())
        eps = _t(rng.normal(size=(B, N)).astype(np.float32))
        with torch.no_grad():
            got = port.day_batched_forward(_t(x), _t(returns), _t(mask), train=True, eps=eps)
        for name in ("loss", "recon_loss", "kl", "factor_mu", "factor_sigma",
                     "pred_mu", "pred_sigma"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), **TOL, err_msg=name)
        assert np.isfinite(got.loss.numpy()).all()
        one = port(_t(x[0]), _t(returns[0]), _t(mask[0]), train=True, eps=eps[0])
        np.testing.assert_allclose(one.loss.detach().numpy(), got.loss[0].numpy(), **TOL)

    @PALLAS
    def test_mse_with_numpy_eps_matches_jax_distribution(self, weights, pallas):
        tree, model = weights
        rng, x, returns, mask = self._inputs(17)
        want = self._jax(tree, "mse", pallas, x, returns, mask)
        eps = rng.normal(size=(B, N)).astype(np.float32)
        with torch.no_grad():
            got = model.day_batched_forward(_t(x), _t(returns), _t(mask), train=False,
                                            eps=_t(eps))
        latent = JExtractor(_jcfg(pallas)).apply(
            {"params": tree["feature_extractor"]},
            jnp.asarray(x.reshape(B * N, T, C))).reshape(B, N, H)
        mu, sigma = JDecoder(_jcfg(pallas)).apply(
            {"params": tree["factor_decoder"]}, latent, want.factor_mu, want.factor_sigma,
            method=JDecoder.distribution)
        loss_mask = mask & np.isfinite(returns)
        y0 = np.where(loss_mask, returns, 0.0)
        recon = [float(jmasked_mse(mu[d] + eps[d] * sigma[d], y0[d], loss_mask[d]))
                 for d in range(B)]
        np.testing.assert_allclose(got.recon_loss.numpy(), recon, **TOL)
        np.testing.assert_allclose(got.kl.numpy(), np.asarray(want.kl), **TOL)
        np.testing.assert_allclose(got.loss.numpy(), np.asarray(recon) + np.asarray(want.kl),
                                   **TOL)

    def test_keep_mask_is_used_only_in_training(self, weights):
        _, model = weights
        rng, x, returns, mask = self._inputs(19)
        eps = _t(rng.normal(size=(B, N)).astype(np.float32))
        keep = _t(((rng.random((B, K, N)) > 0.1) / 0.9).astype(np.float32))
        with torch.no_grad():
            plain = model.day_batched_forward(_t(x), _t(returns), _t(mask), eps=eps)
            ev = model.day_batched_forward(_t(x), _t(returns), _t(mask), eps=eps, keep=keep)
            tr = model.day_batched_forward(_t(x), _t(returns), _t(mask), train=True,
                                           eps=eps, keep=keep)
        assert torch.equal(plain.loss, ev.loss)        # no mask at eval
        assert not torch.equal(plain.pred_mu, tr.pred_mu)
        g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
        a = model.factor_predictor.keep_mask((B, K, N), "cpu", g1)
        assert torch.equal(a, model.factor_predictor.keep_mask((B, K, N), "cpu", g2))
        assert set(np.unique(a.numpy())) <= {0.0, np.float32(1 / 0.9)}
        with pytest.raises(ValueError):
            model.day_batched_forward(_t(x), _t(returns), _t(mask), train=True, eps=eps)


class TestPrediction:
    @PALLAS
    def test_prediction_and_day_batched_prediction(self, weights, pallas):
        tree, model = weights
        _, x, mask = _inputs(11)
        jm = JFactorVAE(_jcfg(pallas))
        v = {"params": tree}
        want_b = jm.apply(v, jnp.asarray(x), jnp.asarray(mask), stochastic=False,
                          method=JFactorVAE.day_batched_prediction)
        want_1 = jm.apply(v, jnp.asarray(x[0]), jnp.asarray(mask[0]),
                          stochastic=False, method=JFactorVAE.prediction)
        with torch.no_grad():
            got_b = model.day_batched_prediction(_t(x), _t(mask), stochastic=False)
            got_1 = model.prediction(_t(x[0]), _t(mask[0]), stochastic=False)
        for got, want in ((got_b, want_b), (got_1, want_1)):
            got, want = got.numpy(), np.asarray(want)
            assert np.array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(got, want, **TOL)

    def test_load_model_is_seeded_and_refuses_unported_options(self):
        cfg = tconfig.Config(model=tconfig.ModelConfig(
            num_features=C, hidden_size=H, num_factors=K, num_portfolios=M, seq_len=T))
        a, b = load_model(cfg, device="cpu"), load_model(cfg, device="cpu")
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
        bound = 1.0 / np.sqrt(C)
        w = a.feature_extractor.proj.weight.detach()
        assert float(w.abs().max()) <= bound and float(w.std()) > bound / 4
        bf16 = FactorVAE(dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
        assert bf16.feature_extractor.proj.dtype == torch.bfloat16     # bf16 now builds
        with pytest.raises(ValueError, match="compute_dtype"):
            dataclasses.replace(cfg.model, compute_dtype="float16")
        stacked = FactorVAE(dataclasses.replace(cfg.model, gru_layers=2))   # L = 2 builds
        _, jparams = jload_model(jconfig.Config(model=dataclasses.replace(
            _jcfg(False), gru_layers=2)), n_max=8)
        assert sum(p.numel() for p in stacked.parameters()) == sum(
            np.asarray(leaf).size for leaf in jax.tree_util.tree_leaves(jparams))
        with pytest.raises(ValueError, match="gru_layers"):
            FactorVAE(dataclasses.replace(cfg.model, gru_layers=0))
        json.dumps(cfg.to_dict())


LAYERS = pytest.mark.parametrize("layers", [2, 3], ids=["L2", "L3"])
GRU_GRAD_TOL = dict(rtol=2e-5, atol=5e-6)


@pytest.fixture(scope="module")
def stacked_weights():
    """gru_layers -> (JAX model tree, the port's FactorVAE with its weights),
    for L = 2 and 3."""
    out = {}
    for layers in (2, 3):
        jcfg = dataclasses.replace(_jcfg(False), gru_layers=layers)
        _, params = jload_model(jconfig.Config(model=jcfg), n_max=8)
        model = FactorVAE(tconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                              num_portfolios=M, seq_len=T,
                                              gru_layers=layers))
        model.load_state_dict(flax_to_torch(params))
        out[layers] = (params, model.eval())
    return out


class TestStackedGRU:
    """The stacked GRU (`gru_layers` 2 and 3) against the JAX `StackedGRU`:
    its lower layers are XLA's scan in the JAX package and `gru_sequence`
    here; the top layer is the kernels' recurrence (plain versions on the
    CPU) here and the XLA scan there."""

    @LAYERS
    def test_nested_names_round_trip_through_flax(self, stacked_weights, layers):
        params, model = stacked_weights[layers]
        names = {k for k in model.state_dict() if ".gru." in k}
        assert names == {f"feature_extractor.gru.layer_{i}.{leaf}" for i in range(layers)
                         for leaf in ("input_proj.weight", "input_proj.bias",
                                      "hidden_kernel", "hidden_bias")}
        back = jax.tree_util.tree_leaves_with_path(torch_to_flax(model.state_dict()))
        want = dict(jax.tree_util.tree_leaves_with_path(params))
        assert len(back) == len(want)
        for path, leaf in back:
            assert np.array_equal(leaf, np.asarray(want[path])), path

    @LAYERS
    @PALLAS
    def test_extractor(self, stacked_weights, layers, pallas):
        params, model = stacked_weights[layers]
        _, x, _ = _inputs()
        flat = x.reshape(B * N, T, C)
        jcfg = dataclasses.replace(_jcfg(pallas), gru_layers=layers)
        want = JExtractor(jcfg).apply(
            {"params": params["params"]["model"]["feature_extractor"]}, jnp.asarray(flat))
        got = model.feature_extractor(_t(flat)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), **TOL)

    @LAYERS
    def test_extractor_gradients_and_one_kernel_walk(self, stacked_weights, layers,
                                                     monkeypatch):
        """The input's and every parameter's gradient against jax.grad at
        the GRU's tolerance; the kernels' recurrence (its residual variant)
        runs once per forward, for the top layer, whatever L is."""
        from factorvae_tpu_torch.ops.kernels import gru as gru_module

        params, model = stacked_weights[layers]
        rng, x, _ = _inputs(5)
        flat = x.reshape(B * N, T, C)
        cot = rng.normal(size=(B * N, H)).astype(np.float32)
        jext = JExtractor(dataclasses.replace(_jcfg(False), gru_layers=layers))
        tree = params["params"]["model"]["feature_extractor"]

        def loss(p, a):
            return jnp.sum(jext.apply({"params": p}, a) * jnp.asarray(cot))

        want_p, want_x = jax.grad(loss, argnums=(0, 1))(tree, jnp.asarray(flat))
        calls = []
        real = gru_module.gru_fwd_residuals
        monkeypatch.setattr(gru_module, "gru_fwd_residuals",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        ext = model.feature_extractor
        leaf = _t(flat).requires_grad_()
        names, tensors = zip(*ext.named_parameters())
        grads = torch.autograd.grad(ext(leaf), (leaf, *tensors), _t(cot))
        assert calls == [1]
        np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_x), **GRU_GRAD_TOL)
        want = flax_to_torch({"feature_extractor": want_p})
        for name, g in zip(names, grads[1:]):
            np.testing.assert_allclose(g.numpy(), want[f"feature_extractor.{name}"].numpy(),
                                       **GRU_GRAD_TOL, err_msg=name)

    @LAYERS
    @PALLAS
    def test_training_forward_matches_jax(self, stacked_weights, layers, pallas):
        params, model = stacked_weights[layers]
        rng, x, mask = _inputs(13)
        returns = rng.normal(size=(B, N)).astype(np.float32)
        mask[2] = False
        cfg = dataclasses.replace(_jcfg(pallas), gru_layers=layers, recon_loss="nll",
                                  dropout_rate=0.0)
        k = jax.random.PRNGKey(0)
        want = JFactorVAE(cfg).apply(
            {"params": params["params"]["model"]}, jnp.asarray(x), jnp.asarray(returns),
            jnp.asarray(mask), train=True, rngs={"sample": k, "dropout": k},
            method=JFactorVAE.day_batched_forward)
        port = FactorVAE(dataclasses.replace(model.cfg, recon_loss="nll", dropout_rate=0.0))
        port.load_state_dict(model.state_dict())
        eps = _t(rng.normal(size=(B, N)).astype(np.float32))
        with torch.no_grad():
            got = port.day_batched_forward(_t(x), _t(returns), _t(mask), train=True, eps=eps)
        for name in ("loss", "recon_loss", "kl", "pred_mu", "pred_sigma"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), **TOL, err_msg=name)
        want_pred = JFactorVAE(cfg).apply(
            {"params": params["params"]["model"]}, jnp.asarray(x), jnp.asarray(mask),
            stochastic=False, method=JFactorVAE.day_batched_prediction)
        with torch.no_grad():
            got_pred = port.day_batched_prediction(_t(x), _t(mask), stochastic=False)
        np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred), **TOL)
