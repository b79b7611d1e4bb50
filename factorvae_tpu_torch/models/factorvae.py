"""The FactorVAE model (`factorvae_tpu/models/factorvae.py`).

`forward` and `day_batched_forward` are the training forward: extractor ->
posterior encoder (with the day's returns) -> decoder sample -> prior
predictor, and the loss reconstruction + kl_weight * KL(posterior || prior).
`prediction` and `day_batched_prediction` run extractor -> prior predictor
-> decoder, i.e. score stocks without future returns. `load_model` builds the
model from a Config with random weights drawn from `config.train.seed`, or
loads a weights directory written by `params.save_weights`.

Loss notes, as in the reference: 'mse' is the MSE between the single
reparameterized sample and the labels (a mean over stocks) while the KL is a
sum over K; 'nll' is the analytic Gaussian reconstruction likelihood. The
decoder's noise `eps` and the predictor's keep-mask `keep` are optional
tensor arguments, else drawn from `generator`.

`call_with` runs a method of the model on other parameters than its own:
the bfloat16 compute copy of a mixed training step, or the dequantized
weights of int8 scoring.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from factorvae_tpu_torch.config import Config, ModelConfig
from factorvae_tpu_torch.models.decoder import FactorDecoder
from factorvae_tpu_torch.models.encoder import FactorEncoder
from factorvae_tpu_torch.models.extractor import FeatureExtractor
from factorvae_tpu_torch.models.predictor import FactorPredictor
from factorvae_tpu_torch.ops.kl import gaussian_kl_sum
from factorvae_tpu_torch.ops.masked import masked_gaussian_nll, masked_mse


@dataclasses.dataclass
class FactorVAEOutput:
    """The training forward's outputs; per day where the fields have a day
    axis."""

    loss: torch.Tensor
    recon_loss: torch.Tensor
    kl: torch.Tensor
    reconstruction: torch.Tensor     # (..., N) sampled returns, 0 on padding
    factor_mu: torch.Tensor          # (..., K) posterior mean
    factor_sigma: torch.Tensor       # (..., K) posterior std
    pred_mu: torch.Tensor            # (..., K) prior mean
    pred_sigma: torch.Tensor         # (..., K) prior std


class FactorVAE(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg)
        self.factor_encoder = FactorEncoder(cfg)
        self.factor_decoder = FactorDecoder(cfg)
        self.factor_predictor = FactorPredictor(cfg)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in (self.feature_extractor, self.factor_encoder,
                  self.factor_decoder, self.factor_predictor):
            m.reset_parameters(generator)

    def _stochastic(self, stochastic: Optional[bool]) -> bool:
        return self.cfg.stochastic_inference if stochastic is None else stochastic

    def forward(self, x: torch.Tensor, returns: torch.Tensor,
                mask: Optional[torch.Tensor] = None, *, train: bool = False,
                eps: Optional[torch.Tensor] = None, keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> FactorVAEOutput:
        """One day: x (N, T, C), returns (N,), mask (N,) (None: all valid);
        eps (N,) and keep (K, N) as in `day_batched_forward`."""
        if mask is None:
            mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        out = self.day_batched_forward(
            x[None], returns[None], mask[None], train=train,
            eps=None if eps is None else eps[None],
            keep=None if keep is None else keep[None], generator=generator)
        return FactorVAEOutput(**{f.name: getattr(out, f.name)[0]
                                  for f in dataclasses.fields(out)})

    def day_batched_forward(self, x: torch.Tensor, returns: torch.Tensor,
                            mask: torch.Tensor, *, train: bool = False,
                            eps: Optional[torch.Tensor] = None,
                            keep: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            stock=None) -> FactorVAEOutput:
        """x (B, N, T, C), returns/mask (B, N) -> per-day losses (B,).

        The per-stock extractor runs on the flattened (B*N) rows; the
        portfolio softmax, attention and losses stay per day. A label that
        is not finite leaves the loss and is zeroed before the encoder. The
        decoder samples with `eps` (B, N), the predictor's dropout (train
        only) uses `keep` (B, K, N); either is drawn from `generator` when
        not given, eps first.

        With `stock` (a mesh's 'stock' `Axis`) the N stocks are this rank's
        slice of the cross-section, and so are eps and the per-stock
        outputs; `keep` covers the whole cross-section, and the losses,
        factors and prior are the whole day's on every rank."""
        return self._forward_from_latent(self._latent(x), returns, mask, train=train,
                                         eps=eps, keep=keep, generator=generator,
                                         stock=stock)

    def day_batched_decomposition(self, x: torch.Tensor, returns: torch.Tensor,
                                  mask: torch.Tensor, *,
                                  eps: Optional[torch.Tensor] = None,
                                  generator: Optional[torch.Generator] = None):
        """The eval forward of `day_batched_forward` (no dropout) and the
        decoder's internals from the same latent: (out, alpha_mu (B, N),
        alpha_sigma (B, N), beta (B, N, K)). The extractor runs once."""
        latent = self._latent(x)
        out = self._forward_from_latent(latent, returns, mask, train=False, eps=eps,
                                        generator=generator)
        alpha_mu, alpha_sigma = self.factor_decoder.alpha_layer(latent)
        return out, alpha_mu, alpha_sigma, self.factor_decoder.beta_layer(latent)

    def _latent(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, T, C) -> latent (B, N, H), the extractor on the
        flattened (B*N) rows."""
        b, n = x.shape[0], x.shape[1]
        return self.feature_extractor(
            x.reshape((b * n,) + tuple(x.shape[2:]))).reshape(b, n, -1)

    def _forward_from_latent(self, latent, returns, mask, *, train, eps=None, keep=None,
                             generator=None, stock=None) -> FactorVAEOutput:
        cfg = self.cfg
        loss_mask = mask & torch.isfinite(returns)
        returns = torch.where(loss_mask, returns, 0.0)
        factor_mu, factor_sigma = self.factor_encoder.day_batched(latent, returns, mask,
                                                                  stock=stock)
        sample, (recon_mu, recon_sigma) = self.factor_decoder(
            latent, factor_mu, factor_sigma, sample=True, eps=eps, generator=generator)
        pred_mu, pred_sigma = self.factor_predictor.day_batched(
            latent, mask, train=train, keep=keep, generator=generator, stock=stock)
        if cfg.recon_loss == "mse":
            recon = masked_mse(sample, returns, loss_mask, dim=-1, axis=stock)
        elif cfg.recon_loss == "nll":
            recon = masked_gaussian_nll(recon_mu, recon_sigma, returns, loss_mask, dim=-1,
                                        axis=stock)
        else:
            raise ValueError(f"unknown recon_loss {cfg.recon_loss!r}")
        kl = gaussian_kl_sum(factor_mu, factor_sigma, pred_mu, pred_sigma, dim=-1)
        return FactorVAEOutput(
            loss=recon + cfg.kl_weight * kl, recon_loss=recon, kl=kl,
            reconstruction=torch.where(mask, sample, 0.0),
            factor_mu=factor_mu, factor_sigma=factor_sigma,
            pred_mu=pred_mu, pred_sigma=pred_sigma)

    def prediction(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                   stochastic: Optional[bool] = None,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One day: x (N, T, C), mask (N,) -> scores (N,), NaN on padded
        stocks. stochastic=True draws mu + eps*sigma (the reference's
        behaviour); False returns the mean. Default from the config."""
        if mask is None:
            mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        return self.day_batched_prediction(
            x[None], mask[None], stochastic=stochastic,
            eps=None if eps is None else eps[None], generator=generator)[0]

    def day_batched_prediction(self, x: torch.Tensor, mask: torch.Tensor, *,
                               stochastic: Optional[bool] = None,
                               eps: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None,
                               stock=None) -> torch.Tensor:
        """x (B, N, T, C), mask (B, N) -> scores (B, N), NaN on padded
        stocks. The per-stock extractor runs on the flattened (B*N) rows;
        the attention and the factor combination stay per day. With `stock`
        the N rows (and eps) are this rank's slice of the cross-section."""
        latent = self._latent(x)
        pred_mu, pred_sigma = self.factor_predictor.day_batched(latent, mask, stock=stock)
        y_pred, _ = self.factor_decoder(
            latent, pred_mu, pred_sigma, sample=self._stochastic(stochastic),
            eps=eps, generator=generator)
        return torch.where(mask, y_pred, torch.nan)


class _Method(nn.Module):
    """`model.<method>` as a module's forward, for `functional_call`."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model, self.method = model, method

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.method)(*args, **kwargs)


def with_compute_dtype(model: "FactorVAE", compute_dtype: str) -> "FactorVAE":
    """`model` computing in `compute_dtype`: the model itself when it already
    does, else a FactorVAE that shares its parameter tensors."""
    if model.cfg.compute_dtype == compute_dtype:
        return model
    cfg = dataclasses.replace(model.cfg, compute_dtype=compute_dtype)
    with torch.device("meta"):
        view = FactorVAE(cfg)
    view.load_state_dict(model.state_dict(keep_vars=True), assign=True)
    return view.train(model.training)


def model_from_params(model_cfg: ModelConfig, params: dict,
                      lane: Optional[int] = None) -> "FactorVAE":
    """A FactorVAE of `model_cfg` holding copies of `params` (parameter name
    -> tensor), or of lane `lane` of stacked (S, ...) ones (a fleet's), on
    their device; `params` None gives the structure alone, on the meta
    device (for `call_with`)."""
    with torch.device("meta"):
        model = FactorVAE(model_cfg)
    if params is not None:
        model.load_state_dict({n: (p[lane] if lane is not None else p).detach().clone()
                               for n, p in params.items()}, assign=True)
    return model


def call_with(model: nn.Module, params: dict, method: str, *args, **kwargs):
    """`model.<method>(*args, **kwargs)` computed with `params` (parameter
    name -> tensor) in place of the model's own parameters; gradients flow
    to whatever `params` were made from."""
    return torch.func.functional_call(
        _Method(model, method), {f"model.{k}": v for k, v in params.items()},
        args, kwargs)


def load_model(config, checkpoint_path: Optional[str] = None,
               device="cuda") -> FactorVAE:
    """The inference model on `device`, in eval mode: random weights from a
    torch.Generator seeded with `config.train.seed`, or the weights of the
    directory `checkpoint_path` (`params.save_weights` layout)."""
    if not isinstance(config, Config):
        config = Config(model=config)
    model = FactorVAE(config.model)
    model.reset_parameters(torch.Generator().manual_seed(config.train.seed))
    if checkpoint_path is not None:
        from factorvae_tpu_torch.params import read_state_dict

        model.load_state_dict(read_state_dict(checkpoint_path))
    return model.to(device).eval()
