"""The FactorVAE model, inference half (`factorvae_tpu/models/factorvae.py`).

`prediction` and `day_batched_prediction` run extractor -> prior predictor
-> decoder, i.e. score stocks without future returns. The training forward
and its losses come with the training slice. `load_model` builds the model
from a Config with random weights drawn from `config.train.seed`, or loads a
weights directory written by `params.save_weights`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from factorvae_tpu_torch.config import Config, ModelConfig
from factorvae_tpu_torch.models.decoder import FactorDecoder
from factorvae_tpu_torch.models.encoder import FactorEncoder
from factorvae_tpu_torch.models.extractor import FeatureExtractor
from factorvae_tpu_torch.models.predictor import FactorPredictor


class FactorVAE(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"factorvae_tpu_torch runs float32 only; got compute_dtype="
                f"{cfg.compute_dtype!r} (the precision ladder is not ported)")
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
                               generator: Optional[torch.Generator] = None
                               ) -> torch.Tensor:
        """x (B, N, T, C), mask (B, N) -> scores (B, N), NaN on padded
        stocks. The per-stock extractor runs on the flattened (B*N) rows;
        the attention and the factor combination stay per day."""
        b, n = x.shape[0], x.shape[1]
        latent = self.feature_extractor(
            x.reshape((b * n,) + tuple(x.shape[2:]))).reshape(b, n, -1)
        pred_mu, pred_sigma = self.factor_predictor.day_batched(latent, mask)
        y_pred, _ = self.factor_decoder(
            latent, pred_mu, pred_sigma, sample=self._stochastic(stochastic),
            eps=eps, generator=generator)
        return torch.where(mask, y_pred, torch.nan)


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
