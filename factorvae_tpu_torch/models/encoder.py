"""Posterior factor encoder (`factorvae_tpu/models/encoder.py`).

Stock latents -> M portfolio weights (softmax over the stocks, masked) ->
portfolio returns y_p = W^T y -> mu and softplus sigma heads: the posterior
(mu, sigma) of the K factors. The training forward
(`models/factorvae.FactorVAE.day_batched_forward`) uses it; the serving path
does not.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from factorvae_tpu_torch.config import ModelConfig
from factorvae_tpu_torch.models.layers import Dense
from factorvae_tpu_torch.ops.masked import masked_softmax


class FactorEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        h, m, k = cfg.hidden_size, cfg.num_portfolios, cfg.num_factors
        self.portfolio = Dense(h, m)
        self.mu = Dense(m, k)
        self.sigma = Dense(m, k)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for d in (self.portfolio, self.mu, self.sigma):
            d.reset_parameters(self.cfg.torch_init, generator)

    def forward(self, latent: torch.Tensor, returns: torch.Tensor,
                mask: torch.Tensor):
        """latent (N, H), returns (N,), mask (N,) -> ((K,), (K,))."""
        mu, sigma = self.day_batched(latent[None], returns[None], mask[None])
        return mu[0], sigma[0]

    def day_batched(self, latent: torch.Tensor, returns: torch.Tensor,
                    mask: torch.Tensor):
        """latent (B, N, H), returns/mask (B, N) -> ((B, K), (B, K))."""
        w = masked_softmax(self.portfolio(latent), mask[..., None], dim=1)
        returns = torch.where(mask, returns, 0.0)
        y_p = torch.einsum("bnm,bn->bm", w, returns)
        return self.mu(y_p), F.softplus(self.sigma(y_p))
