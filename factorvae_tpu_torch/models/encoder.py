"""Posterior factor encoder (`factorvae_tpu/models/encoder.py`).

Stock latents -> M portfolio weights (softmax over the stocks, masked) ->
portfolio returns y_p = W^T y -> mu and softplus sigma heads: the posterior
(mu, sigma) of the K factors. On a stock-sharded mesh the softmax and W^T y
are the explicit collectives `pmax_masked_softmax` and `psum`; without a
stock axis they are the plain ops. The training forward
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
from factorvae_tpu_torch.parallel.collective_ops import pmax_masked_softmax, psum


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
                    mask: torch.Tensor, stock=None):
        """latent (B, N, H), returns/mask (B, N) -> ((B, K), (B, K)).

        With `stock` (a mesh's 'stock' `Axis`) the N rows are this rank's
        slice of the cross-section: the softmax over stocks and the
        portfolio sum run over the whole of it (`parallel/collective_ops`)
        and the result is the whole day's on every rank."""
        w = pmax_masked_softmax(self.portfolio(latent), mask[..., None], stock, dim=1)
        returns = torch.where(mask, returns, 0.0)
        y_p = psum(torch.einsum("bnm,bn->bm", w, returns), stock)
        return self.mu(y_p), F.softplus(self.sigma(y_p))
