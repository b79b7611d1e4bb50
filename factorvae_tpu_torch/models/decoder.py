"""Alpha/beta heads and the factor decoder (`factorvae_tpu/models/decoder.py`).

    mu    = alpha_mu + beta @ factor_mu
    sigma = sqrt(alpha_sigma^2 + beta^2 @ factor_sigma^2 + 1e-6)

with the reference's zero-sigma guard, and a reparameterized sample
mu + eps * sigma. The noise comes from an explicit `torch.Generator`, or is
passed in as `eps` (tests feed noise made with numpy).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from factorvae_tpu_torch.config import ModelConfig
from factorvae_tpu_torch.models.layers import Dense


class AlphaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.proj = Dense(h, h)
        self.mu = Dense(h, 1)
        self.sigma = Dense(h, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for d in (self.proj, self.mu, self.sigma):
            d.reset_parameters(self.cfg.torch_init, generator)

    def forward(self, latent: torch.Tensor):
        """latent (..., N, H) -> (alpha_mu, alpha_sigma), each (..., N)."""
        h = F.leaky_relu(self.proj(latent), negative_slope=self.cfg.leaky_relu_slope)
        return self.mu(h)[..., 0], F.softplus(self.sigma(h))[..., 0]


class BetaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.beta = Dense(cfg.hidden_size, cfg.num_factors)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.beta.reset_parameters(self.cfg.torch_init, generator)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        """latent (..., N, H) -> factor exposures (..., N, K)."""
        return self.beta(latent)


class FactorDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.alpha_layer = AlphaLayer(cfg)
        self.beta_layer = BetaLayer(cfg)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.alpha_layer.reset_parameters(generator)
        self.beta_layer.reset_parameters(generator)

    def distribution(self, latent, factor_mu, factor_sigma):
        """Per-stock return distribution (mu, sigma), each (..., N), from
        latent (..., N, H) and factors (..., K)."""
        alpha_mu, alpha_sigma = self.alpha_layer(latent)
        beta = self.beta_layer(latent)
        factor_sigma = torch.where(factor_sigma == 0.0, 1e-6, factor_sigma)
        mu = alpha_mu + torch.einsum("...nk,...k->...n", beta, factor_mu)
        sigma = torch.sqrt(
            alpha_sigma ** 2
            + torch.einsum("...nk,...k->...n", beta ** 2, factor_sigma ** 2)
            + 1e-6)
        return mu, sigma

    def forward(self, latent, factor_mu, factor_sigma, *, sample: bool = True,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Returns (prediction, (mu, sigma)). With sample=True the prediction
        is mu + eps * sigma, with `eps` given or drawn from `generator`;
        sample=False returns the mean."""
        mu, sigma = self.distribution(latent, factor_mu, factor_sigma)
        if not sample:
            return mu, (mu, sigma)
        if eps is None:
            if generator is None:
                raise ValueError(
                    "a sampled prediction needs `eps` or a torch.Generator")
            eps = torch.randn(sigma.shape, generator=generator,
                              device=sigma.device, dtype=sigma.dtype)
        return mu + eps * sigma, (mu, sigma)
