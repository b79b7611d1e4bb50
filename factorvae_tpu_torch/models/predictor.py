"""Prior factor predictor: K-head attention over the stock cross-section
(`factorvae_tpu/models/predictor.py`).

The attention runs through the K4 kernel (`ops/kernels/attention.py`) for
all days and heads at once. Kept from the reference: scores divided by
sqrt(H + 1e-6), the order dropout -> ReLU -> softmax over stocks, a zero
context for a head with a non-finite score, one learned query per head.
Dropout is a training feature and waits for the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from factorvae_tpu_torch.config import ModelConfig
from factorvae_tpu_torch.models.layers import Dense, init_bias, init_weight
from factorvae_tpu_torch.ops.kernels.attention import attention_fwd


class FactorPredictor(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        k, h = cfg.num_factors, cfg.hidden_size
        self.query = nn.Parameter(torch.empty(k, h))
        self.key_kernel = nn.Parameter(torch.empty(k, h, h))
        self.key_bias = nn.Parameter(torch.empty(k, h))
        self.value_kernel = nn.Parameter(torch.empty(k, h, h))
        self.value_bias = nn.Parameter(torch.empty(k, h))
        self.proj = Dense(h, h)
        self.mu = Dense(h, 1)
        self.sigma = Dense(h, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        cfg, h = self.cfg, self.cfg.hidden_size
        with torch.no_grad():
            self.query.normal_(0.0, 1.0, generator=generator)
        for w in (self.key_kernel, self.value_kernel):
            init_weight(w, h, cfg.torch_init, generator)
        for b in (self.key_bias, self.value_bias):
            init_bias(b, h, cfg.torch_init, generator)
        for d in (self.proj, self.mu, self.sigma):
            d.reset_parameters(cfg.torch_init, generator)

    def _heads(self, context: torch.Tensor):
        """Shared head MLP on the context (..., K, H) -> mu, sigma (..., K)."""
        h = F.leaky_relu(self.proj(context), negative_slope=self.cfg.leaky_relu_slope)
        return self.mu(h)[..., 0], F.softplus(self.sigma(h))[..., 0]

    def forward(self, latent: torch.Tensor, mask: torch.Tensor):
        """latent (N, H), mask (N,) -> prior (mu, sigma), each (K,)."""
        mu, sigma = self.day_batched(latent[None], mask[None])
        return mu[0], sigma[0]

    def day_batched(self, latent: torch.Tensor, mask: torch.Tensor):
        """latent (B, N, H), mask (B, N) -> ((B, K), (B, K))."""
        context = attention_fwd(latent.contiguous(), mask.contiguous(),
                                self.query, self.key_kernel, self.key_bias,
                                self.value_kernel, self.value_bias)
        return self._heads(context)
