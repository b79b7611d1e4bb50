"""Prior factor predictor: K-head attention over the stock cross-section
(`factorvae_tpu/models/predictor.py`).

The attention runs through the differentiable `ops/kernels/attention.attention`
(forward K4, backward K5) for all days and heads at once. Kept from the
reference: scores divided by sqrt(H + 1e-6), the order dropout -> ReLU ->
softmax over stocks, a zero context for a head with a non-finite score, one
learned query per head. Training dropout is an explicit (B, K, N) keep-mask,
Bernoulli(1 - p) / (1 - p), passed in by the caller or drawn from a
`torch.Generator`, as the JAX package's `_dropout_mask` draws it outside its
kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from factorvae_tpu_torch.config import ModelConfig
from factorvae_tpu_torch.models.layers import Dense, init_bias, init_weight
from factorvae_tpu_torch.ops.kernels.attention import attention
from factorvae_tpu_torch.parallel.collective_ops import all_gather_stocks


class FactorPredictor(nn.Module):
    KERNEL_PARAMS = ("query", "key_kernel", "key_bias", "value_kernel", "value_bias")

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

    def keep_mask(self, shape, device, generator: Optional[torch.Generator]) -> torch.Tensor:
        """Score dropout as an inverted-scale keep-mask: Bernoulli(1 - p)
        / (1 - p) of `shape`, drawn from `generator`."""
        if generator is None:
            raise ValueError("training dropout needs `keep` or a torch.Generator")
        keep_p = 1.0 - self.cfg.dropout_rate
        u = torch.rand(shape, generator=generator, device=device)
        return (u < keep_p).to(torch.float32) / keep_p

    def day_batched(self, latent: torch.Tensor, mask: torch.Tensor, *,
                    train: bool = False, keep: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None, stock=None):
        """latent (B, N, H), mask (B, N) -> ((B, K), (B, K)).

        With train=True and dropout_rate > 0 the scores go through a keep-mask
        (B, K, N): `keep` when given, else one drawn from `generator`. At
        eval, or with dropout_rate == 0, no mask is used or drawn.

        With `stock` (a mesh's 'stock' `Axis`) latent and mask are this rank's
        rows of the cross-section. The attention needs the whole of it, so
        both are all-gathered over the axis and the attention (K4, K5 in the
        backward) runs on the full day on every rank; the gather's backward
        hands each rank the gradient of its own rows. `keep` then covers the
        whole cross-section."""
        latent = all_gather_stocks(latent, stock, dim=1)
        mask = all_gather_stocks(mask, stock, dim=1)
        if train and self.cfg.dropout_rate > 0.0:
            if keep is None:
                b, n = latent.shape[0], latent.shape[1]
                keep = self.keep_mask((b, self.cfg.num_factors, n), latent.device,
                                      generator)
        else:
            keep = None
        context = attention(latent.contiguous(), mask.contiguous(), self.query,
                            self.key_kernel, self.key_bias, self.value_kernel,
                            self.value_bias, keep)
        return self._heads(context)
