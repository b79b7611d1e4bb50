"""Per-stock feature extractor (`factorvae_tpu/models/extractor.py`).

LayerNorm(C) -> Linear(C->C) -> LeakyReLU -> GRU over T (`gru_layers`
layers) -> last hidden state: the per-stock latent (N, H). The input is
cast to the config's compute dtype first and every layer computes in it
(the kernels' recurrence of the top GRU layer in float32); the latent comes
out in float32. One layer keeps the flat `gru.*` parameter names; more nest
as `gru.layer_{i}.*`, as the JAX tree does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from factorvae_tpu_torch.config import ModelConfig
from factorvae_tpu_torch.models.layers import GRU, Dense, StackedGRU, layer_norm


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.gru_layers < 1:
            raise ValueError(f"gru_layers must be at least 1; got {cfg.gru_layers}")
        self.cfg = cfg
        dtype = cfg.dtype
        self.layer_norm = layer_norm(cfg.num_features, dtype)
        self.proj = Dense(cfg.num_features, cfg.num_features, dtype)
        if cfg.gru_layers == 1:
            self.gru = GRU(cfg.num_features, cfg.hidden_size, dtype)
        else:
            self.gru = StackedGRU(cfg.num_features, cfg.hidden_size, cfg.gru_layers, dtype)
        # flax's leaky_relu multiplies by the slope as a weak-typed scalar,
        # i.e. by the slope rounded to the compute dtype
        self.slope = float(torch.tensor(cfg.leaky_relu_slope, device="cpu").to(dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.layer_norm.reset_parameters()
        self.proj.reset_parameters(self.cfg.torch_init, generator)
        self.gru.reset_parameters(self.cfg.torch_init, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, T, C) -> (N, H). Padded stocks give latents that the
        masked reductions downstream ignore."""
        x = self.layer_norm(x.to(self.cfg.dtype))
        x = self.proj(x)
        x = F.leaky_relu(x, negative_slope=self.slope)
        return self.gru(x).float()
