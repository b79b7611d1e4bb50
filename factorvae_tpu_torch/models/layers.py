"""Shared building blocks: initializers, Dense, LayerNorm, GRU
(`factorvae_tpu/models/layers.py`).

The GRU's input projection for all T steps is one matmul outside the
recurrence, as in the JAX package; the recurrence itself is the
differentiable `ops/kernels/gru.gru` (forward K1, backward K2).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from factorvae_tpu_torch.ops.kernels.gru import gru

# flax's lecun_normal draws a normal truncated at 2 std, rescaled so the
# truncated distribution keeps variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def torch_uniform_init(t: torch.Tensor, fan_in: int,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill `t` with U(-1/sqrt(fan_in), +1/sqrt(fan_in)), the scale of
    torch's nn.Linear and nn.GRU initializers."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def lecun_normal_init(t: torch.Tensor, fan_in: int,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


def init_weight(t: torch.Tensor, fan_in: int, torch_init: bool,
                generator: Optional[torch.Generator]) -> None:
    if torch_init:
        torch_uniform_init(t, fan_in, generator)
    else:
        lecun_normal_init(t, fan_in, generator)


def init_bias(t: torch.Tensor, fan_in: int, torch_init: bool,
              generator: Optional[torch.Generator]) -> None:
    if torch_init:
        torch_uniform_init(t, fan_in, generator)
    else:
        with torch.no_grad():
            t.zero_()


class Dense(nn.Module):
    """Linear layer y = x W^T + b with the torch-scale init."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, torch_init: bool = True,
                         generator: Optional[torch.Generator] = None) -> None:
        fan_in = self.weight.shape[1]
        init_weight(self.weight, fan_in, torch_init, generator)
        init_bias(self.bias, fan_in, torch_init, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def layer_norm(num_features: int) -> nn.LayerNorm:
    """LayerNorm with torch defaults (eps=1e-5, elementwise affine)."""
    return nn.LayerNorm(num_features, eps=1e-5)


class GRU(nn.Module):
    """Single-layer GRU over the time axis returning the last hidden state.

    Gates in torch order [r | z | n]:

        r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
        z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
        n = tanh  (x W_in + b_in + r * (h W_hn + b_hn))
        h' = (1 - z) * n + z * h

    Input (N, T, C), output (N, H). `hidden_kernel` is (H, 3H), as in the
    Flax tree (torch's nn.GRU stores its transpose).
    """

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.input_proj = Dense(input_size, 3 * hidden_size)
        self.hidden_kernel = nn.Parameter(torch.empty(hidden_size, 3 * hidden_size))
        self.hidden_bias = nn.Parameter(torch.empty(3 * hidden_size))

    def reset_parameters(self, torch_init: bool = True,
                         generator: Optional[torch.Generator] = None) -> None:
        self.input_proj.reset_parameters(torch_init, generator)
        init_weight(self.hidden_kernel, self.hidden_size, torch_init, generator)
        init_bias(self.hidden_bias, self.hidden_size, torch_init, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xi = self.input_proj(x)          # (N, T, 3H) in one matmul
        return gru(xi, self.hidden_kernel, self.hidden_bias)
