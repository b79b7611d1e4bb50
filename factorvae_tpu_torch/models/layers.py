"""Shared building blocks: initializers, Dense, LayerNorm, GRU and the
stacked GRU (`factorvae_tpu/models/layers.py`).

The GRU's input projection for all T steps is one matmul outside the
recurrence, as in the JAX package; the recurrence itself is the
differentiable `ops/kernels/gru.gru` (forward K1, backward K2). A stacked
GRU's lower layers return their whole hidden sequence, which the JAX
package computes on XLA's scan and never on its Pallas kernel; here they
are `gru_sequence`, the same scan in PyTorch ops, and only the top layer
reaches the kernels.

Compute dtypes follow flax's `dtype=`: a layer given a dtype casts its
input and parameters to it; without one it computes in the promoted dtype
of its input and parameters (a bfloat16 weight meets a float32 activation
in float32). LayerNorm takes its mean and variance in float32 whatever the
dtype. The GRU recurrence always runs in float32: xi goes to float32 on the
way in and the last hidden state comes back in the compute dtype.
`KERNEL_PARAMS` names a module's parameters that enter a CUDA kernel rather
than a PyTorch op (`train/state.cast_compute` casts those differently).
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


def compute_dtype(dtype: Optional[torch.dtype], *tensors: torch.Tensor) -> torch.dtype:
    """`dtype`, or without one the promoted dtype of `tensors` (flax's
    `promote_dtype`)."""
    if dtype is not None:
        return dtype
    out = tensors[0].dtype
    for t in tensors[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


class Dense(nn.Module):
    """Linear layer y = x W^T + b with the torch-scale init, computed in
    `dtype` (None: the promoted dtype of x, W and b)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, torch_init: bool = True,
                         generator: Optional[torch.Generator] = None) -> None:
        fan_in = self.weight.shape[1]
        init_weight(self.weight, fan_in, torch_init, generator)
        init_bias(self.bias, fan_in, torch_init, generator)

    def forward(self, x: torch.Tensor, upcast: bool = False) -> torch.Tensor:
        """y in the compute dtype; with `upcast`, a low-precision y comes back
        in float32 before its last rounding, for a consumer that upcasts it
        at once (XLA drops such a round trip when it fuses the two)."""
        dtype = compute_dtype(self.dtype, x, self.weight, self.bias)
        x, w, b = (t.to(dtype) for t in (x, self.weight, self.bias))
        if dtype == torch.float32:
            return F.linear(x, w, b)
        # as XLA computes it: the product rounded to the compute dtype, then
        # the bias added in float32 and the sum rounded (one pass; a
        # low-precision add rounds its float32 sum once)
        y = F.linear(x, w)
        if upcast:
            return _RoundGrad.apply(y + b.float(), dtype)
        return y + b


class _RoundGrad(torch.autograd.Function):
    """Identity in the forward; the backward rounds the gradient to `dtype`
    (the cotangent of the cast that XLA fused away in the forward). Plain
    torch, so `torch.func.vmap` generates its rule."""

    generate_vmap_rule = True

    @staticmethod
    def forward(y, dtype):
        return y.view_as(y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dtype = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype).to(grad.dtype), None


class LayerNorm(nn.LayerNorm):
    """LayerNorm with torch defaults (eps=1e-5, elementwise affine). With a
    `dtype` other than float32, the statistics and the affine map are taken
    in float32 and the result is cast to `dtype`."""

    def __init__(self, num_features: int, dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, eps=1e-5)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = compute_dtype(self.dtype, x, self.weight, self.bias)
        if dtype == torch.float32 and x.dtype == torch.float32:
            return super().forward(x)
        # flax's float32 arithmetic: var = E[x^2] - E[x]^2, and the scale
        # folded into the reciprocal standard deviation
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((x - mean) * mul + self.bias.float()).to(dtype)


def layer_norm(num_features: int, dtype: Optional[torch.dtype] = None) -> LayerNorm:
    return LayerNorm(num_features, dtype)


class GRU(nn.Module):
    """Single-layer GRU over the time axis returning the last hidden state.

    Gates in torch order [r | z | n]:

        r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
        z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
        n = tanh  (x W_in + b_in + r * (h W_hn + b_hn))
        h' = (1 - z) * n + z * h

    Input (N, T, C), output (N, H) in `dtype` (None: the input's). The
    input projection computes in `dtype`; the recurrence in float32.
    `hidden_kernel` is (H, 3H), as in the Flax tree (torch's nn.GRU stores
    its transpose).
    """

    KERNEL_PARAMS = ("hidden_kernel", "hidden_bias")

    def __init__(self, input_size: int, hidden_size: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.input_proj = Dense(input_size, 3 * hidden_size, dtype)
        self.hidden_kernel = nn.Parameter(torch.empty(hidden_size, 3 * hidden_size))
        self.hidden_bias = nn.Parameter(torch.empty(3 * hidden_size))

    def reset_parameters(self, torch_init: bool = True,
                         generator: Optional[torch.Generator] = None) -> None:
        self.input_proj.reset_parameters(torch_init, generator)
        init_weight(self.hidden_kernel, self.hidden_size, torch_init, generator)
        init_bias(self.hidden_bias, self.hidden_size, torch_init, generator)

    def forward(self, x: torch.Tensor, return_sequence: bool = False) -> torch.Tensor:
        """(N, H), or with `return_sequence` the hidden state after every
        step (N, T, H) through `gru_sequence`."""
        if return_sequence:
            xi = self.input_proj(x)              # (N, T, 3H) in the compute dtype
            return gru_sequence(xi, self.hidden_kernel, self.hidden_bias,
                                self.dtype or x.dtype)
        xi = self.input_proj(x, upcast=True)     # (N, T, 3H) f32, one matmul
        h = gru(xi, self.hidden_kernel, self.hidden_bias)
        return h.to(self.dtype or x.dtype)


def gru_sequence(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The GRU recurrence over xi (N, T, 3H) returning every step's hidden
    state (N, T, H): the JAX scan of a sequence-returning layer, step for
    step (g = h . Wh + b, gates [r | z | n]), in `dtype` as the JAX layer
    computes it. Plain PyTorch ops, so autograd differentiates it and
    `torch.func.vmap` batches it over models."""
    xi, w_h, b_h = (t.to(dtype) for t in (xi, w_h, b_h))
    h_dim = w_h.shape[0]
    h = xi.new_zeros(xi.shape[:-2] + (h_dim,))
    seq = []
    for t in range(xi.shape[-2]):
        x_t = xi[..., t, :]
        g = h @ w_h + b_h
        r = torch.sigmoid(x_t[..., :h_dim] + g[..., :h_dim])
        z = torch.sigmoid(x_t[..., h_dim:2 * h_dim] + g[..., h_dim:2 * h_dim])
        n = torch.tanh(x_t[..., 2 * h_dim:] + r * g[..., 2 * h_dim:])
        h = (1.0 - z) * n + z * h
        seq.append(h)
    return torch.stack(seq, dim=-2)


class StackedGRU(nn.Module):
    """`num_layers` GRU layers (torch nn.GRU(num_layers=L) semantics): each
    layer takes the whole hidden sequence of the layer below, and the top
    layer returns its last hidden state. Layer i is the submodule
    `layer_{i}`, as the JAX tree nests `gru/layer_{i}`. The lower layers run
    `gru_sequence`; the top layer runs the kernels as `GRU` does, so a
    forward launches K1 once and a backward walks once, whatever L is."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", GRU(input_size if i == 0 else hidden_size,
                                              hidden_size, dtype))

    def layers(self) -> list:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def reset_parameters(self, torch_init: bool = True,
                         generator: Optional[torch.Generator] = None) -> None:
        for layer in self.layers():
            layer.reset_parameters(torch_init, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *lower, top = self.layers()
        for layer in lower:
            x = layer(x, return_sequence=True)
        return top(x)
