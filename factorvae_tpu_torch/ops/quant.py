"""Weight-only int8 quantization for the scoring path (`factorvae_tpu/ops/quant.py`).

Scoring only reads the weights, so they can stay resident as int8 with one
float32 scale per output channel, 4x smaller than float32, and be
dequantized to the model's compute dtype right before a scoring call.

Symmetric scheme, as in the JAX package: s = max |w| / 127 over each output
channel (s = 1 for an all-zero channel), q = round(clip(w / s, +-127)),
rounding half to even on both sides. The output channel depends on the
layout: the port's `Dense.weight` is torch's (out, in), so its channel is
axis 0, while the GRU's `hidden_kernel` (H, 3H) and the predictor's
`key_kernel`/`value_kernel` (K, H, H) keep the Flax layout, whose channel is
the last axis. So a parameter named `*.weight` is quantized over axis 0 and
every other one over its last axis; after `params.flax_to_torch` the port's
`q` and `s` are the JAX package's, transposed for a Dense. Parameters of at
least `min_size` elements and 2 or more dimensions are quantized, except
those whose name says "bias" or "query": biases add straight into the
activations and the learned query sets every head's logit scale.

A quantized tree is a dict of parameter name -> `QTensor` or float tensor;
the models run on one through `models.factorvae.call_with`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Union

import torch

EXCLUDED_NAME_KEYS = ("bias", "query")


@dataclasses.dataclass
class QTensor:
    """int8 values `q` and float32 scales `s`, broadcastable against `q`
    (1 along every axis but the output channel's)."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return self.q.to(dtype) * self.s.to(dtype)


def channel_axis(name: str, ndim: int) -> int:
    """The output-channel axis of parameter `name`: 0 for a Dense weight
    (torch's (out, in)), the last axis for the Flax-layout stacks."""
    return 0 if name.endswith("weight") else ndim - 1


def quantize_tensor(w: torch.Tensor, axis: int = -1) -> QTensor:
    """Symmetric per-channel int8 quantization of `w` along `axis`."""
    axis = axis % w.ndim
    reduce = tuple(a for a in range(w.ndim) if a != axis)
    s = torch.amax(torch.abs(w), dim=reduce, keepdim=True) / 127.0
    s = torch.where(s == 0.0, 1.0, s).to(torch.float32)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return QTensor(q, s)


def _quantizable(name: str, w: torch.Tensor, min_size: int) -> bool:
    return (w.ndim >= 2 and w.numel() >= min_size and w.is_floating_point()
            and not any(key in name.lower() for key in EXCLUDED_NAME_KEYS))


def _tensors(params) -> Mapping[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return {k: v.detach() for k, v in params.state_dict().items()}
    return params


def quantize_params(params, min_size: int = 256) -> dict:
    """A module's (or a state_dict's) parameters with every quantizable
    one as a `QTensor` and the rest unchanged."""
    return {name: (quantize_tensor(w, channel_axis(name, w.ndim))
                   if _quantizable(name, w, min_size) else w)
            for name, w in _tensors(params).items()}


def is_quantized(params) -> bool:
    """True for a `quantize_params` output (it holds a QTensor)."""
    return (isinstance(params, Mapping)
            and any(isinstance(v, QTensor) for v in params.values()))


def ensure_quantized(params, min_size: int = 256) -> dict:
    """`quantize_params`, idempotently: a quantized tree passes through."""
    return params if is_quantized(params) else quantize_params(params, min_size)


def dequantize_params(qparams: Mapping, dtype=torch.float32) -> dict:
    """A dense tree from a `quantize_params` output: each QTensor
    dequantized to `dtype`, every other tensor as it is (float32), as in
    the JAX package."""
    return {name: v.dequantize(dtype) if isinstance(v, QTensor) else v
            for name, v in qparams.items()}


def tree_nbytes(params: Union[Mapping, torch.nn.Module]) -> int:
    """Bytes of every tensor of the tree (a QTensor counts q and s)."""
    total = 0
    for v in _tensors(params).values():
        for t in ((v.q, v.s) if isinstance(v, QTensor) else (v,)):
            total += t.numel() * t.element_size()
    return total
