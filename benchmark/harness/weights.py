"""The model's weights, made from the seed on the device in two large draws:
one uniform block for every U(+-1/sqrt(fan_in)) parameter, one normal block
for the attention's queries. The same weights go to the program and to the
reference."""

from __future__ import annotations

import math

import torch

from benchmark.harness.seeds import stream_seed

WEIGHTS_STREAM = 12


def make_weights(specs: list, seed: int, device) -> dict:
    """{name: float32 tensor on `device`} for `specs` ((name, shape, init)
    as the reference's `param_specs` gives them)."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, WEIGHTS_STREAM))
    sizes = {name: math.prod(shape) for name, shape, _ in specs}
    n_uniform = sum(sizes[n] for n, _, init in specs if isinstance(init, tuple))
    n_normal = sum(sizes[n] for n, _, init in specs if init == "normal")
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    normal = torch.randn(n_normal, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for name, shape, init in specs:
        size = sizes[name]
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "normal":
            out[name] = normal[inn:inn + size].reshape(shape).clone()
            inn += size
        else:
            bound = 1.0 / math.sqrt(init[1])
            out[name] = (uniform[iu:iu + size] * bound).reshape(shape).clone()
            iu += size
    return out
