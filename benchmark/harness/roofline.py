"""A kernel operation's share of its roofline: the least time its calls in
the traced window need (from shapes, `flops.py`) over the device time of
the kernels its host ranges launched there."""

from __future__ import annotations

from typing import Optional

GRU = "factorvae_tpu_torch.ops.kernels.gru"
ATTENTION = "factorvae_tpu_torch.ops.kernels.attention"

#: the program's launch counters, one per wrapper
COUNTERS = {
    "gru_fwd": f"{GRU}:gru_fwd.launches",
    "gru_fwd_residuals": f"{GRU}:gru_fwd_residuals.launches",
    "gru_bwd": f"{GRU}:gru_bwd.launches",
    "gru_dwh": f"{GRU}:gru_dwh.launches",
    "attention_fwd": f"{ATTENTION}:attention_fwd.launches",
    "attention_bwd": f"{ATTENTION}:attention_bwd.launches",
}

#: parts of the CUDA function names of the program's kernels, by the host
#: range that launches them: for kernels no range's correlation reaches
#: (a demangled name reads "void (anonymous namespace)::gru_fwd_kernel<...>")
NAME_TABLE = {
    "::gru_fwd_": "gru_fwd",
    "::gru_walk_": "gru_bwd",
    "::gru_dwh_": "gru_dwh",
    "::attention_fwd_": "attention_fwd",
    "::attention_bwd_": "attention_bwd",
}


def share(ctx, ranges, least_s: float) -> Optional[float]:
    """100 x least_s over the device time of `ranges`, or None when the
    trace holds none of it."""
    red = ctx.reduced
    if red is None or least_s <= 0.0:
        return None
    device_s = sum(red.by_range.get(r, 0) for r in ranges) / 1e9
    if device_s <= 0.0:
        return None
    return 100.0 * least_s / device_s
