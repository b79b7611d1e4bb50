"""Training-health probes on the device (`factorvae_tpu/obs/probes.py`).

Every probe is a scalar per step (per lane in a fleet), added into the aux
sums that `train/loop._accumulate` already carries, so the whole catalog
reaches the host in the epoch's one `to_host` copy: no host read per step.
The port cannot promise the JAX package's zero extra dispatches: each probe
is a few small kernels launched per step.

Per-step aux (from `loss_probes` / `grad_probes`; `MERGE` says how two
steps combine, the rest add):

    nf_loss          non-finite per-day losses among the real days
    mu_spread_sum    day-weighted sum of std_K(posterior factor mu), ddof 0
    sigma_mean_sum   day-weighted sum of mean_K(posterior factor sigma)
    grad_norm        global norm of the step's gradients (after the
                     loss-scale unscale and the chaos poison)
    grad_norm_max    the same, merged by max
    update_norm      global norm of the applied update (NaN on a skipped
                     step: the JAX package takes it from optax's un-gated
                     updates, which a non-finite gradient makes NaN)
    param_norm       global norm of the parameters after the step (kept
                     ones on a skipped step), merged by "last"
    nonfinite_grads  non-finite gradient elements
    probe_steps      1 per step, the denominator of the means

`finalize_train_probes` / `finalize_eval_probes` reduce the sums to the
epoch metrics of `TRAIN_PROBE_KEYS` / `EVAL_PROBE_KEYS`. The probes only
read values the update already computed: they draw nothing and change no
op of the update, so weights, losses and generators stay bitwise those of
a run without them.

The global norm is sqrt of the sum of squares over every tensor
(`optax.global_norm`), taken on one flat copy of them all (`flatten`, a
single `torch.cat`): a step's probes cost about 25 small launches whatever
the number of tensors. The multi-tensor `torch._foreach_norm` allocates an
output per tensor and cost twice the host time on the card
(`scripts/torch_probe_cost.py`). A fleet's norms are per lane, taken on the
lane-stacked tensors outside `torch.func.vmap`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

TRAIN_PROBE_KEYS = (
    "grad_norm_max",
    "grad_norm_mean",
    "update_norm_mean",
    "param_norm_last",
    "nonfinite_grads",
    "nonfinite_loss",
    "factor_mu_spread",
    "factor_sigma_mean",
)
EVAL_PROBE_KEYS = (
    "nonfinite_loss",
    "factor_mu_spread",
    "factor_sigma_mean",
)
MIXED_PROBE_KEYS = (
    "loss_scale",
    "loss_scale_floor_steps",
)

#: how two steps' probe values combine in `_accumulate` (the rest add)
MERGE: Dict[str, Callable] = {
    "grad_norm_max": torch.maximum,
    "param_norm": lambda total, step: step,
}


def loss_probes(out, day_w: torch.Tensor) -> dict:
    """Forward probes of one step's day-batched output: `out` holds (B,)
    per-day losses and (B, K) posterior moments, `day_w` the (B,) real-day
    weight (0 on padding, whose values are finite garbage)."""
    f32 = torch.float32
    per_day = torch.stack([(~torch.isfinite(out.loss)).to(f32),
                           torch.std(out.factor_mu.to(f32), dim=-1, correction=0),
                           torch.mean(out.factor_sigma.to(f32), dim=-1)])
    nf, mu, sigma = torch.sum(per_day * day_w, dim=-1)
    return {"nf_loss": nf, "mu_spread_sum": mu, "sigma_mean_sum": sigma}


@torch.no_grad()
def flatten(tensors, lanes: Optional[int] = None) -> torch.Tensor:
    """Every (float32) tensor's elements in one new tensor: (numel,), or (S,
    numel / S) keeping the leading lane axis; the parameters' flat copy
    before a step is `update_probes`' `before`."""
    if lanes is None:
        return torch.cat([t.view(-1) for t in tensors])
    return torch.cat([t.view(lanes, -1) for t in tensors], dim=1)


@torch.no_grad()
def grad_probes(grads, lanes: Optional[int] = None) -> dict:
    """Gradient probes of one step, taken before the optimizer reads them."""
    flat = flatten(grads, lanes)
    g = torch.linalg.vector_norm(flat, dim=-1)
    return {
        "grad_norm": g,
        "grad_norm_max": g,
        "nonfinite_grads": torch.sum(~torch.isfinite(flat), dim=-1).to(torch.float32),
        "probe_steps": torch.ones_like(g),
    }


@torch.no_grad()
def update_probes(before: torch.Tensor, params, applied: Optional[torch.Tensor] = None,
                  lanes: Optional[int] = None) -> dict:
    """Update and parameter norms of one step from `before` (the parameters
    before it, `flatten`ed) and the parameters after it. The update norm
    is that of after - before where the step was applied and NaN where it
    was skipped (`applied`: a device bool, (S,) in a fleet; None when every
    step applies). Rounding: (p + u) - p differs from optax's u by up to
    half an ulp of p per element."""
    after = flatten(params, lanes)
    norm = torch.linalg.vector_norm(after - before, dim=-1)
    if applied is not None:
        norm = torch.where(applied, norm, torch.full_like(norm, float("nan")))
    return {"update_norm": norm, "param_norm": torch.linalg.vector_norm(after, dim=-1)}


def finalize_train_probes(sums: dict, days: torch.Tensor) -> dict:
    """The epoch's summed probe aux -> its scalar (or (S,)) metrics; `days`
    is the real-day count, already clamped >= 1."""
    steps = sums["probe_steps"]
    return {
        "grad_norm_max": sums["grad_norm_max"],
        "grad_norm_mean": sums["grad_norm"] / steps,
        "update_norm_mean": sums["update_norm"] / steps,
        "param_norm_last": sums["param_norm"],
        "nonfinite_grads": sums["nonfinite_grads"],
        "nonfinite_loss": sums["nf_loss"],
        "factor_mu_spread": sums["mu_spread_sum"] / days,
        "factor_sigma_mean": sums["sigma_mean_sum"] / days,
    }


def finalize_eval_probes(sums: dict, days: torch.Tensor) -> dict:
    return {
        "nonfinite_loss": sums["nf_loss"],
        "factor_mu_spread": sums["mu_spread_sum"] / days,
        "factor_sigma_mean": sums["sigma_mean_sum"] / days,
    }
