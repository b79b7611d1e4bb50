"""Train and eval steps over day batches (`factorvae_tpu/train/loop.py`).

A batch is a (days_per_step,) tensor of day indices on the device; -1 marks
epoch padding (the day is gathered as day 0, masked out and weighted 0, so
it adds neither loss nor gradient). `days_per_step=1` is the reference: one
trading day per update, the schedule advanced per update.

Metrics accumulate as device tensors; an epoch's metrics reach the host in
one copy at its end. The finite guard (`TrainConfig.finite_guard`) reads one
flag per step: a step whose gradient has any non-finite element applies no
update, so the parameters, Adam's moments and step count and the schedule's
position stay exactly as they were; the train step count still advances and
`skipped_steps` counts the step. A `poison`ed epoch (a `nan_grads` fault
of `chaos`) multiplies every step's gradients by NaN before the guard reads
them, as the JAX package's chaos traces do.

A mixed step (`compute_dtype` bfloat16, `factorvae_tpu/train/loop.py`)
computes with `cast_compute`'s bfloat16 copy of the float32 masters, made
inside the differentiated function; the loss is multiplied by the state's
loss scale in float32 before the backward and the gradients by its inverse
after it, then the poison applies. The all-finite gate is always on: an
overflow is a skipped step. The scale then walks on the host, in float32:
a finite step counts towards growth (x `growth` after `growth_interval`
finite steps in a row), a skipped one backs it off (x `backoff`, down to
`floor`). Validation computes with the bfloat16 copy too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from factorvae_tpu_torch.models.factorvae import call_with
from factorvae_tpu_torch.train.state import TrainState, cast_compute


def batch_for(dataset, days: torch.Tensor):
    """(x, y, mask) of a day batch; padding days (-1) are fully masked."""
    x, y, mask = dataset.gather(torch.clamp(days, min=0))
    return x, y, mask & (days >= 0)[:, None]


def weighted_day_loss(model, dataset, days: torch.Tensor, *, train: bool,
                      generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None,
                      keep: Optional[torch.Tensor] = None,
                      params: Optional[dict] = None):
    """(loss, aux): the mean loss over the real days of the batch and the
    per-step sums the epoch metrics are made of (detached). `params`, when
    given, replace the model's own (the compute copy of a mixed step)."""
    x, y, mask = batch_for(dataset, days)
    day_w = (days >= 0).to(torch.float32)
    kw = dict(train=train, eps=eps, keep=keep, generator=generator)
    out = (model.day_batched_forward(x, y, mask, **kw) if params is None
           else call_with(model, params, "day_batched_forward", x, y, mask, **kw))
    loss_sum = torch.sum(out.loss * day_w)
    count = torch.sum(day_w)
    loss = loss_sum / torch.clamp(count, min=1.0)
    n_valid = torch.sum(mask, dim=-1).to(torch.float32) * day_w
    aux = {
        "loss_sum": loss_sum,
        "recon_sum": torch.sum(out.recon_loss * day_w),
        "kl_sum": torch.sum(out.kl * day_w),
        "days": count,
        # the sample-weighted numerator and denominator
        "wloss_sum": torch.sum(out.loss * n_valid),
        "samples": torch.sum(n_valid),
    }
    return loss, {k: v.detach() for k, v in aux.items()}


def all_finite(tensors) -> torch.Tensor:
    """A device bool: every element of every tensor is finite."""
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def _grads(model) -> list:
    return [p.grad for p in model.parameters() if p.grad is not None]


def train_step(state: TrainState, dataset, days: torch.Tensor, *, guard: bool,
               poison: bool = False, compute_dtype: torch.dtype = torch.float32,
               loss_scale_cfg: Optional[tuple] = None) -> dict:
    """One update from the batch `days`; returns the step's aux sums. A
    `compute_dtype` other than float32 takes the mixed step, whose
    `loss_scale_cfg` is (growth, backoff, growth_interval, floor); its aux
    also holds the loss scale after the step (a host float32)."""
    model, optimizer = state.model, state.optimizer
    mixed = compute_dtype != torch.float32
    optimizer.zero_grad(set_to_none=True)
    loss, aux = weighted_day_loss(model, dataset, days, train=True,
                                  generator=state.generator,
                                  params=cast_compute(model, compute_dtype) if mixed else None)
    if mixed:
        (loss * float(state.loss_scale)).backward()
        inv = float(np.float32(1.0) / state.loss_scale)
        for g in _grads(model):
            g.mul_(inv)
    else:
        loss.backward()
    if poison:
        for g in _grads(model):
            g.mul_(float("nan"))
    apply = True
    if guard or mixed:
        ok = all_finite(_grads(model))
        aux["skipped"] = (~ok).to(torch.float32)
        apply = bool(ok)          # the gate's one host read per step
    if apply:
        optimizer.step()
        state.scheduler.step()
    state.step += 1
    if mixed:
        aux["loss_scale"] = _walk_loss_scale(state, apply, loss_scale_cfg)
    return aux


def _walk_loss_scale(state: TrainState, ok: bool, cfg: tuple) -> np.float32:
    """The loss scale's step, in float32, as the JAX package's in-graph walk:
    good = ok ? good + 1 : 0; grow = good >= interval; scale = ok ? (grow ?
    scale * growth : scale) : max(scale * backoff, floor); good = grow ? 0 :
    good. Returns the new scale."""
    growth, backoff, interval, floor = (np.float32(cfg[0]), np.float32(cfg[1]),
                                        int(cfg[2]), np.float32(cfg[3]))
    good = state.good_steps + 1 if ok else 0
    grow = good >= interval
    scale = state.loss_scale
    if ok:
        scale = scale * growth if grow else scale
    else:
        scale = max(scale * backoff, floor)
    state.loss_scale = np.float32(scale)
    state.good_steps = 0 if grow else good
    return state.loss_scale


def loss_scale_probes(scales: list, floor: float) -> dict:
    """The epoch's loss-scale metrics from each step's scale
    (`factorvae_tpu/obs/probes.loss_scale_probes`): the scale after the last
    step, and the steps that left it at or below the floor."""
    return {"loss_scale": float(scales[-1]),
            "loss_scale_floor_steps": float(sum(s <= np.float32(floor) for s in scales))}


def _accumulate(total: Optional[dict], aux: dict) -> dict:
    return aux if total is None else {k: total[k] + aux[k] for k in total}


def finalize_train(sums: dict) -> dict:
    days = torch.clamp(sums["days"], min=1.0)
    m = {"loss": sums["loss_sum"] / days, "recon": sums["recon_sum"] / days,
         "kl": sums["kl_sum"] / days, "days": sums["days"]}
    if "skipped" in sums:
        m["skipped_steps"] = sums["skipped"]
    return m


def finalize_eval(sums: dict) -> dict:
    m = finalize_train(sums)
    m["loss_sample_weighted"] = sums["wloss_sum"] / torch.clamp(sums["samples"], min=1.0)
    return m


def to_host(metrics: dict) -> dict:
    """Device scalars -> floats, in one copy."""
    keys = list(metrics)
    values = torch.stack([metrics[k].to(torch.float32) for k in keys]).tolist()
    return dict(zip(keys, values))


def train_epoch(state: TrainState, dataset, order: torch.Tensor, *, guard: bool,
                poison: bool = False, compute_dtype: torch.dtype = torch.float32,
                loss_scale_cfg: Optional[tuple] = None) -> dict:
    """order (S, B) day indices on the device -> the epoch's metrics
    (floats); a mixed epoch's also hold `loss_scale_probes`."""
    sums, scales = None, []
    for i in range(order.shape[0]):
        aux = train_step(state, dataset, order[i], guard=guard, poison=poison,
                         compute_dtype=compute_dtype, loss_scale_cfg=loss_scale_cfg)
        if "loss_scale" in aux:
            scales.append(aux.pop("loss_scale"))
        sums = _accumulate(sums, aux)
    metrics = to_host(finalize_train(sums))
    if scales:
        metrics.update(loss_scale_probes(scales, loss_scale_cfg[3]))
    return metrics


@torch.no_grad()
def eval_epoch(model, dataset, order: torch.Tensor, generator: torch.Generator,
               compute_dtype: torch.dtype = torch.float32) -> dict:
    """Validation metrics over order (S, B): dropout off, the reconstruction
    still sampled (the reference's validate()). A `compute_dtype` other
    than float32 computes with the model's compute copy, as a mixed run's
    train steps do."""
    params = cast_compute(model, compute_dtype) if compute_dtype != torch.float32 else None
    sums = None
    for i in range(order.shape[0]):
        _, aux = weighted_day_loss(model, dataset, order[i], train=False,
                                   generator=generator, params=params)
        sums = _accumulate(sums, aux)
    return to_host(finalize_eval(sums))
