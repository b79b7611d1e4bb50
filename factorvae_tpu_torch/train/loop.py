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
"""

from __future__ import annotations

from typing import Optional

import torch

from factorvae_tpu_torch.train.state import TrainState


def batch_for(dataset, days: torch.Tensor):
    """(x, y, mask) of a day batch; padding days (-1) are fully masked."""
    x, y, mask = dataset.gather(torch.clamp(days, min=0))
    return x, y, mask & (days >= 0)[:, None]


def weighted_day_loss(model, dataset, days: torch.Tensor, *, train: bool,
                      generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None,
                      keep: Optional[torch.Tensor] = None):
    """(loss, aux): the mean loss over the real days of the batch and the
    per-step sums the epoch metrics are made of (detached)."""
    x, y, mask = batch_for(dataset, days)
    day_w = (days >= 0).to(torch.float32)
    out = model.day_batched_forward(x, y, mask, train=train, eps=eps, keep=keep,
                                    generator=generator)
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


def train_step(state: TrainState, dataset, days: torch.Tensor, *, guard: bool,
               poison: bool = False) -> dict:
    """One update from the batch `days`; returns the step's aux sums."""
    model, optimizer = state.model, state.optimizer
    optimizer.zero_grad(set_to_none=True)
    loss, aux = weighted_day_loss(model, dataset, days, train=True,
                                  generator=state.generator)
    loss.backward()
    if poison:
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(float("nan"))
    apply = True
    if guard:
        ok = all_finite([p.grad for p in model.parameters() if p.grad is not None])
        aux["skipped"] = (~ok).to(torch.float32)
        apply = bool(ok)          # the guard's one host read per step
    if apply:
        optimizer.step()
        state.scheduler.step()
    state.step += 1
    return aux


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
                poison: bool = False) -> dict:
    """order (S, B) day indices on the device -> the epoch's metrics (floats)."""
    sums = None
    for i in range(order.shape[0]):
        sums = _accumulate(sums, train_step(state, dataset, order[i], guard=guard,
                                            poison=poison))
    return to_host(finalize_train(sums))


@torch.no_grad()
def eval_epoch(model, dataset, order: torch.Tensor,
               generator: torch.Generator) -> dict:
    """Validation metrics over order (S, B): dropout off, the reconstruction
    still sampled (the reference's validate())."""
    sums = None
    for i in range(order.shape[0]):
        _, aux = weighted_day_loss(model, dataset, order[i], train=False,
                                   generator=generator)
        sums = _accumulate(sums, aux)
    return to_host(finalize_eval(sums))
