"""Train and eval steps over day batches (`factorvae_tpu/train/loop.py`).

A batch is a (days_per_step,) tensor of day indices on the device; -1 marks
epoch padding (the day is gathered as day 0, masked out and weighted 0, so
it adds neither loss nor gradient). `days_per_step=1` is the reference: one
trading day per update, the schedule advanced per update. An epoch walks
(dataset, order) chunks in step order (`data/stream.epoch_chunks`): the
resident panel with the whole order, or under the stream residency one
mini-panel per chunk with its local order; the sums, the loss-scale walk
and the generators run on across chunks, so a stream epoch takes the steps
of the "hbm" one.

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

Fleets (`train/fleet.py`): `lane_train_epoch` and `lane_eval_epoch` take S
models at once, a `FleetState`. Each lane gathers its own days (its own
shuffled order), draws its noise from its own generator outside the model
(`lane_noise`, the draws of its solo run, in their order) and passes it in
as `eps` and `keep`; the forward is `torch.func.vmap` of the model over the
stacked parameters, whose CUDA kernels each launch once for all lanes.
A hyper-fleet reads kl_weight as an (S,) tensor. The finite guard is a
per-lane select; the host reads the (S,) flags once per step.

Rematerialization (`TrainConfig.remat`, the JAX package's `jax.checkpoint`
of the train day loss): "full" wraps the step's day loss (`weighted_day_loss`,
or the fleet's `lane_day_loss` around its vmap) in
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`, so the backward
reruns the forward, K1's residual variant and K4 included, instead of
keeping its activations; "dots" does the same with a selective policy that
keeps the outputs of the matrix products (`aten.mm`, `addmm`, `bmm`,
`baddbmm`) and recomputes the rest. The kernels are ctypes launches inside
`autograd.Function`s, not aten ops, so "dots" recomputes them, as JAX's
`checkpoint_dots` recomputes a `pallas_call`. Eval never checkpoints. Every
train step draws its noise (eps, then the dropout keep-mask) before the
day loss, in the order and shapes the forward would draw it, so a
recompute sees the same numbers and the generator's stream is the same
under every rung; nothing inside the checkpoint draws, so it keeps no RNG
state. Loss and gradients equal remat "none"'s.

At this placement (one checkpoint around the whole day loss, as the JAX
package places it) remat lowers no peak: the memory a step adds peaks in
the backward, after the recompute has rebuilt every activation the forward
of "none" keeps. It lowers only what is held between the forward and the
backward, and costs the recompute's time.

With `probes` (`TrainConfig.obs_probes`) every step adds the health probes
of `obs/probes.py` into its aux sums on the device: the per-day loss and
factor probes from the forward, the gradient, update and parameter norms
and the non-finite gradient count after the unscale and the poison. They
read no value to the host, draw nothing and leave the update as it is.

On a mesh (`parallel/mesh.py`, the `mesh` argument) each rank holds its
'stock' rows of the panel (`parallel/sharding.shard_dataset`) and takes its
'data' slice of every update's days. The noise is drawn at the update's
full (B, N) shape from the one generator every rank seeds alike, and each
rank keeps its days and stocks of it, so the model is the serial run's.
Every rank computes its days' whole loss (the cross-stock reductions and
the predictor's gather are `parallel/collective_ops`, whose backwards are
the true adjoints), divided by the update's real-day count; the gradients
are then summed over the world and divided by the 'stock' size
(`collective_ops.reduce_gradients`). The finite guard, the loss scale and
the probes read the reduced gradients, which are the same on every rank,
so every rank applies or skips the same steps and the parameters stay
bitwise equal across ranks. The per-day metric sums are summed over the
batch axes once per epoch. A fleet on a mesh lays its lanes over 'data'
(each rank steps its own lanes) and shares no collective between lanes:
on a ('data', 'stock') mesh every rank of a lane takes its whole update
and its gradients are reduced over 'stock' alone; on a hierarchical
('host', 'data', 'stock') mesh the update's days split over 'host', each
lane's loss divides by its whole update's real days, and the gradients
are reduced over 'host' and 'stock' together, so the update is the serial
fleet's up to the order of its sums.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from factorvae_tpu_torch.models.factorvae import call_with
from factorvae_tpu_torch.parallel.collective_ops import all_reduce, psum, reduce_gradients
from factorvae_tpu_torch.obs.probes import (
    MERGE,
    finalize_eval_probes,
    finalize_train_probes,
    flatten,
    grad_probes,
    loss_probes,
    update_probes,
)
from factorvae_tpu_torch.train.state import (
    FleetState,
    TrainState,
    cast_compute,
    cast_params,
    lane_adam_step,
)


REMAT = ("none", "dots", "full")

_aten = torch.ops.aten
#: the products "dots" keeps (`jax.checkpoint_policies.checkpoint_dots`)
DOT_OPS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default)


def check_remat(remat: str) -> str:
    """`remat` itself, or the JAX package's ValueError."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: expected 'none', 'dots' or 'full' "
                         "(TrainConfig.remat)")
    return remat


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def rematerialized(remat: str, fn, *args, **kwargs):
    """`fn(*args, **kwargs)`, under "dots" or "full" through
    `torch.utils.checkpoint`: its backward recomputes the forward (all of
    it, or all but the products). `fn` must draw no random numbers. Around
    a whole day loss this saves no peak memory (the module docstring)."""
    if check_remat(remat) == "none":
        return fn(*args, **kwargs)
    extra = {}
    if remat == "dots":
        extra["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                _dots_policy)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      **extra, **kwargs)


def day_noise(model, generator: torch.Generator, b: int, n: int, *, train: bool,
              device):
    """One forward's noise over B days of N stocks, drawn from `generator` as
    the forward draws it, in that order: the decoder's eps (B, N), then with
    train and dropout the predictor's keep mask (B, K, N), else None."""
    eps = torch.randn((b, n), generator=generator, device=device, dtype=torch.float32)
    keep = None
    if train and model.cfg.dropout_rate > 0.0:
        keep = model.factor_predictor.keep_mask((b, model.cfg.num_factors, n), device,
                                                generator)
    return eps, keep


def batch_for(dataset, days: torch.Tensor):
    """(x, y, mask) of a day batch; padding days (-1) are fully masked."""
    x, y, mask = dataset.gather(torch.clamp(days, min=0))
    return x, y, mask & (days >= 0)[:, None]


def weighted_day_loss(model, dataset, days: torch.Tensor, *, train: bool,
                      generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None,
                      keep: Optional[torch.Tensor] = None,
                      params: Optional[dict] = None, probes: bool = False,
                      stock=None, total_days: Optional[torch.Tensor] = None):
    """(loss, aux): the mean loss over the real days of the batch and the
    per-step sums the epoch metrics are made of (detached). `params`, when
    given, replace the model's own (the compute copy of a mixed step);
    `probes` adds the forward's `loss_probes`. On a mesh, `stock` is the
    'stock' `Axis` (the dataset holds this rank's rows) and `total_days`
    the real days of the whole update, which divides this rank's days'
    loss sum."""
    x, y, mask = batch_for(dataset, days)
    day_w = (days >= 0).to(torch.float32)
    kw = dict(train=train, eps=eps, keep=keep, generator=generator)
    if stock is not None:
        kw["stock"] = stock
    out = (model.day_batched_forward(x, y, mask, **kw) if params is None
           else call_with(model, params, "day_batched_forward", x, y, mask, **kw))
    loss_sum = torch.sum(out.loss * day_w)
    count = torch.sum(day_w)
    loss = loss_sum / torch.clamp(count if total_days is None else total_days, min=1.0)
    n_valid = psum(torch.sum(mask, dim=-1).to(torch.float32), stock) * day_w
    aux = {
        "loss_sum": loss_sum,
        "recon_sum": torch.sum(out.recon_loss * day_w),
        "kl_sum": torch.sum(out.kl * day_w),
        "days": count,
        # the sample-weighted numerator and denominator
        "wloss_sum": torch.sum(out.loss * n_valid),
        "samples": torch.sum(n_valid),
    }
    if probes:
        aux.update(loss_probes(out, day_w))
    return loss, {k: v.detach() for k, v in aux.items()}


def all_finite(tensors) -> torch.Tensor:
    """A device bool: every element of every tensor is finite."""
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def _grads(model) -> list:
    return [p.grad for p in model.parameters() if p.grad is not None]


class MeshStep:
    """What a step on a mesh needs: the rank's slices of a batch's days and
    of the cross-section, the 'stock' axis and the axes its gradients and
    its per-day sums are reduced over. The day batch splits over
    `partition.day_batch_axes(mesh, stacked)`: the batch axes for a serial
    step; for a fleet's (`stacked`, lanes over 'data') 'host' on a
    hierarchical mesh, else none. The gradients are summed over the day
    axes and 'stock' together, never over the lanes' 'data'."""

    def __init__(self, mesh, stacked: bool = False):
        from factorvae_tpu_torch.parallel.mesh import STOCK_AXIS
        from factorvae_tpu_torch.parallel.partition import day_batch_axes

        self.mesh = mesh
        self.stock = mesh.axis(STOCK_AXIS)
        self.sp = self.stock.size
        day = day_batch_axes(mesh, stacked=stacked)
        self.day_axis = mesh.axes(*day) if day else None
        self.grad_axis = mesh.axes(*day, STOCK_AXIS)

    def days(self, t: torch.Tensor, trailing: int = 1) -> torch.Tensor:
        """This rank's days of `t`, whose day axis has `trailing - 1` axes
        after it: a (B,) batch, eps (B, N), keep (B, K, N), with any lane
        axes before it; whole for a fleet on a two-axis mesh."""
        if self.day_axis is None:
            return t
        from factorvae_tpu_torch.parallel.multihost import _slice_of

        dim = t.ndim - trailing
        sl = _slice_of(int(t.shape[dim]), self.day_axis.size, self.day_axis.index)
        return t.narrow(dim, sl.start, sl.stop - sl.start)

    def stocks(self, n_local: int) -> slice:
        """This rank's columns of the whole cross-section of n_local * sp."""
        return slice(self.stock.index * n_local, (self.stock.index + 1) * n_local)

    def noise(self, eps: torch.Tensor, keep: Optional[torch.Tensor], n_local: int):
        """The rank's part of noise drawn at the whole update's shape: its
        days and stocks of eps (..., B, N), its days of keep (..., B, K, N)
        (whole N: the attention runs on the whole day)."""
        eps = self.days(eps, 2)[..., self.stocks(n_local)]
        return eps, None if keep is None else self.days(keep, 3)

    def reduce_sums(self, sums: dict) -> dict:
        """The epoch's per-day sums summed over the batch axes (the rest are
        the same on every rank), in one all-reduce."""
        keys = [k for k in DAY_SUMS if k in sums]
        if self.day_axis is None or self.day_axis.group is None or not keys:
            return sums
        total = all_reduce(torch.stack([sums[k].to(torch.float32) for k in keys]),
                           self.day_axis)
        return {**sums, **dict(zip(keys, total.unbind(0)))}


#: the aux sums taken over a step's days: on a mesh each rank holds its days'
DAY_SUMS = ("loss_sum", "recon_sum", "kl_sum", "days", "wloss_sum", "samples", "nf_loss",
            "mu_spread_sum", "sigma_mean_sum")


def train_step(state: TrainState, dataset, days: torch.Tensor, *, guard: bool,
               poison: bool = False, compute_dtype: torch.dtype = torch.float32,
               loss_scale_cfg: Optional[tuple] = None, probes: bool = False,
               remat: str = "none", mesh: Optional[MeshStep] = None) -> dict:
    """One update from the batch `days`; returns the step's aux sums. A
    `compute_dtype` other than float32 takes the mixed step, whose
    `loss_scale_cfg` is (growth, backoff, growth_interval, floor); its aux
    also holds the loss scale after the step (a host float32). `probes`
    adds the step's health probes to the aux; `remat` "dots" or "full"
    recomputes the day loss's forward in the backward. On a `mesh` the
    rank steps its slice of `days` (the module docstring)."""
    model, optimizer = state.model, state.optimizer
    mixed = compute_dtype != torch.float32
    optimizer.zero_grad(set_to_none=True)
    params = cast_compute(model, compute_dtype) if mixed else None
    n = dataset.values.shape[0]
    # drawn before the forward, so a checkpoint's recompute sees the same noise
    eps, keep = day_noise(model, state.generator, days.shape[0],
                          n * (mesh.sp if mesh else 1), train=True, device=days.device)
    extra = {}
    if mesh is not None:
        eps, keep = mesh.noise(eps, keep, n)
        extra = dict(stock=mesh.stock, total_days=torch.sum((days >= 0).to(torch.float32)))
        days = mesh.days(days)
    loss, aux = rematerialized(remat, weighted_day_loss, model, dataset, days,
                               train=True, eps=eps, keep=keep, params=params,
                               probes=probes, **extra)
    if mixed:
        (loss * float(state.loss_scale)).backward()
        if mesh is not None:
            reduce_gradients(_grads(model), mesh.grad_axis, mesh.sp)
        inv = float(np.float32(1.0) / state.loss_scale)
        for g in _grads(model):
            g.mul_(inv)
    else:
        loss.backward()
        if mesh is not None:
            reduce_gradients(_grads(model), mesh.grad_axis, mesh.sp)
    if poison:
        for g in _grads(model):
            g.mul_(float("nan"))
    apply, ok = True, None
    if guard or mixed:
        ok = all_finite(_grads(model))
        aux["skipped"] = (~ok).to(torch.float32)
        apply = bool(ok)          # the gate's one host read per step
    if probes:
        params = list(model.parameters())
        aux.update(grad_probes(_grads(model)))
        before = flatten(params)
    if apply:
        optimizer.step()
        state.scheduler.step()
    if probes:
        # a skipped step reads NaN, as optax's un-gated update does
        aux.update(update_probes(before, params, None if apply else ok))
    state.step += 1
    if mixed:
        state.loss_scale, state.good_steps = walk_loss_scale(
            state.loss_scale, state.good_steps, apply, loss_scale_cfg)
        aux["loss_scale"] = state.loss_scale
    return aux


def walk_loss_scale(scale: np.float32, good: int, ok: bool, cfg: tuple):
    """(scale, good) after one step, in float32, as the JAX package's
    in-graph walk: good = ok ? good + 1 : 0; grow = good >= interval; scale
    = ok ? (grow ? scale * growth : scale) : max(scale * backoff, floor);
    good = grow ? 0 : good."""
    growth, backoff, interval, floor = (np.float32(cfg[0]), np.float32(cfg[1]),
                                        int(cfg[2]), np.float32(cfg[3]))
    good = good + 1 if ok else 0
    grow = good >= interval
    if ok:
        scale = scale * growth if grow else scale
    else:
        scale = max(scale * backoff, floor)
    return np.float32(scale), (0 if grow else good)


def loss_scale_probes(scales: list, floor: float) -> dict:
    """The epoch's loss-scale metrics from each step's scale
    (`factorvae_tpu/obs/probes.loss_scale_probes`): the scale after the last
    step, and the steps that left it at or below the floor."""
    return {"loss_scale": float(scales[-1]),
            "loss_scale_floor_steps": float(sum(s <= np.float32(floor) for s in scales))}


def _accumulate(total: Optional[dict], aux: dict) -> dict:
    if total is None:
        return aux
    return {k: MERGE[k](total[k], aux[k]) if k in MERGE else total[k] + aux[k]
            for k in total}


def finalize_train(sums: dict) -> dict:
    days = torch.clamp(sums["days"], min=1.0)
    m = {"loss": sums["loss_sum"] / days, "recon": sums["recon_sum"] / days,
         "kl": sums["kl_sum"] / days, "days": sums["days"]}
    if "skipped" in sums:
        m["skipped_steps"] = sums["skipped"]
    if "probe_steps" in sums:
        m.update(finalize_train_probes(sums, days))
    return m


def finalize_eval(sums: dict) -> dict:
    m = finalize_train(sums)
    m["loss_sample_weighted"] = sums["wloss_sum"] / torch.clamp(sums["samples"], min=1.0)
    if "nf_loss" in sums:
        m.update(finalize_eval_probes(sums, torch.clamp(sums["days"], min=1.0)))
    return m


def to_host(metrics: dict) -> dict:
    """Device scalars -> floats, in one copy."""
    keys = list(metrics)
    values = torch.stack([metrics[k].to(torch.float32) for k in keys]).tolist()
    return dict(zip(keys, values))


def train_epoch(state: TrainState, chunks, *, guard: bool, poison: bool = False,
                compute_dtype: torch.dtype = torch.float32,
                loss_scale_cfg: Optional[tuple] = None, probes: bool = False,
                remat: str = "none", mesh: Optional[MeshStep] = None) -> dict:
    """The epoch's (dataset, order (steps, B)) chunks, in step order
    (`data/stream.epoch_chunks`) -> the epoch's metrics (floats); a mixed
    epoch's also hold `loss_scale_probes`, a probed one `TRAIN_PROBE_KEYS`.
    On a `mesh` the metrics are the whole update's, on every rank."""
    sums, scales = None, []
    for dataset, order in chunks:
        for i in range(order.shape[0]):
            aux = train_step(state, dataset, order[i], guard=guard, poison=poison,
                             compute_dtype=compute_dtype, loss_scale_cfg=loss_scale_cfg,
                             probes=probes, remat=remat, mesh=mesh)
            if "loss_scale" in aux:
                scales.append(aux.pop("loss_scale"))
            sums = _accumulate(sums, aux)
    if mesh is not None:
        sums = mesh.reduce_sums(sums)
    metrics = to_host(finalize_train(sums))
    if scales:
        metrics.update(loss_scale_probes(scales, loss_scale_cfg[3]))
    return metrics


@torch.no_grad()
def eval_epoch(model, chunks, generator: torch.Generator,
               compute_dtype: torch.dtype = torch.float32, probes: bool = False,
               mesh: Optional[MeshStep] = None) -> dict:
    """Validation metrics over the (dataset, order (steps, B)) chunks:
    dropout off, the reconstruction still sampled (the reference's
    validate()), `generator` drawn across the chunks in order. A
    `compute_dtype` other than float32 computes with the model's compute
    copy, as a mixed run's train steps do; `probes` adds
    `EVAL_PROBE_KEYS`. On a `mesh` each rank takes its days and stocks of
    noise drawn at the whole batch's shape, as the train step does."""
    params = cast_compute(model, compute_dtype) if compute_dtype != torch.float32 else None
    sums = None
    for dataset, order in chunks:
        for i in range(order.shape[0]):
            days, extra = order[i], {}
            if mesh is not None:
                n = dataset.values.shape[0]
                eps, _ = day_noise(model, generator, days.shape[0], n * mesh.sp,
                                   train=False, device=days.device)
                eps, _ = mesh.noise(eps, None, n)
                extra = dict(eps=eps, stock=mesh.stock)
                days = mesh.days(days)
            _, aux = weighted_day_loss(model, dataset, days, train=False,
                                       generator=generator, params=params, probes=probes,
                                       **extra)
            sums = _accumulate(sums, aux)
    if mesh is not None:
        sums = mesh.reduce_sums(sums)
    return to_host(finalize_eval(sums))


# ---- fleets: S models per step ----------------------------------------------


def lane_batch(dataset, days: torch.Tensor):
    """(x, y, mask) of lane-axis day batches days (S, B): each lane's own
    days, gathered in one call; padding days (-1) are fully masked."""
    s, b = days.shape
    x, y, mask = batch_for(dataset, days.reshape(-1))
    return (x.reshape((s, b) + tuple(x.shape[1:])), y.reshape(s, b, -1),
            mask.reshape(s, b, -1))


def lane_noise(model, generators, b: int, n: int, *, train: bool, device):
    """Each lane's noise of one forward over B days of N stocks, drawn from
    its own generator as its solo run's model draws it, in that order: the
    decoder's eps (B, N), then with train and dropout the predictor's keep
    mask (B, K, N). Returns (eps (S, B, N), keep (S, B, K, N) or None)."""
    noise = [day_noise(model, g, b, n, train=train, device=device) for g in generators]
    keep = [k for _, k in noise]
    return (torch.stack([e for e, _ in noise]),
            None if keep[0] is None else torch.stack(keep))


def lane_day_loss(model, params: dict, dataset, days: torch.Tensor, *, train: bool,
                  generators, kl_weight: Optional[torch.Tensor] = None,
                  probes: bool = False, noise: Optional[tuple] = None,
                  mesh: Optional[MeshStep] = None):
    """(loss (S,), aux of (S,) sums): `weighted_day_loss` of S models at once,
    lane i with its parameters params[name][i], its day batch days[i] and
    its own noise, through `torch.func.vmap` over `call_with`. With
    `kl_weight` (S,) each lane's loss is recon + kl_weight[i] * kl (a
    hyper-fleet's runtime scalar); without it the model's own loss. `probes`
    adds each lane's `loss_probes`. `noise` is `lane_noise`'s (eps, keep);
    the train step draws it first, an eval draws it here. On a `mesh` the
    dataset holds this rank's stocks and `noise` the whole update's, of
    which each lane keeps this rank's days and stocks; `days` are the whole
    update's, of which the rank takes its day slice (its 'host' share on a
    hierarchical mesh), and each lane's loss divides by the real days of
    its whole update."""
    n = dataset.values.shape[0]
    eps, keep = noise or lane_noise(model, generators, days.shape[1],
                                    n * (mesh.sp if mesh else 1), train=train,
                                    device=days.device)
    kw, total = {}, None
    if mesh is not None:
        eps, keep = mesh.noise(eps, keep, n)
        kw["stock"] = mesh.stock
        total = torch.sum((days >= 0).to(torch.float32), dim=1)
        days = mesh.days(days)
    x, y, mask = lane_batch(dataset, days)
    stock = kw.get("stock")

    def one(p, x, y, mask, d, eps, keep, klw, total):
        day_w = (d >= 0).to(torch.float32)
        out = call_with(model, p, "day_batched_forward", x, y, mask, train=train,
                        eps=eps, keep=keep, **kw)
        per_day = out.loss if klw is None else out.recon_loss + klw * out.kl
        loss_sum = torch.sum(per_day * day_w)
        count = torch.sum(day_w)
        n_valid = psum(torch.sum(mask, dim=-1).to(torch.float32), stock) * day_w
        aux = {"loss_sum": loss_sum, "recon_sum": torch.sum(out.recon_loss * day_w),
               "kl_sum": torch.sum(out.kl * day_w), "days": count,
               "wloss_sum": torch.sum(per_day * n_valid), "samples": torch.sum(n_valid)}
        if probes:
            aux.update(loss_probes(out, day_w))
        return loss_sum / torch.clamp(count if total is None else total, min=1.0), aux

    in_dims = (0, 0, 0, 0, 0, 0, None if keep is None else 0,
               None if kl_weight is None else 0, None if total is None else 0)
    loss, aux = torch.func.vmap(one, in_dims=in_dims, randomness="error")(
        params, x, y, mask, days, eps, keep, kl_weight, total)
    return loss, {k: v.detach() for k, v in aux.items()}


def lane_all_finite(tensors) -> torch.Tensor:
    """(S,) device bools: every element of lane i of every (S, ...) tensor is
    finite."""
    return torch.stack([torch.isfinite(t).reshape(t.shape[0], -1).all(dim=1)
                        for t in tensors]).all(dim=0)


def _lane_view(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.view((-1,) + (1,) * (like.ndim - 1))


def lane_train_step(model, state: FleetState, dataset, days: torch.Tensor, *,
                    peaks, train_cfg, total_steps: int, guard: bool,
                    poison: Optional[np.ndarray] = None,
                    compute_dtype: torch.dtype = torch.float32,
                    loss_scale_cfg: Optional[tuple] = None,
                    kl_weight: Optional[torch.Tensor] = None, probes: bool = False,
                    remat: str = "none", mesh: Optional[MeshStep] = None) -> dict:
    """One update of every lane from its batch days[i] (`train_step` lane by
    lane): the gradients of the summed lane losses (lane i's part is its
    own loss's, the lanes sharing nothing), lane i's loss scale on a mixed
    fleet, the NaN poison on the lanes `poison` flags, then the per-lane
    finite guard and `lane_adam_step` with lane i's peak lr `peaks[i]`.
    Returns the step's aux sums, each (S,); a mixed fleet's also hold the
    (S,) loss scales after the step (host float32). On a `mesh` (a
    stacked `MeshStep`) the state holds this rank's lanes and the dataset
    its stocks; the noise is drawn at the whole update's shape, and the
    gradients are reduced over the day axes and 'stock' (`MeshStep`)."""
    params = state.params
    for p in params.values():
        p.grad = None
    mixed = compute_dtype != torch.float32
    use = cast_params(model, params, compute_dtype) if mixed else params
    # drawn before the forward, so a checkpoint's recompute sees the same noise
    noise = lane_noise(model, state.generators, days.shape[1],
                       dataset.values.shape[0] * (mesh.sp if mesh else 1),
                       train=True, device=days.device)
    loss, aux = rematerialized(remat, lane_day_loss, model, use, dataset, days, train=True,
                               generators=state.generators, kl_weight=kl_weight,
                               probes=probes, noise=noise, mesh=mesh)
    grads = lambda: [p.grad for p in params.values() if p.grad is not None]  # noqa: E731
    device = loss.device
    if mixed:
        scale = torch.as_tensor(state.loss_scale, device=device)
        (loss * scale).sum().backward()
        if mesh is not None:
            reduce_gradients(grads(), mesh.grad_axis, mesh.sp)
        inv = torch.as_tensor(np.float32(1.0) / state.loss_scale, device=device)
        for g in grads():
            g.mul_(_lane_view(inv, g))
    else:
        loss.sum().backward()
        if mesh is not None:
            reduce_gradients(grads(), mesh.grad_axis, mesh.sp)
    if poison is not None and poison.any():
        factor = torch.as_tensor(np.where(poison, np.float32("nan"), np.float32(1.0)),
                                 device=device)
        for g in grads():
            g.mul_(_lane_view(factor, g))
    lanes = state.num_lanes
    apply = np.ones(lanes, bool)
    ok = None
    if guard or mixed:
        ok = lane_all_finite(grads())
        aux["skipped"] = (~ok).to(torch.float32)
        apply = ok.cpu().numpy()          # the gate's one host read per step
    if probes:
        tensors = list(params.values())
        aux.update(grad_probes(grads(), lanes))
        before = flatten(tensors, lanes)
    lane_adam_step(state, peaks, train_cfg, total_steps, apply)
    if probes:
        aux.update(update_probes(before, tensors, ok, lanes))
    state.steps = state.steps + 1
    if mixed:
        walked = [walk_loss_scale(s, int(g), bool(a), loss_scale_cfg)
                  for s, g, a in zip(state.loss_scale, state.good_steps, apply)]
        state.loss_scale = np.asarray([w[0] for w in walked], np.float32)
        state.good_steps = np.asarray([w[1] for w in walked], np.int64)
        aux["loss_scale"] = state.loss_scale.copy()
    return aux


def lane_train_epoch(model, state: FleetState, chunks, *, peaks, train_cfg,
                     total_steps: int, guard: bool, poison: Optional[np.ndarray] = None,
                     compute_dtype: torch.dtype = torch.float32,
                     loss_scale_cfg: Optional[tuple] = None,
                     kl_weight: Optional[torch.Tensor] = None,
                     probes: bool = False, remat: str = "none",
                     mesh: Optional[MeshStep] = None) -> dict:
    """The epoch's (dataset, order (S, steps, B)) chunks, lane i's own day
    order -> the epoch's metrics, each a list of S floats (`train_epoch`
    lane by lane); on a `mesh`, of this rank's lanes."""
    sums, scales = None, []
    for dataset, order in chunks:
        for i in range(order.shape[1]):
            aux = lane_train_step(model, state, dataset, order[:, i], peaks=peaks,
                                  train_cfg=train_cfg, total_steps=total_steps, guard=guard,
                                  poison=poison, compute_dtype=compute_dtype,
                                  loss_scale_cfg=loss_scale_cfg, kl_weight=kl_weight,
                                  probes=probes, remat=remat, mesh=mesh)
            if "loss_scale" in aux:
                scales.append(aux.pop("loss_scale"))
            sums = _accumulate(sums, aux)
    if mesh is not None:
        sums = mesh.reduce_sums(sums)
    metrics = to_host(finalize_train(sums))
    if scales:
        probes = [loss_scale_probes([s[i] for s in scales], loss_scale_cfg[3])
                  for i in range(state.num_lanes)]
        for key in probes[0]:
            metrics[key] = [p[key] for p in probes]
    return metrics


@torch.no_grad()
def lane_eval_epoch(model, params: dict, chunks, generators,
                    compute_dtype: torch.dtype = torch.float32,
                    kl_weight: Optional[torch.Tensor] = None,
                    probes: bool = False, mesh: Optional[MeshStep] = None) -> dict:
    """Validation metrics of S models over the (dataset, shared order
    (steps, B)) chunks, lane i with its parameters and its generator -> each
    metric a list of S floats (`eval_epoch` lane by lane); on a `mesh`, of
    this rank's lanes over its stocks."""
    if compute_dtype != torch.float32:
        params = cast_params(model, params, compute_dtype)
    lanes = len(generators)
    sums = None
    for dataset, order in chunks:
        for i in range(order.shape[0]):
            days = order[i].expand(lanes, -1)
            _, aux = lane_day_loss(model, params, dataset, days, train=False,
                                   generators=generators, kl_weight=kl_weight,
                                   probes=probes, mesh=mesh)
            sums = _accumulate(sums, aux)
    if mesh is not None:
        sums = mesh.reduce_sums(sums)
    return to_host(finalize_eval(sums))
