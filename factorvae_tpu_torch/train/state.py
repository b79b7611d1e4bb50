"""Train state, optimizer and learning-rate schedule (`factorvae_tpu/train/state.py`).

The optimizer is the reference's Adam (lr 1e-4; betas 0.9/0.999 and eps 1e-8,
as `optax.adam`) with a cosine decay whose horizon is steps-per-epoch x
epochs and which advances once per applied update. The lr comes from the
closed form of the cosine, `cfg.lr * 0.5 * (1 + cos(pi * step / total))`,
through `LambdaLR`; the recursive form of `CosineAnnealingLR` drifts from
optax by rounding. `set_lr_scale` scales that pair's peak lr (the rollback
recovery's backoff) and keeps Adam's moments and the schedule's position.

The precision ladder (`factorvae_tpu/train/state.py`): `resolve_train_dtype`
decides a run's training compute dtype; a bfloat16 run keeps float32 master
weights and a float32 optimizer, and each step computes with
`cast_compute`'s bfloat16 copy of the masters, made inside the
differentiated function so the gradients land on the masters in float32.
Such a run's state also carries the dynamic loss scale and the count of
finite steps in a row (`loss_scale`, `good_steps`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch.optim.lr_scheduler import LambdaLR

from factorvae_tpu_torch.config import TrainConfig


@dataclasses.dataclass
class TrainState:
    """Everything a resumed run needs to continue exactly: the model, Adam's
    moments and step count, the schedule's position, the noise generator and
    the number of train steps taken (skipped ones included)."""

    model: torch.nn.Module
    optimizer: torch.optim.Adam
    scheduler: LambdaLR
    generator: torch.Generator
    step: int = 0
    # mixed runs only (None on float32 runs): the loss scale, a float32
    # value, and the finite steps in a row since it last changed
    loss_scale: Optional[np.float32] = None
    good_steps: Optional[int] = None


TRAIN_DTYPES = ("float32", "bfloat16")


def resolve_train_dtype(train_cfg: TrainConfig, model_cfg) -> str:
    """The training compute dtype: `train.compute_dtype` when set, else
    `model.compute_dtype`. int8 and anything else outside the ladder raise:
    int8 is a serving rung (weight-only scoring), with no gradient."""
    dtype = train_cfg.compute_dtype or model_cfg.compute_dtype
    if dtype not in TRAIN_DTYPES:
        raise ValueError(
            f"train compute dtype {dtype!r} is not in the training ladder "
            f"{TRAIN_DTYPES}: int8 is a serving rung (weight-only scoring); "
            "training runs float32 masters with an optional bfloat16 compute cast")
    return dtype


class _RoundThrough(torch.autograd.Function):
    """float32 -> `dtype` -> float32 in the forward; the backward passes the
    float32 gradient unchanged."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def cast_compute(model: torch.nn.Module, dtype: torch.dtype) -> dict:
    """The compute copy of `model`'s float32 master parameters for a mixed
    step (parameter name -> tensor, for `models.factorvae.call_with`).

    A parameter that PyTorch ops consume becomes a `dtype` tensor; its
    gradient comes back in `dtype`, as XLA's cotangent of the JAX package's
    cast does. A parameter that enters a CUDA kernel (a module's
    `KERNEL_PARAMS`) becomes a float32 tensor holding the `dtype`-rounded
    values, whose gradient reaches the master unrounded: the JAX package's
    kernels take the bfloat16 weight, compute in float32 and return a
    float32 gradient, which JAX does not round at the kernel's boundary.
    Call it inside the differentiated function."""
    to_kernel = {f"{prefix}.{name}" if prefix else name
                 for prefix, m in model.named_modules()
                 for name in getattr(m, "KERNEL_PARAMS", ())}
    return {name: (_RoundThrough.apply(p, dtype) if name in to_kernel else p.to(dtype))
            for name, p in model.named_parameters()}


def mixed_fields(cfg: TrainConfig) -> dict:
    """A mixed run's starting `loss_scale` and `good_steps`."""
    return {"loss_scale": np.float32(cfg.loss_scale_init), "good_steps": 0}


def cosine_factor(step: int, total_steps: int) -> float:
    """optax `cosine_decay_schedule(alpha=0)` over `total_steps`, as a
    multiplier of the peak lr."""
    return 0.5 * (1.0 + math.cos(math.pi * min(step, total_steps) / total_steps))


def learning_rate_at(cfg: TrainConfig, total_steps: int, step: int,
                     lr_scale: float = 1.0) -> float:
    """The lr of update `step` (0-based) at a peak of `cfg.lr * lr_scale`."""
    lr = cfg.lr * float(lr_scale)
    if cfg.cosine_schedule and total_steps:
        return lr * cosine_factor(step, total_steps)
    return lr


def _factor(cfg: TrainConfig, total_steps: Optional[int]):
    if cfg.cosine_schedule and total_steps:
        return lambda step: cosine_factor(step, total_steps)
    return lambda step: 1.0


def make_optimizer(params, cfg: TrainConfig, total_steps: Optional[int] = None):
    """(Adam, LambdaLR) for `params`; call `scheduler.step()` once after each
    applied `optimizer.step()`."""
    optimizer = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    return optimizer, LambdaLR(optimizer, _factor(cfg, total_steps))


def set_lr_scale(state: TrainState, cfg: TrainConfig, lr_scale: float = 1.0) -> None:
    """Set `state`'s peak lr to `cfg.lr * lr_scale`, at the schedule's current
    position. Adam's moments and step count stay. `LambdaLR.load_state_dict`
    restores the peak a checkpoint was saved with, so call this after a
    restore."""
    sched = state.scheduler
    peak = cfg.lr * float(lr_scale)
    sched.base_lrs = [peak] * len(sched.base_lrs)
    lr = peak * sched.lr_lambdas[0](sched.last_epoch)
    for group in state.optimizer.param_groups:
        group["initial_lr"], group["lr"] = peak, lr
    sched._last_lr = [lr] * len(sched.base_lrs)


def seed_for(*words: int) -> int:
    """A 63-bit seed for one noise stream, derived from integers (the run's
    seed and a stream id), so that streams of one run do not overlap."""
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))
