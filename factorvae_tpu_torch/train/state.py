"""Train state, optimizer and learning-rate schedule (`factorvae_tpu/train/state.py`).

The optimizer is the reference's Adam (lr 1e-4; betas 0.9/0.999 and eps 1e-8,
as `optax.adam`) with a cosine decay whose horizon is steps-per-epoch x
epochs and which advances once per applied update. The lr comes from the
closed form of the cosine, `cfg.lr * 0.5 * (1 + cos(pi * step / total))`,
through `LambdaLR`; the recursive form of `CosineAnnealingLR` drifts from
optax by rounding. `set_lr_scale` scales that pair's peak lr (the rollback
recovery's backoff) and keeps Adam's moments and the schedule's position.
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
