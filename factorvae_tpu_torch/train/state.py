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

Fleets (`train/fleet.py`): a `FleetState` stacks S models' parameters and
Adam moments on a leading lane axis, and `lane_adam_step` is the same Adam
with a per-lane peak lr (the counterpart of the JAX package's
`make_hyper_optimizer`), a per-lane cosine position, and a per-lane select
that leaves a lane whose step the finite guard refused exactly as it was.
A mixed fleet carries one loss scale per lane.
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
    float32 gradient unchanged. Plain torch, so `torch.func.vmap` generates
    its rule."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

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
    return cast_params(model, dict(model.named_parameters()), dtype)


def cast_params(model: torch.nn.Module, params: dict, dtype: torch.dtype) -> dict:
    """`cast_compute` of `params` (name -> tensor, `model`'s names; stacked
    (S, ...) fleet parameters too, the cast being elementwise)."""
    to_kernel = {f"{prefix}.{name}" if prefix else name
                 for prefix, m in model.named_modules()
                 for name in getattr(m, "KERNEL_PARAMS", ())}
    return {name: (_RoundThrough.apply(p, dtype) if name in to_kernel else p.to(dtype))
            for name, p in params.items()}


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


def set_horizon(state: TrainState, cfg: TrainConfig, total_steps: int) -> None:
    """Give `state`'s schedule the cosine horizon `total_steps`, at its
    current position (`Trainer.fit(rescale_schedule=True)` on a state made
    for another horizon); call `set_lr_scale` after it."""
    state.scheduler.lr_lambdas = [_factor(cfg, total_steps)]


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


@dataclasses.dataclass
class FleetState:
    """S models trained in lockstep (`train/fleet.py`), every per-model value
    on a leading lane axis: the parameters (name -> (S, ...) leaf tensors),
    Adam's moments, the applied updates of each lane (its Adam step count
    and cosine position), its noise generator, its train steps taken
    (skipped ones included) and, on a mixed fleet, its loss scale and
    finite steps in a row. Lane i holds what a solo `TrainState` of lane i's
    config holds (`fleet.unstack_state`)."""

    params: dict
    exp_avg: dict
    exp_avg_sq: dict
    counts: np.ndarray                 # (S,) int64
    generators: list
    steps: np.ndarray                  # (S,) int64
    loss_scale: Optional[np.ndarray] = None    # (S,) float32
    good_steps: Optional[np.ndarray] = None    # (S,) int64

    @property
    def num_lanes(self) -> int:
        return len(self.generators)


def lane_learning_rates(peaks, counts, cfg: TrainConfig, total_steps: int) -> np.ndarray:
    """(S,) float64: lane i's lr at its next update, `peaks[i]` times the
    cosine at its own applied-update count, as `LambdaLR` computes it."""
    factor = _factor(cfg, total_steps)
    return np.asarray([float(p) * factor(int(c)) for p, c in zip(peaks, counts)])


@torch.no_grad()
def lane_adam_step(state: FleetState, peaks, cfg: TrainConfig, total_steps: int,
                   apply: np.ndarray) -> None:
    """One Adam update of every lane whose `apply` flag is set, from the
    stacked gradients on `state.params`: torch's Adam (betas 0.9/0.999, eps
    1e-8, bias corrections in double on the host) with lane i's peak lr
    `peaks[i]` on its own cosine position. A lane without the flag keeps its
    parameters, moments and count exactly (a select), as the serial guard
    skips `optimizer.step()`."""
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    apply = np.asarray(apply, bool)
    if not apply.any():
        return
    lr = lane_learning_rates(peaks, state.counts, cfg, total_steps)
    step = (state.counts + 1).astype(np.float64)
    # the update's per-lane scalars, as torch's Adam forms them: -lr / (1 -
    # beta1^t) and sqrt(1 - beta2^t), rounded to float32 at the kernel
    neg_step = [-(a / (1.0 - beta1 ** t)) for a, t in zip(lr, step)]
    bc2_sqrt = [(1.0 - beta2 ** t) ** 0.5 for t in step]
    some = not apply.all()
    first = next(iter(state.params.values()))
    device = first.device
    neg_step = torch.tensor(neg_step, dtype=torch.float32, device=device)
    bc2_sqrt = torch.tensor(bc2_sqrt, dtype=torch.float32, device=device)
    keep = torch.as_tensor(apply, device=device)
    for name, p in state.params.items():
        g = p.grad
        shape = (-1,) + (1,) * (p.ndim - 1)
        m, v = state.exp_avg[name], state.exp_avg_sq[name]
        m_new = m.lerp(g, 1 - beta1)
        v_new = v.mul(beta2).addcmul_(g, g, value=1 - beta2)
        denom = (v_new.sqrt() / bc2_sqrt.view(shape)).add_(eps)
        p_new = p + neg_step.view(shape) * m_new / denom
        if some:
            lane = keep.view(shape)
            m_new = torch.where(lane, m_new, m)
            v_new = torch.where(lane, v_new, v)
            p_new = torch.where(lane, p_new, p)
        m.copy_(m_new)
        v.copy_(v_new)
        p.copy_(p_new)
    state.counts = state.counts + apply.astype(np.int64)
