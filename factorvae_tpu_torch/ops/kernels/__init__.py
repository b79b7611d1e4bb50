"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every kernel takes one model's tensors or S models' at once, each tensor
then with a leading lane axis (the fleets of `train/fleet.py`); one model's
tensors are a launch of one lane, with no view made. The helpers below run
a plain version lane by lane, and move a `torch.func.vmap` rule's batch
dimension to the front.

Each wrapper's launch runs inside `launch_range(name)`: while a
`torch.profiler` capture runs, the host timeline names the launch (the
kernels, called through ctypes, have no aten op above them); otherwise it
is a null context.
"""

import contextlib
from typing import Optional

import torch

# The largest hidden size every kernel takes: `kMaxH` of csrc/gru_common.cuh
# and csrc/attention_common.cuh (each library's `*_max_hidden()` returns
# it). Each kernel reaches it through instances for H <= 64 (the ones tuned
# first), <= 128 and <= 256, picked per launch. The entry points refuse a
# larger one on a CUDA device before any data is read; the plain versions
# on the CPU take any size.
MAX_HIDDEN = 256


def upcast(*tensors):
    """bfloat16 and float16 tensors as float32, as the TPU kernels' wrappers
    take them; every other tensor (float32 included) as it is. The kernels
    and their plain versions compute in float32 and return float32."""
    return tuple(t.float() if t is not None and t.dtype in (torch.bfloat16, torch.float16)
                 else t for t in tensors)


def hidden_refusal(hidden_size: int, device) -> "str | None":
    """The error line for a hidden size the kernels do not take on a CUDA
    `device`, or None."""
    if torch.device(device).type == "cuda" and hidden_size > MAX_HIDDEN:
        return (f"hidden_size {hidden_size} exceeds the CUDA kernels' maximum of "
                f"{MAX_HIDDEN} (ROADMAP Queue 2 \"Limits\"); the plain versions on "
                "--device cpu take any size")
    return None


def launch_range(name: str):
    """A `record_function` range named `name` while a profiler runs, else a
    null context."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def plain(fn, lanes: bool, *args, **kw):
    """`fn` (a plain version) on one model's tensors, or lane by lane on S
    models' (`lanes`)."""
    return per_lane(fn, *args, **kw) if lanes else fn(*args, **kw)


def per_lane(fn, *args, **kw):
    """`fn` (a plain version) lane by lane over lane-axis tensor arguments
    (None passes through), its outputs stacked on a new lane axis."""
    lanes = next(a for a in args if a is not None).shape[0]
    outs = [fn(*(None if a is None else a[s] for a in args), **kw) for s in range(lanes)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def lane_major(t: Optional[torch.Tensor], dim: Optional[int], lanes: int):
    """A tensor of a `torch.func.vmap` rule with its batch dimension `dim`
    moved to the front, or, unbatched (dim None), expanded to `lanes`
    copies; None stays None."""
    if t is None:
        return None
    return t.movedim(dim, 0) if dim is not None else t.expand(lanes, *t.shape)
