"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""

import torch

# The largest hidden size every kernel takes: `kMaxH` of csrc/gru_common.cuh
# and csrc/attention_common.cuh (each library's `*_max_hidden()` returns
# it). The entry points refuse a larger one on a CUDA device before any
# data is read; the plain versions on the CPU take any size.
MAX_HIDDEN = 64


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
