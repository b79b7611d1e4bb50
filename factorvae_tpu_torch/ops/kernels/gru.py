"""GRU recurrence forward (K1): the CUDA kernel and its plain version.

Replaces the Pallas TPU kernel `_fwd_kernel` of
`factorvae_tpu/ops/pallas/gru.py` (`gru_scan`, forward only; the backward
kernels come with the training slice). The CUDA source is
`factorvae_tpu_torch/csrc/gru_fwd.cu`; its header comment says what bounds
the kernel on an H100 (the f32 products h . Wh) and how the design meets it
(Wh staged once in shared memory, h resident for all T steps, one gate
column per thread for a tile of rows).

`gru_fwd` launches the kernel for a CUDA tensor and runs `gru_fwd_plain`
for a CPU tensor; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from factorvae_tpu_torch import _build


def gru_fwd_plain(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor) -> torch.Tensor:
    """xi (N, T, 3H), w_h (H, 3H), b_h (3H,) -> last hidden state (N, H).

    The recurrence written out in PyTorch, gates in torch order [r | z | n]
    as in the TPU kernel: n = tanh(x_n + r * (h . Wh_n + b_n))."""
    n, t_len, h3 = xi.shape
    h_dim = h3 // 3
    h = torch.zeros((n, h_dim), dtype=torch.float32, device=xi.device)
    for t in range(t_len):
        x = xi[:, t]
        g = h @ w_h + b_h
        r = torch.sigmoid(x[:, :h_dim] + g[:, :h_dim])
        z = torch.sigmoid(x[:, h_dim:2 * h_dim] + g[:, h_dim:2 * h_dim])
        nn_ = torch.tanh(x[:, 2 * h_dim:] + r * g[:, 2 * h_dim:])
        h = (1.0 - z) * nn_ + z * h
    return h


def _lib():
    lib = _build.load("gru_fwd")
    if not getattr(lib, "_typed", False):
        lib.gru_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.gru_fwd.restype = ctypes.c_int
        lib.gru_fwd_max_hidden.restype = ctypes.c_int
        lib._typed = True
    return lib


def gru_fwd(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor) -> torch.Tensor:
    """Fused recurrence: xi (N, T, 3H), w_h (H, 3H), b_h (3H,) -> (N, H) f32."""
    if xi.ndim != 3 or xi.shape[-1] % 3:
        raise ValueError(f"xi must be (N, T, 3H); got {tuple(xi.shape)}")
    n, t_len, h3 = xi.shape
    h_dim = h3 // 3
    if tuple(w_h.shape) != (h_dim, h3) or tuple(b_h.shape) != (h3,):
        raise ValueError(
            f"w_h must be ({h_dim}, {h3}) and b_h ({h3},); got "
            f"{tuple(w_h.shape)} and {tuple(b_h.shape)}")
    if xi.device.type == "cpu":
        return gru_fwd_plain(xi, w_h, b_h)
    if xi.device.type != "cuda":
        raise ValueError(f"gru_fwd runs on cuda or cpu tensors; got {xi.device}")
    for name, a in (("xi", xi), ("w_h", w_h), ("b_h", b_h)):
        if a.dtype != torch.float32:
            raise TypeError(f"gru_fwd: {name} must be float32; got {a.dtype}")
        if a.device != xi.device:
            raise ValueError(f"gru_fwd: {name} is on {a.device}, xi on {xi.device}")
    lib = _lib()
    if h_dim > lib.gru_fwd_max_hidden():
        raise ValueError(
            f"gru_fwd: hidden size {h_dim} exceeds the kernel's maximum "
            f"{lib.gru_fwd_max_hidden()}")
    xi, w_h, b_h = xi.contiguous(), w_h.contiguous(), b_h.contiguous()
    out = torch.empty((n, h_dim), dtype=torch.float32, device=xi.device)
    if n == 0:
        return out
    with torch.cuda.device(xi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gru_fwd(xi.data_ptr(), w_h.data_ptr(), b_h.data_ptr(),
                          out.data_ptr(), n, t_len, h_dim, stream)
    if err != 0:
        raise RuntimeError(f"gru_fwd launch failed: cudaError {err}")
    gru_fwd.launches += 1
    return out


gru_fwd.launches = 0
