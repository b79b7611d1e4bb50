"""GRU recurrence: forward (K1) and backward (K2, K3) CUDA kernels, their
plain versions, and the autograd Function that joins them.

Replaces the Pallas TPU kernels of `factorvae_tpu/ops/pallas/gru.py`
(`gru_scan`): `_fwd_kernel` (K1, `csrc/gru_fwd.cu`) and the two backward
kernels `_bwd_kernel` (K2, T <= 24) and `_bwd_seg_kernel` (K3, T > 24),
which one CUDA kernel serves at every T (`csrc/gru_bwd.cu`). Each source's
header comment says what bounds the kernel on an H100 and how its design
meets it.

`gru_fwd` and `gru_bwd` launch their kernels for CUDA tensors and run
`gru_fwd_plain` / `gru_bwd_plain` for CPU tensors; there is no fallback
between the two. `gru` is the differentiable recurrence: forward K1,
backward K2.
"""

from __future__ import annotations

import ctypes

import torch

from factorvae_tpu_torch import _build


def _gates(x: torch.Tensor, g: torch.Tensor, h_dim: int):
    """r, z, n of one step from xi_t (N, 3H) and g = h . Wh + b (N, 3H)."""
    r = torch.sigmoid(x[:, :h_dim] + g[:, :h_dim])
    z = torch.sigmoid(x[:, h_dim:2 * h_dim] + g[:, h_dim:2 * h_dim])
    n = torch.tanh(x[:, 2 * h_dim:] + r * g[:, 2 * h_dim:])
    return r, z, n


def gru_fwd_plain(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor) -> torch.Tensor:
    """xi (N, T, 3H), w_h (H, 3H), b_h (3H,) -> last hidden state (N, H).

    The recurrence written out in PyTorch, gates in torch order [r | z | n]
    as in the TPU kernel: n = tanh(x_n + r * (h . Wh_n + b_n))."""
    n, t_len, h3 = xi.shape
    h_dim = h3 // 3
    h = torch.zeros((n, h_dim), dtype=xi.dtype, device=xi.device)
    for t in range(t_len):
        r, z, nn_ = _gates(xi[:, t], h @ w_h + b_h, h_dim)
        h = (1.0 - z) * nn_ + z * h
    return h


def gru_bwd_plain(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
                  dh: torch.Tensor):
    """The VJP of `gru_fwd_plain`: (xi, w_h, b_h, dh (N, H)) -> (dxi (N, T,
    3H), dw_h (H, 3H), db_h (3H,)).

    Recompute-BPTT, the hand-derived gate VJP of the TPU kernels'
    `_backward_walk`: re-run the recurrence keeping h before each step, then
    walk t backwards carrying dh."""
    n, t_len, h3 = xi.shape
    h_dim = h3 // 3
    h = torch.zeros((n, h_dim), dtype=xi.dtype, device=xi.device)
    h_before = []
    for t in range(t_len):
        h_before.append(h)
        r, z, nn_ = _gates(xi[:, t], h @ w_h + b_h, h_dim)
        h = (1.0 - z) * nn_ + z * h
    dxi = torch.empty_like(xi)
    dw_h = torch.zeros_like(w_h)
    db_h = torch.zeros_like(b_h)
    for t in range(t_len - 1, -1, -1):
        h_prev = h_before[t]
        g = h_prev @ w_h + b_h
        r, z, nn_ = _gates(xi[:, t], g, h_dim)
        dz = dh * (h_prev - nn_)
        dn = dh * (1.0 - z)
        dtanh = dn * (1.0 - nn_ * nn_)              # d(x_n + r * g_n)
        dr = dtanh * g[:, 2 * h_dim:]
        dghn = dtanh * r
        dghr = dr * r * (1.0 - r)                   # d(x_r + g_r)
        dghz = dz * z * (1.0 - z)                   # d(x_z + g_z)
        dxi[:, t] = torch.cat([dghr, dghz, dtanh], dim=1)
        dg = torch.cat([dghr, dghz, dghn], dim=1)
        dh = dh * z + dg @ w_h.T
        dw_h = dw_h + h_prev.T @ dg
        db_h = db_h + dg.sum(dim=0)
    return dxi, dw_h, db_h


def _check(name: str, xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor,
           dh: torch.Tensor = None) -> None:
    if xi.ndim != 3 or xi.shape[-1] % 3:
        raise ValueError(f"{name}: xi must be (N, T, 3H); got {tuple(xi.shape)}")
    n, _, h3 = xi.shape
    h_dim = h3 // 3
    if tuple(w_h.shape) != (h_dim, h3) or tuple(b_h.shape) != (h3,):
        raise ValueError(
            f"{name}: w_h must be ({h_dim}, {h3}) and b_h ({h3},); got "
            f"{tuple(w_h.shape)} and {tuple(b_h.shape)}")
    tensors = {"xi": xi, "w_h": w_h, "b_h": b_h}
    if dh is not None:
        if tuple(dh.shape) != (n, h_dim):
            raise ValueError(f"{name}: dh must be ({n}, {h_dim}); got {tuple(dh.shape)}")
        tensors["dh"] = dh
    if xi.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors; got {xi.device}")
    if xi.device.type == "cpu":
        return
    for key, a in tensors.items():
        if a.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32; got {a.dtype}")
        if a.device != xi.device:
            raise ValueError(f"{name}: {key} is on {a.device}, xi on {xi.device}")


def _lib(name: str):
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        if name == "gru_fwd":
            lib.gru_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            lib.gru_fwd.restype = ctypes.c_int
        else:
            lib.gru_bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            lib.gru_bwd.restype = ctypes.c_int
            lib.gru_bwd_scratch_floats.argtypes = [ctypes.c_int] * 3
            lib.gru_bwd_scratch_floats.restype = ctypes.c_longlong
        getattr(lib, f"{name}_max_hidden").restype = ctypes.c_int
        lib._typed = True
    return lib


def _check_hidden(name: str, lib, h_dim: int) -> None:
    cap = getattr(lib, f"{name}_max_hidden")()
    if h_dim > cap:
        raise ValueError(
            f"{name}: hidden size {h_dim} exceeds the kernel's maximum {cap}")


def gru_fwd(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor) -> torch.Tensor:
    """Fused recurrence: xi (N, T, 3H), w_h (H, 3H), b_h (3H,) -> (N, H) f32."""
    _check("gru_fwd", xi, w_h, b_h)
    if xi.device.type == "cpu":
        return gru_fwd_plain(xi, w_h, b_h)
    n, t_len, h3 = xi.shape
    h_dim = h3 // 3
    lib = _lib("gru_fwd")
    _check_hidden("gru_fwd", lib, h_dim)
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


def gru_bwd(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor, dh: torch.Tensor):
    """The recurrence's VJP: (xi (N, T, 3H), w_h (H, 3H), b_h (3H,), dh
    (N, H)) -> (dxi, dw_h, db_h), f32. One launch (the walk and the
    deterministic reduction of the blocks' partial dWh/db) for any T."""
    _check("gru_bwd", xi, w_h, b_h, dh)
    if xi.device.type == "cpu":
        return gru_bwd_plain(xi, w_h, b_h, dh)
    n, t_len, h3 = xi.shape
    h_dim = h3 // 3
    lib = _lib("gru_bwd")
    _check_hidden("gru_bwd", lib, h_dim)
    xi, w_h, b_h, dh = (a.contiguous() for a in (xi, w_h, b_h, dh))
    dxi = torch.empty_like(xi)
    dw_h = torch.zeros_like(w_h)
    db_h = torch.zeros_like(b_h)
    if n == 0:
        return dxi, dw_h, db_h
    scratch = torch.empty(lib.gru_bwd_scratch_floats(n, t_len, h_dim),
                          dtype=torch.float32, device=xi.device)
    with torch.cuda.device(xi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gru_bwd(xi.data_ptr(), w_h.data_ptr(), b_h.data_ptr(),
                          dh.data_ptr(), dxi.data_ptr(), dw_h.data_ptr(),
                          db_h.data_ptr(), scratch.data_ptr(), n, t_len, h_dim,
                          stream)
    if err != 0:
        raise RuntimeError(f"gru_bwd launch failed at N={n}, T={t_len}, "
                           f"H={h_dim}: cudaError {err}")
    gru_bwd.launches += 1
    return dxi, dw_h, db_h


gru_bwd.launches = 0


class _GRUFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xi, w_h, b_h):
        ctx.save_for_backward(xi, w_h, b_h)
        return gru_fwd(xi, w_h, b_h)

    @staticmethod
    def backward(ctx, dh):
        return gru_bwd(*ctx.saved_tensors, dh)


def gru(xi: torch.Tensor, w_h: torch.Tensor, b_h: torch.Tensor) -> torch.Tensor:
    """Differentiable `gru_fwd`: the forward is K1, the backward K2 (the
    plain versions on the CPU)."""
    return _GRUFunction.apply(xi, w_h, b_h)
