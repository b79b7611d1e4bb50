"""K-head cross-section attention forward (K4): the CUDA kernel and its
plain version.

Replaces the Pallas TPU kernel `_head_kernel` of
`factorvae_tpu/ops/pallas/attention.py` (`multihead_cross_section_attention`,
which the JAX predictor reaches through `attention_grad.fused_attention` and
vmaps over days). This kernel takes the day axis directly. The CUDA source is
`factorvae_tpu_torch/csrc/attention_fwd.cu`; its header comment says what
bounds the kernel on an H100 (the f32 key and value products) and how the
design meets it (one block per (day, head), head weights and scores in
shared memory, the (K, N, H) key/value stacks never written out).

`attention_fwd` launches the kernel for CUDA tensors and runs
`attention_fwd_plain` for CPU tensors; there is no fallback between the two.
The serving path passes no keep-mask; the training slice will.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from factorvae_tpu_torch import _build
from factorvae_tpu_torch.ops.masked import masked_softmax


def attention_fwd_plain(latent, mask, query, w_key, b_key, w_val, b_val,
                        keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """latent (B, N, H), mask (B, N) bool, query (K, H), w_key/w_val
    (K, H, H), b_key/b_val (K, H), keep (B, K, N) or None -> ctx (B, K, H).

    The batched einsum form of the predictor (`models/predictor.py`
    `day_batched` in the JAX package): scores -> keep-mask -> ReLU ->
    masked softmax over stocks, a head with a non-finite valid score gives
    a zero context, values pass through nan_to_num."""
    h = latent.shape[-1]
    keys = torch.einsum("bnh,khj->bknj", latent, w_key) + b_key[None, :, None, :]
    values = torch.einsum("bnh,khj->bknj", latent, w_val) + b_val[None, :, None, :]
    scale = torch.sqrt(torch.tensor(float(h), dtype=torch.float32,
                                    device=latent.device) + 1e-6)
    scores = torch.einsum("kh,bknh->bkn", query, keys) / scale
    if keep is not None:
        scores = scores * keep
    scores = torch.relu(scores)
    valid = mask[:, None, :]
    attn = masked_softmax(scores, valid, dim=-1)
    bad = torch.any(~torch.isfinite(torch.where(valid, scores, 0.0)),
                    dim=-1, keepdim=True)
    attn = torch.where(bad, 0.0, attn)
    ctx = torch.einsum("bkn,bknh->bkh", attn, torch.nan_to_num(values))
    return torch.where(bad, 0.0, ctx)


def _lib():
    lib = _build.load("attention_fwd")
    if not getattr(lib, "_typed", False):
        lib.attention_fwd.argtypes = ([ctypes.c_void_p] * 9
                                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.attention_fwd.restype = ctypes.c_int
        lib.attention_fwd_max_hidden.restype = ctypes.c_int
        lib._typed = True
    return lib


def attention_fwd(latent, mask, query, w_key, b_key, w_val, b_val,
                  keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused K-head attention over each day's stocks -> ctx (B, K, H) f32.

    Shapes as in `attention_fwd_plain`."""
    if latent.ndim != 3:
        raise ValueError(f"latent must be (B, N, H); got {tuple(latent.shape)}")
    b, n, h = latent.shape
    k = query.shape[0]
    expect = {"mask": (b, n), "query": (k, h), "w_key": (k, h, h),
              "b_key": (k, h), "w_val": (k, h, h), "b_val": (k, h)}
    if keep is not None:
        expect["keep"] = (b, k, n)
    args = {"mask": mask, "query": query, "w_key": w_key, "b_key": b_key,
            "w_val": w_val, "b_val": b_val, "keep": keep}
    for name, shape in expect.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"attention_fwd: {name} must be {shape}; got "
                             f"{tuple(args[name].shape)}")
    if mask.dtype != torch.bool:
        raise TypeError(f"attention_fwd: mask must be bool; got {mask.dtype}")
    if latent.device.type == "cpu":
        return attention_fwd_plain(latent, mask, query, w_key, b_key, w_val,
                                   b_val, keep)
    if latent.device.type != "cuda":
        raise ValueError(
            f"attention_fwd runs on cuda or cpu tensors; got {latent.device}")
    floats = {"latent": latent, "query": query, "w_key": w_key, "b_key": b_key,
              "w_val": w_val, "b_val": b_val}
    if keep is not None:
        floats["keep"] = keep
    for name, a in floats.items():
        if a.dtype != torch.float32:
            raise TypeError(f"attention_fwd: {name} must be float32; got {a.dtype}")
    for name, a in list(floats.items()) + [("mask", mask)]:
        if a.device != latent.device:
            raise ValueError(
                f"attention_fwd: {name} is on {a.device}, latent on {latent.device}")
    lib = _lib()
    if h > lib.attention_fwd_max_hidden():
        raise ValueError(f"attention_fwd: hidden size {h} exceeds the kernel's "
                         f"maximum {lib.attention_fwd_max_hidden()}")
    out = torch.empty((b, k, h), dtype=torch.float32, device=latent.device)
    if b == 0 or k == 0 or n == 0:
        return out.zero_()
    tensors = [t.contiguous() for t in (latent, mask, query, w_key, b_key,
                                        w_val, b_val)]
    keep_c = keep.contiguous() if keep is not None else None
    ptrs = [t.data_ptr() for t in tensors[:2]]
    ptrs.append(keep_c.data_ptr() if keep_c is not None else None)
    ptrs += [t.data_ptr() for t in tensors[2:]]
    with torch.cuda.device(latent.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.attention_fwd(*ptrs, out.data_ptr(), b, n, k, h, stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed at B={b}, N={n}, K={k}, "
                           f"H={h}: cudaError {err}")
    attention_fwd.launches += 1
    return out


attention_fwd.launches = 0
