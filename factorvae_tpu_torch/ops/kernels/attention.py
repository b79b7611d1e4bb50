"""K-head cross-section attention: forward (K4) and backward (K5) CUDA
kernels, their plain versions, and the autograd Function that joins them.

Replaces the Pallas TPU kernels `_head_kernel` of
`factorvae_tpu/ops/pallas/attention.py` (`multihead_cross_section_attention`,
K4, `csrc/attention_fwd.cu`) and `_bwd_kernel` of
`factorvae_tpu/ops/pallas/attention_grad.py` (`_bwd_pallas`, K5,
`csrc/attention_bwd.cu`), which the JAX predictor reaches through the custom
VJP `fused_attention` and vmaps over days. These kernels take the day axis
directly. Each source's header comment says what bounds the kernel on an
H100 and how the design meets it: the key and value products folded into
the scores L . (Wk . q) and the context (a^T L) . Wv on a day whose valid
latent rows are finite, the products as written on a day that has a
non-finite one (the exact path); the backward recomputes the forward's
scores and softmax with the forward's own device code. Up to H = 64 one
CTA per (day, group of heads), the heads per CTA from `launch_group`.
Above H = 64 (the wide design, `WIDE_MIN_H`) the weight work that no day
changes (u = Wk q, c = bk q; K5's w = Wv dctx) runs once per launch in a
prep kernel, a cluster of `wide_cluster(h)` CTAs per (day, group of heads)
holds the day's rows in column slices and sums its partial scores in rank
order through DSMEM, K4's context is one kernel over every day of a head
(Wv read once per launch), and `wide_launch_group` picks the heads per
cluster. Neither rule changes a result: no sum depends on the group size.

`attention_fwd_op` is `attention_fwd` without a keep-mask registered as the
op `factorvae_tpu_torch::attention_fwd` (`torch.library.custom_op`), which
`torch.export` records in an exported program's graph.

`attention_fwd` and `attention_bwd` launch their kernels for CUDA tensors
and run `attention_fwd_plain` / `attention_bwd_plain` for CPU tensors; there
is no fallback between the two. `attention` is the differentiable op:
forward K4, backward K5. The training path passes the dropout keep-mask;
the serving path passes none.

Lanes (the fleets of `train/fleet.py`): both wrappers also take S models at
once, each with its own days, every array with a leading lane axis (latent
(S, B, N, H), mask (S, B, N), query (S, K, H), ...), in one launch that
counts once; the plain versions run lane by lane. `attention` carries a
`torch.func.vmap` rule: a vmapped call becomes one lane-axis call on the
unwrapped (S, ...) tensors, so its backward is one lane-axis K5 launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from factorvae_tpu_torch import _build
from factorvae_tpu_torch.ops.kernels import lane_major, launch_range, plain, upcast
from factorvae_tpu_torch.ops.masked import masked_softmax


def _forward_parts(latent, mask, query, w_key, b_key, w_val, b_val, keep):
    """The forward's intermediates, batched over days: keys (B, K, N, H),
    nan_to_num'd values (B, K, N, H), scores s after the keep-mask and before
    the ReLU (B, K, N), softmax weights a (zero for a guarded head), the
    guard `bad` (B, K, 1) and the score scale."""
    h = latent.shape[-1]
    keys = torch.einsum("bnh,khj->bknj", latent, w_key) + b_key[None, :, None, :]
    values = torch.einsum("bnh,khj->bknj", latent, w_val) + b_val[None, :, None, :]
    scale = torch.sqrt(torch.tensor(float(h), dtype=torch.float32,
                                    device=latent.device) + 1e-6)
    s = torch.einsum("kh,bknh->bkn", query, keys) / scale
    if keep is not None:
        s = s * keep
    scores = torch.relu(s)
    valid = mask[:, None, :]
    attn = masked_softmax(scores, valid, dim=-1)
    bad = torch.any(~torch.isfinite(torch.where(valid, scores, 0.0)),
                    dim=-1, keepdim=True)
    attn = torch.where(bad, 0.0, attn)
    return keys, torch.nan_to_num(values), s, attn, bad, scale


def attention_fwd_plain(latent, mask, query, w_key, b_key, w_val, b_val,
                        keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """latent (B, N, H), mask (B, N) bool, query (K, H), w_key/w_val
    (K, H, H), b_key/b_val (K, H), keep (B, K, N) or None -> ctx (B, K, H).

    The batched einsum form of the predictor (`models/predictor.py`
    `day_batched` in the JAX package): scores -> keep-mask -> ReLU ->
    masked softmax over stocks, a head with a non-finite valid score gives
    a zero context, values pass through nan_to_num."""
    _, values, _, attn, bad, _ = _forward_parts(latent, mask, query, w_key, b_key,
                                                w_val, b_val, keep)
    ctx = torch.einsum("bkn,bknh->bkh", attn, values)
    return torch.where(bad, 0.0, ctx)


def attention_bwd_plain(latent, mask, query, w_key, b_key, w_val, b_val, dctx,
                        keep: Optional[torch.Tensor] = None):
    """The VJP of `attention_fwd_plain` for the cotangent dctx (B, K, H) ->
    (dlatent (B, N, H), dquery (K, H), dw_key (K, H, H), db_key (K, H),
    dw_val (K, H, H), db_val (K, H)).

    The math of the TPU kernel (`attention_grad.py` `_bwd_kernel`) with the
    day axis as a batch axis: keys, values and the softmax recomputed;
    dz = 1[s > 0] (t - a sum t) / scale * keep with t = a (value . dctx).
    A head caught by the guard, and a masked row, give exactly zero to every
    gradient (a select, so a non-finite latent there cannot leak in through
    0 * NaN); the mask and the keep-mask get no gradient."""
    keys, values, s, a, bad, scale = _forward_parts(latent, mask, query, w_key, b_key,
                                                    w_val, b_val, keep)
    da = torch.where(bad, 0.0, torch.einsum("bknh,bkh->bkn", values, dctx))
    t = a * da
    dr = t - a * t.sum(dim=-1, keepdim=True)
    dz = torch.where(s > 0, dr, 0.0) / scale
    if keep is not None:
        dz = dz * keep
    dkey = dz[..., None] * query[None, :, None, :]                  # (B, K, N, H)
    dv = a[..., None] * dctx[:, :, None, :]                          # (B, K, N, H)
    row = mask[:, None, :, None]
    lat0 = torch.where(mask[..., None], latent, 0.0)
    per_day = bad[..., None]                                        # (B, K, 1, 1)
    dw_key = torch.where(per_day, 0.0, torch.einsum("bnh,bknj->bkhj", lat0, dkey)).sum(0)
    dw_val = torch.where(per_day, 0.0, torch.einsum("bnh,bknj->bkhj", lat0, dv)).sum(0)
    dquery = torch.where(bad, 0.0, torch.einsum(
        "bknh,bkn->bkh", torch.where(row, keys, 0.0), dz)).sum(0)
    dlatent = (torch.einsum("bknj,khj->bnh", dkey, w_key)
               + torch.einsum("bknj,khj->bnh", dv, w_val))
    return dlatent, dquery, dw_key, dkey.sum(dim=(0, 2)), dw_val, dv.sum(dim=(0, 2))


def _validate(name, latent, mask, query, w_key, b_key, w_val, b_val, keep,
              dctx=None) -> None:
    """One model's tensors (latent (B, N, H)), or S models' with a leading
    lane axis on every one (latent (S, B, N, H))."""
    if latent.ndim not in (3, 4):
        raise ValueError(f"{name}: latent must be (B, N, H) or (S, B, N, H); got "
                         f"{tuple(latent.shape)}")
    lane = tuple(latent.shape[:-3])
    b, n, h = latent.shape[-3:]
    k = query.shape[-2] if query.ndim >= 2 else 0
    args = {"mask": mask, "query": query, "w_key": w_key, "b_key": b_key,
            "w_val": w_val, "b_val": b_val, "keep": keep, "dctx": dctx}
    expect = {"mask": (b, n), "query": (k, h), "w_key": (k, h, h),
              "b_key": (k, h), "w_val": (k, h, h), "b_val": (k, h),
              "keep": (b, k, n), "dctx": (b, k, h)}
    args = {key: a for key, a in args.items() if a is not None}
    for key, a in args.items():
        if tuple(a.shape) != lane + expect[key]:
            raise ValueError(f"{name}: {key} must be {lane + expect[key]}; got "
                             f"{tuple(a.shape)}")
    if mask.dtype != torch.bool:
        raise TypeError(f"{name}: mask must be bool; got {mask.dtype}")
    if latent.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors; got {latent.device}")
    if latent.device.type == "cpu":
        return
    for key, a in args.items():
        if key != "mask" and a.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32; got {a.dtype}")
        if a.device != latent.device:
            raise ValueError(f"{name}: {key} is on {a.device}, latent on {latent.device}")


GROUPS = (16, 8, 4, 2, 1)    # heads per CTA the kernels take, preferred first
MAX_GROUP_ROWS = 4096        # G * N at most: the per-head row arrays fit in
                             # shared memory beside the row list


def launch_group(b_days: int, k_heads: int, n: int, num_sms: int) -> int:
    """Heads per CTA of the attention kernels for B days of N stocks and K
    heads on a card of `num_sms` SMs: the largest of GROUPS whose grid of B *
    ceil(K / G) CTAs has a CTA for every SM, or for every head of a day where
    a day has fewer heads than the card has SMs, and whose per-head row
    arrays stay small (G * N <= MAX_GROUP_ROWS); else 1, the widest grid.
    A CTA's fixed cost (the day's rows, the compaction) is paid once per
    group, so the rule takes the fewest CTAs that still spread over the
    card: one head per CTA at one flagship day, 8 at 8 days and at a 32-day
    serving chunk."""
    target = min(k_heads, num_sms)
    for g in GROUPS:
        if g <= k_heads and g * n <= MAX_GROUP_ROWS and b_days * -(-k_heads // g) >= target:
            return g
    return 1


@functools.lru_cache(maxsize=None)
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


WIDE_MIN_H = 65              # the wide kernels take H from here to 256


def wide_cluster(h: int) -> int:
    """CTAs of a wide day cluster (`wide_cluster` of attention_common.cuh):
    2 up to H = 128, 4 above, each holding a column slice of the day's
    rows. A function of H alone: the partial sums a score is made of do not
    depend on the group size the rule picks."""
    return 2 if h <= 128 else 4


def wide_launch_group(b_days: int, k_heads: int, n: int, h: int, num_sms: int) -> int:
    """Heads per cluster of the wide attention kernels (H > 64) for B days
    of N stocks and K heads on a card of `num_sms` SMs: the largest of
    GROUPS whose grid of B * ceil(K / G) clusters of `wide_cluster(h)` CTAs
    has a CTA for every SM and whose per-head row arrays stay small (G * N
    <= MAX_GROUP_ROWS); else 1, the widest grid. A cluster
    reads its slices of the day's rows from L2 once for its G heads, so the
    rule takes the fewest clusters that still fill the card: at one
    flagship day 2 heads a cluster at H = 256 (192 CTAs) and 1 at H = 128
    (192 CTAs), 8 at 8 days and at a 32-day chunk."""
    ctas = wide_cluster(h)
    for g in GROUPS:
        if (g <= k_heads and g * n <= MAX_GROUP_ROWS
                and b_days * -(-k_heads // g) * ctas >= num_sms):
            return g
    return 1


def _group(latent: torch.Tensor, k_heads: int) -> int:
    """`launch_group` (`wide_launch_group` above H = 64) for latent (B, N,
    H), or lane-axis latent (S, B, N, H), on the card that holds it: the
    rule sees the S * B days of the launch, and a CTA never takes two lanes'
    days."""
    days = latent.shape[0] * (latent.shape[1] if latent.ndim == 4 else 1)
    n, h = latent.shape[-2:]
    sms = _num_sms(latent.device.index)
    if h >= WIDE_MIN_H:
        return wide_launch_group(days, k_heads, n, h, sms)
    return launch_group(days, k_heads, n, sms)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "attention_fwd": {"attention_fwd": ([_P] * 11 + [_I] * 6 + [_P], _I),
                      "attention_fwd_scratch_floats": ([_I] * 5, _L),
                      "attention_fwd_max_hidden": ([], _I)},
    "attention_bwd": {"attention_bwd": ([_P] * 17 + [_I] * 6 + [_P], _I),
                      "attention_bwd_scratch_floats": ([_I] * 5, _L),
                      "attention_bwd_max_hidden": ([], _I)},
}


def _lib(name: str):
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib._typed = True
    return lib


def _cuda_lib(name: str, h: int):
    lib = _lib(name)
    cap = getattr(lib, f"{name}_max_hidden")()
    if h > cap:
        raise ValueError(f"{name}: hidden size {h} exceeds the kernel's maximum {cap}")
    return lib


def _pointers(latent, mask, keep, rest):
    """Contiguous tensors' data pointers in the C entries' order: latent,
    mask, keep (None for no keep-mask), then `rest`. Returns the tensors too,
    so they outlive the launch."""
    tensors = [t.contiguous() for t in (latent, mask, *rest)]
    keep_c = keep.contiguous() if keep is not None else None
    ptrs = [t.data_ptr() for t in tensors[:2]]
    ptrs.append(keep_c.data_ptr() if keep_c is not None else None)
    ptrs += [t.data_ptr() for t in tensors[2:]]
    return ptrs, (tensors, keep_c)


def _fwd_launch(latent, mask, query, w_key, b_key, w_val, b_val, keep, group: int,
                exact: bool = False):
    """K4 on lane-axis CUDA tensors (latent (S, B, N, H)) with `group` heads
    per CTA: (ctx (S, B, K, H), exact (S, B) int32 with 1 for each day that
    took the exact path, or None without `exact`, launched); for one
    model's tensors (latent (B, N, H)) without the S. Counts nothing."""
    lane = tuple(latent.shape[:-3])
    s = latent.shape[0] if lane else 1
    b, n, h = latent.shape[-3:]
    k = query.shape[-2]
    lib = _cuda_lib("attention_fwd", h)
    out = torch.empty(lane + (b, k, h), dtype=torch.float32, device=latent.device)
    days = torch.zeros(lane + (b,), dtype=torch.int32, device=latent.device) if exact else None
    if s == 0 or b == 0 or k == 0 or n == 0:
        return out.zero_(), days, False
    ptrs, _alive = _pointers(latent, mask, keep, (query, w_key, b_key, w_val, b_val))
    floats = lib.attention_fwd_scratch_floats(b, n, k, h, s) if h >= WIDE_MIN_H else 0
    scratch = torch.empty(floats, dtype=torch.float32, device=latent.device) if floats else None
    with torch.cuda.device(latent.device):
        stream = torch.cuda.current_stream().cuda_stream
        with launch_range("attention_fwd"):
            err = lib.attention_fwd(*ptrs, out.data_ptr(),
                                    days.data_ptr() if exact else None,
                                    scratch.data_ptr() if floats else None,
                                    b, n, k, h, group, s, stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed at S={s}, B={b}, N={n}, K={k}, "
                           f"H={h}, G={group}: cudaError {err}")
    return out, days, True


def attention_fwd(latent, mask, query, w_key, b_key, w_val, b_val,
                  keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused K-head attention over each day's stocks -> ctx (B, K, H) f32, or
    (S, B, K, H) for S models.

    Shapes as in `attention_fwd_plain`, each with a leading S for S models."""
    latent, query, w_key, b_key, w_val, b_val, keep = upcast(
        latent, query, w_key, b_key, w_val, b_val, keep)
    _validate("attention_fwd", latent, mask, query, w_key, b_key, w_val, b_val, keep)
    args = (latent, mask, query, w_key, b_key, w_val, b_val, keep)
    if latent.device.type == "cpu":
        return plain(attention_fwd_plain, latent.ndim == 4, *args)
    out, _, launched = _fwd_launch(*args, _group(latent, query.shape[-2]))
    attention_fwd.launches += launched
    return out


attention_fwd.launches = 0


@torch.library.custom_op("factorvae_tpu_torch::attention_fwd", mutates_args=())
def attention_fwd_op(latent: torch.Tensor, mask: torch.Tensor, query: torch.Tensor,
                     w_key: torch.Tensor, b_key: torch.Tensor, w_val: torch.Tensor,
                     b_val: torch.Tensor) -> torch.Tensor:
    """K4 without a keep-mask (the serving forward) as a registered op, the
    form an exported program (`eval/export_aot.py`) calls: on CUDA tensors
    `attention_fwd` (the kernel, counted in `attention_fwd.launches`), on CPU
    tensors its plain version. Shapes as in `attention_fwd`."""
    raise ValueError(f"factorvae_tpu_torch::attention_fwd runs on cuda or cpu tensors; "
                     f"got {latent.device}")


@attention_fwd_op.register_kernel("cuda")
def _attention_fwd_op_cuda(latent, mask, query, w_key, b_key, w_val, b_val):
    return attention_fwd(latent, mask, query, w_key, b_key, w_val, b_val)


@attention_fwd_op.register_kernel("cpu")
def _attention_fwd_op_cpu(latent, mask, query, w_key, b_key, w_val, b_val):
    args = upcast(latent, query, w_key, b_key, w_val, b_val)
    latent, query, w_key, b_key, w_val, b_val = args
    _validate("attention_fwd", latent, mask, query, w_key, b_key, w_val, b_val, None)
    return plain(attention_fwd_plain, latent.ndim == 4, latent, mask, query, w_key,
                 b_key, w_val, b_val)


@attention_fwd_op.register_fake
def _attention_fwd_op_fake(latent, mask, query, w_key, b_key, w_val, b_val):
    return latent.new_empty(tuple(latent.shape[:-2]) + (query.shape[-2], latent.shape[-1]),
                            dtype=torch.float32)


def _bwd_launch(latent, mask, query, w_key, b_key, w_val, b_val, dctx, keep,
                group: int, exact: bool = False):
    """K5 on lane-axis CUDA tensors, kernel 1 with `group` heads per CTA:
    ((dlatent, dquery, dw_key, db_key, dw_val, db_val), each (S, ...), exact
    days as in `_fwd_launch`, launched); for one model's tensors without
    the S. Counts nothing."""
    lane = tuple(latent.shape[:-3])
    s = latent.shape[0] if lane else 1
    b, n, h = latent.shape[-3:]
    k = query.shape[-2]
    lib = _cuda_lib("attention_bwd", h)
    days = torch.zeros(lane + (b,), dtype=torch.int32, device=latent.device) if exact else None
    if s == 0 or b == 0 or k == 0 or n == 0:
        return tuple(torch.zeros(tuple(a.shape), dtype=torch.float32, device=latent.device)
                     for a in (latent, query, w_key, b_key, w_val, b_val)), days, False
    # the kernels write every element of the gradients and of the scratch
    outs = [torch.empty(tuple(a.shape), dtype=torch.float32, device=latent.device)
            for a in (latent, query, w_key, b_key, w_val, b_val)]
    scratch = torch.empty(lib.attention_bwd_scratch_floats(b, n, k, h, s),
                          dtype=torch.float32, device=latent.device)
    ptrs, _alive = _pointers(latent, mask, keep,
                             (query, w_key, b_key, w_val, b_val, dctx))
    ptrs += [o.data_ptr() for o in outs] + [scratch.data_ptr()]
    with torch.cuda.device(latent.device):
        stream = torch.cuda.current_stream().cuda_stream
        with launch_range("attention_bwd"):
            err = lib.attention_bwd(*ptrs, days.data_ptr() if exact else None,
                                    b, n, k, h, group, s, stream)
    if err != 0:
        raise RuntimeError(f"attention_bwd launch failed at S={s}, B={b}, N={n}, K={k}, "
                           f"H={h}, G={group}: cudaError {err}")
    return tuple(outs), days, True


def attention_bwd(latent, mask, query, w_key, b_key, w_val, b_val, dctx,
                  keep: Optional[torch.Tensor] = None):
    """The attention's VJP for the cotangent dctx (B, K, H) -> (dlatent,
    dquery, dw_key, db_key, dw_val, db_val), f32; shapes as in
    `attention_bwd_plain`, each with a leading S for S models. One launch is
    the three kernels of `csrc/attention_bwd.cu`."""
    latent, query, w_key, b_key, w_val, b_val, dctx, keep = upcast(
        latent, query, w_key, b_key, w_val, b_val, dctx, keep)
    _validate("attention_bwd", latent, mask, query, w_key, b_key, w_val, b_val,
              keep, dctx)
    args = (latent, mask, query, w_key, b_key, w_val, b_val, dctx, keep)
    if latent.device.type == "cpu":
        return plain(attention_bwd_plain, latent.ndim == 4, *args)
    outs, _, launched = _bwd_launch(*args, _group(latent, query.shape[-2]))
    attention_bwd.launches += launched
    return outs


attention_bwd.launches = 0


class _AttentionFunction(torch.autograd.Function):
    """Forward K4, backward K5, for one model's tensors or lane-axis ones;
    under `torch.func.vmap` its rule makes one lane-axis call."""

    @staticmethod
    def forward(latent, mask, query, w_key, b_key, w_val, b_val, keep):
        return attention_fwd(latent, mask, query, w_key, b_key, w_val, b_val, keep)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dctx):
        latent, mask, query, w_key, b_key, w_val, b_val, keep = ctx.saved_tensors
        dlatent, dquery, dw_key, db_key, dw_val, db_val = attention_bwd(
            latent, mask, query, w_key, b_key, w_val, b_val, dctx, keep)
        return dlatent, None, dquery, dw_key, db_key, dw_val, db_val, None

    @staticmethod
    def vmap(info, in_dims, *args):
        args = [lane_major(a, d, info.batch_size) for a, d in zip(args, in_dims)]
        return _AttentionFunction.apply(*args), 0


def attention(latent, mask, query, w_key, b_key, w_val, b_val,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable `attention_fwd`, for one model or S (lane-axis
    tensors, or a `torch.func.vmap` over models): the forward is K4, the
    backward K5 (the plain versions on the CPU). The mask and keep-mask get
    no gradient. Under `torch.export`, without a keep-mask, it is the op
    `attention_fwd_op`, so the exported program launches K4 where it runs."""
    latent, query, w_key, b_key, w_val, b_val, keep = upcast(
        latent, query, w_key, b_key, w_val, b_val, keep)
    if keep is None and torch.compiler.is_exporting():
        return attention_fwd_op(latent, mask, query, w_key, b_key, w_val, b_val)
    return _AttentionFunction.apply(latent, mask, query, w_key, b_key, w_val,
                                    b_val, keep)
