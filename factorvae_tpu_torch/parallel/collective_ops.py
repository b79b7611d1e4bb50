"""Explicit collectives over a mesh axis (`factorvae_tpu/parallel/collective_ops.py`).

The JAX package writes these against a named axis under `shard_map` and
lets GSPMD insert the rest; the port writes every collective itself. Each
differentiable op is a `torch.autograd.Function` whose backward is the true
adjoint of its forward:

- `psum`: y = sum over the axis of x, on every rank. Its adjoint is again
  a sum over the axis of the incoming gradients.
- `all_gather_stocks`: the ranks' slices concatenated, on every rank. Its
  adjoint sums the incoming gradients over the axis and hands each rank
  the rows of its own slice.

With these adjoints, a loss that every rank of a 'stock' group computes in
full (a replicated value) gives each rank sp times its share of the
gradient; the trainer sums the gradients over the world and divides by sp
(`reduce_gradients`). The global max of `pmax_masked_softmax` gets no
gradient: a softmax does not depend on the shift.

Every op also has a `torch.func.vmap` rule (one call on the lane-major
tensor: a collective acts elementwise across ranks, so S lanes batch into
one call) and counts its calls and payload bytes per kind and axis
(`comm_counts`), which `obs/comms.py` reads. An axis of one rank, or
`axis=None`, is the identity and counts nothing.

All of it is all-reduce: the gather is an all-reduce into zero-filled
slots. That is what gloo runs on CUDA tensors (the one-card rig where two
ranks share an H100, which NCCL refuses) and NCCL runs anywhere. A failed
collective raises.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.distributed as dist

from factorvae_tpu_torch.ops.kernels import lane_major
from factorvae_tpu_torch.ops.masked import masked_mean, masked_softmax

_NEG_INF = -1e30

_COUNTS: dict = {}
_COUNTS_LOCK = threading.Lock()


def _record(kind: str, axis: str, nbytes: int) -> None:
    with _COUNTS_LOCK:
        c = _COUNTS.setdefault((kind, axis), {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += int(nbytes)


def comm_counts() -> dict:
    """{(kind, axis): {"calls", "bytes"}} since the last reset: every
    collective this process ran (forward and backward), its payload bytes
    (what the op hands the collective, not wire bytes)."""
    with _COUNTS_LOCK:
        return {k: dict(v) for k, v in _COUNTS.items()}


def reset_comm_counts() -> None:
    with _COUNTS_LOCK:
        _COUNTS.clear()


def _active(axis) -> bool:
    return axis is not None and axis.group is not None


def all_reduce(t: torch.Tensor, axis, op=dist.ReduceOp.SUM, kind: str = "all-reduce",
               nbytes: Optional[int] = None) -> torch.Tensor:
    """A new tensor: `t` reduced with `op` over `axis` (no autograd)."""
    out = t.detach().clone().contiguous()
    if not _active(axis):
        return out
    _record(kind, axis.name, out.numel() * out.element_size() if nbytes is None else nbytes)
    dist.all_reduce(out, op=op, group=axis.group)
    return out


def _gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The slices of `x` along `dim` from every rank of `axis`, in index
    order: an all-reduce into zero-filled slots."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * axis.size
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf.narrow(dim, axis.index * n, n).copy_(x.detach())
    nbytes = buf.numel() * buf.element_size()
    if buf.dtype == torch.bool:
        # as float32: every backend reduces it, gloo's CUDA path included
        return all_reduce(buf.to(torch.float32), axis, kind="all-gather",
                          nbytes=nbytes) > 0.5
    return all_reduce(buf, axis, kind="all-gather", nbytes=nbytes)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return _PSum.apply(lane_major(x, in_dims[0], info.batch_size), axis), 0


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        return all_reduce(x, axis, op=dist.ReduceOp.MAX)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return _PMax.apply(lane_major(x, in_dims[0], info.batch_size), axis), 0


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, dim):
        return _gather(x, axis, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.axis, ctx.dim = inputs
        ctx.n = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g, ctx.axis)
        return total.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None

    @staticmethod
    def vmap(info, in_dims, x, axis, dim):
        x = lane_major(x, in_dims[0], info.batch_size)
        return _AllGather.apply(x, axis, dim + 1 if dim >= 0 else dim), 0


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum of `x` over the ranks of `axis`, on every rank; the backward sums
    the gradients over the axis."""
    if not _active(axis):
        return x
    return _PSum.apply(x, axis)


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """Max of `x` over the ranks of `axis`, on every rank, without gradient."""
    if not _active(axis):
        return x.detach()
    return _PMax.apply(x, axis)


def pmax_masked_softmax(x: torch.Tensor, mask: torch.Tensor, axis, dim: int = 0
                        ) -> torch.Tensor:
    """Masked softmax over a dimension whose slices lie on the ranks of
    `axis`: x, mask are this rank's slices; the result is this rank's slice
    of `ops.masked.masked_softmax` of the whole. Without a group, that
    function itself."""
    if not _active(axis):
        return masked_softmax(x, mask, dim=dim)
    mask = torch.broadcast_to(mask, x.shape)
    x = torch.where(mask, x, _NEG_INF)
    global_max = pmax(torch.amax(x, dim=dim, keepdim=True), axis)
    ex = torch.where(mask, torch.exp(x - global_max), 0.0)
    denom = psum(torch.sum(ex, dim=dim, keepdim=True), axis)
    ok = denom > 0
    return torch.where(ok, ex / torch.where(ok, denom, 1.0), 0.0)


def psum_matvec(weights: torch.Tensor, vec: torch.Tensor, axis) -> torch.Tensor:
    """(N_local, M)^T @ (N_local,) summed over the ranks of `axis` -> (M,):
    the portfolio return W^T y over a cross-section split across them."""
    return psum(weights.T @ vec, axis)


def psum_masked_mean(x: torch.Tensor, mask: torch.Tensor, axis, dim=None) -> torch.Tensor:
    """Masked mean over a dimension split across the ranks of `axis` (all
    of x when `dim` is None) with the global count: `ops.masked.masked_mean`
    of the whole, on every rank."""
    if not _active(axis):
        return masked_mean(x, mask, dim=dim)
    mask = torch.broadcast_to(mask, x.shape)
    kept = torch.where(mask, x, 0.0)
    if dim is None:
        total, count = torch.sum(kept), torch.sum(mask)
    else:
        total, count = torch.sum(kept, dim=dim), torch.sum(mask, dim=dim)
    total = psum(total, axis)
    count = psum(count.to(x.dtype), axis)
    return torch.where(count > 0, total / torch.clamp(count, min=1), 0.0)


def psum_masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, axis,
                    dim=None) -> torch.Tensor:
    return psum_masked_mean((pred - target) ** 2, mask, axis, dim=dim)


def all_gather_stocks(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """The whole of a dimension split across the ranks of `axis` (their
    slices in index order), on every rank. The backward hands each rank the
    summed gradient of its own slice."""
    if not _active(axis):
        return x
    return _AllGather.apply(x, axis, dim)


def reduce_gradients(tensors, world, stock_size: int) -> None:
    """Sum the gradients `tensors` over the ranks of `world` in place, in one
    flat all-reduce, and divide by `stock_size`: with every collective's
    true adjoint, each rank of a 'stock' group holds stock_size times its
    share of a replicated loss's gradient (module docstring)."""
    tensors = [t for t in tensors if t is not None]
    if not tensors or not _active(world):
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = all_reduce(flat, world)
    if stock_size != 1:
        flat = flat / float(stock_size)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n

