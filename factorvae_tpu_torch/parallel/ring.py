"""Ring attention over the sharded stock cross-section (`factorvae_tpu/parallel/ring.py`).

The JAX package's explicit context-parallel path: the N stocks lie over a
mesh axis and the predictor's K-head attention (scaled scores -> ReLU ->
softmax over stocks -> weighted values) is computed without gathering the
cross-section on one rank. Each rank holds its (n_local, H) (or per-head
(K, n_local, H)) key/value/mask chunk and the replicated (K, H) queries; at
every ring step it folds the scores against its current chunk into running
(max, denominator, weighted accumulator) statistics with the online-softmax
rescaling, and passes the chunk to its right neighbour. After `ring_size`
folds every rank holds the exact (K, H) context.

It is plain PyTorch over `dist.batch_isend_irecv`, not a kernel: the
training path gathers the latent and runs K4 on the whole day
(`models/predictor.py`), which one card holds easily at CSI scale; this is
the path for a cross-section that outgrows one card. It computes forward
values only (the point-to-point ops record no autograd). Gloo runs
send/recv only on CPU tensors, so on a gloo group a CUDA chunk travels
through host memory; NCCL sends it as it is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from factorvae_tpu_torch.parallel.collective_ops import _record

_NEG_INF = -1e30


def ppermute_right(t: torch.Tensor, axis) -> torch.Tensor:
    """`t` from the left neighbour along `axis` (the ring's shift by one):
    rank i sends to i + 1 and receives from i - 1, modulo the size."""
    if axis is None or axis.group is None:
        return t
    staged = t.is_cuda and dist.get_backend(axis.group) == "gloo"
    send = (t.cpu() if staged else t).contiguous()
    recv = torch.empty_like(send)
    right = axis.ranks[(axis.index + 1) % axis.size]
    left = axis.ranks[(axis.index - 1) % axis.size]
    _record("collective-permute", axis.name, send.numel() * send.element_size())
    ops = [dist.P2POp(dist.isend, send, right, group=axis.group),
           dist.P2POp(dist.irecv, recv, left, group=axis.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device) if staged else recv


@torch.no_grad()
def ring_cross_section_attention(
    query: torch.Tensor,        # (K, H) replicated
    key_local: torch.Tensor,    # (n_local, H) shared or (K, n_local, H) per-head
    value_local: torch.Tensor,  # same leading shape as key_local
    mask_local: torch.Tensor,   # (n_local,) bool
    axis,
    relu_scores: bool = True,
    scale: Optional[float] = None,
    guard_nonfinite: bool = False,
) -> torch.Tensor:
    """Exact masked softmax attention over the ring; returns (K, H).

    relu_scores=True keeps the reference's ReLU before the softmax; scale
    defaults to 1/sqrt(H + 1e-6). 2-D key/value chunks are one set shared by
    every head; 3-D (K, n_local, H) chunks are per-head (the predictor's
    layout). guard_nonfinite=True is the predictor's per-head guard: a head
    with any non-finite score over the valid cross-section gives a zero
    context, tracked through the fold. A fully masked cross-section gives a
    zero context."""
    k_heads, h_dim = query.shape
    query = query.float()
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(h_dim), dtype=torch.float32,
                                              device=query.device) + 1e-6)
    per_head = key_local.ndim == 3
    ring_size = 1 if axis is None or axis.group is None else axis.size

    def scores_for(chunk_k, chunk_mask):
        if per_head:
            s = torch.einsum("kh,knh->kn", query, chunk_k) * scale
        else:
            s = (query @ chunk_k.T) * scale
        if relu_scores:
            s = torch.clamp(s, min=0.0)
        return torch.where(chunk_mask[None, :], s, _NEG_INF)

    def fold(stats, ck, cv, cm):
        m, l, acc, bad = stats
        s = scores_for(ck, cm)
        # masked positions hold the finite sentinel, so a non-finite entry
        # came from a valid stock's score
        bad = bad | torch.any(~torch.isfinite(s), dim=-1)
        # padded rows of the value chunk may be NaN: weight 0 times NaN would
        # still poison the accumulator
        cv = torch.where(cm[None, :, None] if per_head else cm[:, None], cv, 0.0)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        p = torch.where(cm[None, :], p, 0.0)
        l_new = l * corr + torch.sum(p, dim=-1)
        if per_head:
            acc_new = acc * corr[:, None] + torch.einsum("kn,knh->kh", p, cv)
        else:
            acc_new = acc * corr[:, None] + p @ cv
        return (m_new, l_new, acc_new, bad)

    dev = query.device
    stats = (torch.full((k_heads,), _NEG_INF, dtype=torch.float32, device=dev),
             torch.zeros((k_heads,), dtype=torch.float32, device=dev),
             torch.zeros((k_heads, h_dim), dtype=torch.float32, device=dev),
             torch.zeros((k_heads,), dtype=torch.bool, device=dev))
    ck, cv, cm = key_local.float(), value_local.float(), mask_local
    for _ in range(ring_size - 1):
        stats = fold(stats, ck, cv, cm)
        ck, cv = ppermute_right(ck, axis), ppermute_right(cv, axis)
        cm = ppermute_right(cm.to(torch.uint8), axis).to(torch.bool)
    m, l, acc, bad = fold(stats, ck, cv, cm)
    safe = l > 0
    if guard_nonfinite:
        safe = safe & ~bad
    return torch.where(safe[:, None], acc / torch.where(safe, l, 1.0)[:, None], 0.0)


@torch.no_grad()
def predictor_prior_ring(params, latent, mask, axis, cfg=None):
    """The FactorPredictor prior (mu_prior, sigma_prior) of one day computed
    context-parallel: latent (n_local, H) and mask (n_local,) are this
    rank's rows of the cross-section over `axis`; each rank builds its
    local (K, n_local, H) key/value chunks and the ring assembles the exact
    (K, H) contexts. The shared head MLP then runs replicated, with the
    per-head non-finite guard (dropout off). `params` maps the predictor's
    parameter names (`query`, `key_kernel`, `key_bias`, `value_kernel`,
    `value_bias`, `proj.weight`, ...) to tensors, e.g. the
    `factor_predictor.`-stripped names of a FactorVAE's; `cfg` an optional
    ModelConfig giving `leaky_relu_slope` (default 0.01)."""
    slope = cfg.leaky_relu_slope if cfg is not None else 0.01
    p = {k: v.float() for k, v in params.items()}
    lat = latent.float()
    keys = torch.einsum("nh,khj->knj", lat, p["key_kernel"]) + p["key_bias"][:, None, :]
    vals = torch.einsum("nh,khj->knj", lat, p["value_kernel"]) + p["value_bias"][:, None, :]
    ctx = ring_cross_section_attention(p["query"], keys, vals, mask, axis,
                                       guard_nonfinite=True)

    def dense(name, x):
        return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])

    h = F.leaky_relu(dense("proj", ctx), negative_slope=slope)
    mu = dense("mu", h)[:, 0]
    sigma = F.softplus(dense("sigma", h))[:, 0]
    return mu, sigma


__all__ = ["ppermute_right", "predictor_prior_ring",
           "ring_cross_section_attention"]
