"""Masked reductions over padded cross-sections (`factorvae_tpu/ops/masked.py`).

Every day is padded to N_max stocks with a validity mask; a reduction over
the stock axis ignores the padded positions.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def masked_softmax(x: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over `dim` restricted to positions where `mask` is True.

    Padded positions get probability exactly 0; a fully masked slice gives
    all zeros, not NaN.
    """
    mask = torch.broadcast_to(mask, x.shape)
    x = torch.where(mask, x, _NEG_INF)
    x = x - torch.amax(x, dim=dim, keepdim=True)
    ex = torch.where(mask, torch.exp(x), 0.0)
    denom = torch.sum(ex, dim=dim, keepdim=True)
    ok = denom > 0
    return torch.where(ok, ex / torch.where(ok, denom, 1.0), 0.0)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None, axis=None) -> torch.Tensor:
    """Mean of `x` over valid positions; 0 if nothing is valid. With `axis`
    (a mesh's 'stock' `Axis`) the positions along `dim` are this rank's
    slice and the mean is the whole's, with its global count
    (`parallel/collective_ops.psum_masked_mean`)."""
    if axis is not None:
        from factorvae_tpu_torch.parallel.collective_ops import psum_masked_mean

        return psum_masked_mean(x, mask, axis, dim=dim)
    mask = torch.broadcast_to(mask, x.shape)
    kept = torch.where(mask, x, 0.0)
    if dim is None:
        total, count = torch.sum(kept), torch.sum(mask)
    else:
        total, count = torch.sum(kept, dim=dim), torch.sum(mask, dim=dim)
    return torch.where(count > 0, total / torch.clamp(count, min=1), 0.0)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
               dim=None, axis=None) -> torch.Tensor:
    """Masked mean-squared error; with an all-true mask, `F.mse_loss` as
    the reference applies it to its one reparameterized sample."""
    return masked_mean((pred - target) ** 2, mask, dim=dim, axis=axis)


def masked_gaussian_nll(mu: torch.Tensor, sigma: torch.Tensor, target: torch.Tensor,
                        mask: torch.Tensor, eps: float = 1e-12, dim=None,
                        axis=None) -> torch.Tensor:
    """Masked mean Gaussian negative log-likelihood (the paper's analytic
    reconstruction term)."""
    var = sigma ** 2 + eps
    nll = 0.5 * (torch.log(2.0 * torch.pi * var) + (target - mu) ** 2 / var)
    return masked_mean(nll, mask, dim=dim, axis=axis)
