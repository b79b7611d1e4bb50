"""Ranking statistics for Rank-IC (`factorvae_tpu/ops/stats.py`).

The reference computes Rank-IC with scipy: per day, the Spearman rank
correlation of prediction and label, then the mean and IR = mean / std
(utils.py:113-129). Here the same statistic runs as plain torch ops over
padded (D, N_max) score and label tensors, on whatever device they are on.

Ties take *average ranks*, as in `scipy.stats.spearmanr`, through an
O(N²) pairwise comparison: 92k comparisons per day at N_max = 304.
"""

from __future__ import annotations

import torch

from factorvae_tpu_torch.ops.masked import masked_mean


def masked_rank(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Average ranks (1-based, scipy's convention) of `x` over its valid
    entries along the last axis; invalid entries get rank 0."""
    m = mask.to(x.dtype)
    xi = x[..., :, None]
    xj = x[..., None, :]
    mj = m[..., None, :]
    less = torch.sum((xj < xi) * mj, dim=-1)
    equal = torch.sum((xj == xi) * mj, dim=-1)
    return (less + 0.5 * (equal + 1.0)) * m


def masked_pearson(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                   eps: float = 1e-12) -> torch.Tensor:
    """Pearson correlation over the valid entries of the last axis. NaN
    where either side has zero variance (a constant side, or fewer than 2
    valid entries), as `scipy.stats.spearmanr` returns."""
    mx = masked_mean(x, mask, dim=-1)[..., None]
    my = masked_mean(y, mask, dim=-1)[..., None]
    dx = torch.where(mask, x - mx, 0.0)
    dy = torch.where(mask, y - my, 0.0)
    cov = torch.sum(dx * dy, dim=-1)
    vx = torch.sum(dx * dx, dim=-1)
    vy = torch.sum(dy * dy, dim=-1)
    defined = (vx > 0) & (vy > 0)
    return torch.where(defined, cov / torch.sqrt(vx * vy + eps), torch.nan)


def masked_spearman(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Spearman rank correlation: Pearson on average ranks."""
    return masked_pearson(masked_rank(x, mask), masked_rank(y, mask), mask)


def rank_ic_series(scores: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Per-day Rank-IC over a (D, N_max) panel -> (D,). Mask out entries
    whose label or score is not finite before calling this."""
    return masked_spearman(scores, labels, mask)


def rank_ic_summary(ic: torch.Tensor, day_mask: torch.Tensor):
    """(mean Rank-IC, IR) over the valid days whose IC is finite. IR =
    mean / std with the *population* std (numpy's ddof=0, as the
    reference); NaN mean when no day counts, NaN IR at zero std."""
    day_mask = day_mask & torch.isfinite(ic)
    ic = torch.where(day_mask, ic, 0.0)
    mean = torch.where(day_mask.any(), masked_mean(ic, day_mask), torch.nan)
    std = torch.sqrt(masked_mean((ic - mean) ** 2, day_mask))
    ir = torch.where(std > 0, mean / torch.where(std > 0, std, 1.0), torch.nan)
    return mean, ir
