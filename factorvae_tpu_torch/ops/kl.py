"""Closed-form Gaussian KL divergence (`factorvae_tpu/ops/kl.py`).

    KL = sum_K [ log(sigma2/sigma1) + (sigma1^2 + (mu1-mu2)^2) / (2 sigma2^2) - 1/2 ]

i.e. KL(N(mu1, sigma1) || N(mu2, sigma2)) summed over the factor axis, as
the reference's `FactorVAE.KL_Divergence`. The reconstruction loss is a mean
over stocks while the KL is a sum over K; that imbalance is the reference's.
"""

from __future__ import annotations

import torch


def gaussian_kl(mu1: torch.Tensor, sigma1: torch.Tensor, mu2: torch.Tensor,
                sigma2: torch.Tensor) -> torch.Tensor:
    """Elementwise KL(N(mu1, sigma1) || N(mu2, sigma2))."""
    return (torch.log(sigma2 / sigma1)
            + (sigma1 ** 2 + (mu1 - mu2) ** 2) / (2.0 * sigma2 ** 2)
            - 0.5)


def gaussian_kl_sum(mu1: torch.Tensor, sigma1: torch.Tensor, mu2: torch.Tensor,
                    sigma2: torch.Tensor, guard: float = 1e-6, dim=None) -> torch.Tensor:
    """KL summed over `dim` (all elements by default), with the reference's
    zero-sigma guard on the *second* (prior) distribution: a prior sigma of
    exactly 0 becomes `guard`."""
    sigma2 = torch.where(sigma2 == 0.0, guard, sigma2)
    kl = gaussian_kl(mu1, sigma1, mu2, sigma2)
    return torch.sum(kl) if dim is None else torch.sum(kl, dim=dim)
