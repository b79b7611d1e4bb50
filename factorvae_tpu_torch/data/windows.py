"""Look-back windows with ffill+bfill semantics (`factorvae_tpu/data/windows.py`).

A sample (day d, instrument i) is a T-row window over trading days
[d-T+1 .. d]. A day on which the instrument has no row takes the nearest
preceding valid row inside the window; leading gaps take the nearest
following valid row inside the window. Two int maps, computed once on the
host,

    last_valid[d, i] = most recent day <= d with a row (-1 if none)
    next_valid[d, i] = earliest day  >= d with a row ( D if none)

drive the gather, which runs on the device over the resident panel.
Integer selection only: the windows are bitwise the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_fill_maps(valid: np.ndarray):
    """valid (D, I) bool -> (last_valid, next_valid), both (D, I) int32."""
    valid = np.asarray(valid, bool)
    d = valid.shape[0]
    idx = np.arange(d, dtype=np.int32)[:, None]
    last_valid = np.maximum.accumulate(np.where(valid, idx, -1), axis=0)
    nv_rev = np.maximum.accumulate(np.where(valid[::-1], idx, -1), axis=0)[::-1]
    next_valid = np.where(nv_rev >= 0, d - 1 - nv_rev, d)
    return last_valid.astype(np.int32), next_valid.astype(np.int32)


def window_fill_indices(last_valid: torch.Tensor, next_valid: torch.Tensor,
                        days: torch.Tensor, step_len: int) -> torch.Tensor:
    """Fill indices for a batch of days: days (B,) int64 -> (B, I, T) int64.

    A position with no valid row anywhere in its window resolves to the day
    itself (such instruments are masked out of the batch anyway)."""
    d_total = last_valid.shape[0]
    t = step_len
    days = days.to(torch.int64)
    p = days[:, None] - t + 1 + torch.arange(t, device=days.device)   # (B, T)
    lv = last_valid[p.clamp(0, d_total - 1)]                           # (B, T, I)
    w_start = days - t + 1                                             # (B,)
    ff_ok = (p >= 0)[:, :, None] & (lv >= w_start.clamp(min=0)[:, None, None])
    fv = next_valid[w_start.clamp(0, d_total - 1)]                     # (B, I)
    fallback = torch.where(fv <= days[:, None], fv, days[:, None])[:, None, :]
    fill = torch.where(ff_ok, lv, fallback)                            # (B, T, I)
    return fill.transpose(1, 2)


def gather_days(values: torch.Tensor, last_valid: torch.Tensor,
                next_valid: torch.Tensor, days: torch.Tensor, step_len: int):
    """Gather a batch of days' padded cross-sections from the panel.

    values (I, D, C+1); days (B,) valid day indices. Returns (x, y, mask):
      x    (B, I, T, C)  features, NaN-free (missing -> 0)
      y    (B, I)        labels of each day (NaN where absent)
      mask (B, I)        instrument has a row on that day
    """
    days = days.to(torch.int64)
    fill = window_fill_indices(last_valid, next_valid, days, step_len)
    inst = torch.arange(values.shape[0], device=values.device)[None, :, None]
    window = values[inst, fill]                                        # (B, I, T, C+1)
    x = torch.nan_to_num(window[..., :-1], nan=0.0)
    y = values[:, days, -1].transpose(0, 1)
    mask = last_valid[days] == days[:, None]
    return x, y, mask


def gather_day(values: torch.Tensor, last_valid: torch.Tensor,
               next_valid: torch.Tensor, day: int, step_len: int):
    """One day's (x (I, T, C), y (I,), mask (I,)); see `gather_days`."""
    days = torch.tensor([int(day)], dtype=torch.int64, device=values.device)
    x, y, mask = gather_days(values, last_valid, next_valid, days, step_len)
    return x[0], y[0], mask[0]
