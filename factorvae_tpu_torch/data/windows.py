"""Look-back windows with ffill+bfill semantics (`factorvae_tpu/data/windows.py`).

A sample (day d, instrument i) is a T-row window over trading days
[d-T+1 .. d]. A day on which the instrument has no row takes the nearest
preceding valid row inside the window; leading gaps take the nearest
following valid row inside the window. Two int maps, computed once on the
host,

    last_valid[d, i] = most recent day <= d with a row (-1 if none)
    next_valid[d, i] = earliest day  >= d with a row ( D if none)

drive the gather, which runs on the device over the resident panel.
Integer selection only: the windows are bitwise the JAX package's. The
maps come from the native pass where it builds (`native.fill_maps`).

The host twins (`fill_indices_host`, `window_fill_indices_np`,
`gather_days_host`, `chunk_mini_panel`) are numpy, bitwise the JAX ones: the
stream residency builds each chunk's relocatable mini-panel on the host, and
the device gather over it is unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from factorvae_tpu_torch import native


def compute_fill_maps(valid: np.ndarray):
    """valid (D, I) bool -> (last_valid, next_valid), both (D, I) int32.

    The native pass (`factorvae_tpu_torch/native`) serves when it is
    available, numpy otherwise; the two are bitwise equal."""
    return native.fill_maps(valid, fallback=_fill_maps_numpy)


def _fill_maps_numpy(valid: np.ndarray):
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


# ---- host twins: the stream residency's gather runs on the host ------------


def fill_indices_host(valid: np.ndarray, day: int, step_len: int) -> np.ndarray:
    """Oracle of the window semantics, one position at a time: day `day`'s
    per-instrument row indices, (I, T) int32; -1 marks a position with no
    valid row anywhere in its window."""
    d_total, n_inst = valid.shape
    t = step_len
    out = np.full((n_inst, t), -1, dtype=np.int32)
    for i in range(n_inst):
        vals = np.full(t, np.nan)
        for k, p in enumerate(range(day - t + 1, day + 1)):
            if 0 <= p < d_total and valid[p, i]:
                vals[k] = p
        for k in range(1, t):                  # ffill
            if np.isnan(vals[k]):
                vals[k] = vals[k - 1]
        for k in range(t - 2, -1, -1):         # then bfill
            if np.isnan(vals[k]):
                vals[k] = vals[k + 1]
        out[i] = np.where(np.isnan(vals), -1, vals).astype(np.int32)
    return out


def window_fill_indices_np(last_valid: np.ndarray, next_valid: np.ndarray,
                           day: int, step_len: int) -> np.ndarray:
    """`window_fill_indices` of one day in numpy, (I, T) int32: the same
    integer selection, so the same indices."""
    d_total = last_valid.shape[0]
    t = step_len
    day = int(day)
    p = day - t + 1 + np.arange(t, dtype=np.int32)                    # (T,)
    lv = last_valid[np.clip(p, 0, d_total - 1)]                        # (T, I)
    w_start = day - t + 1
    ff_ok = (p >= 0)[:, None] & (lv >= max(w_start, 0))
    fv = next_valid[min(max(w_start, 0), d_total - 1)]                 # (I,)
    fallback = np.where(fv <= day, fv, day)[None, :]
    return np.where(ff_ok, lv, fallback).T.astype(np.int32)


def gather_days_host(values: np.ndarray, last_valid: np.ndarray,
                     next_valid: np.ndarray, days: np.ndarray, step_len: int):
    """`gather_days` on the host panel for days (B,) with -1 padding:
    (x (B, I, T, C) NaN-free, y (B, I), mask (B, I) False on padding days,
    day_w (B,) float32 1/0). Selection only, so bitwise the device gather."""
    days = np.asarray(days, np.int32)
    xs, ys, masks = [], [], []
    for d in np.maximum(days, 0):
        fill = window_fill_indices_np(last_valid, next_valid, int(d), step_len)
        window = np.take_along_axis(values, fill[:, :, None], axis=1)
        xs.append(np.nan_to_num(window[:, :, :-1]))
        ys.append(values[:, int(d), -1])
        masks.append(last_valid[int(d)] == int(d))
    mask = np.stack(masks) & (days >= 0)[:, None]
    return np.stack(xs), np.stack(ys), mask, (days >= 0).astype(np.float32)


def mini_panel_maps(last_valid: np.ndarray, next_valid: np.ndarray,
                    days: np.ndarray, step_len: int):
    """The index half of `chunk_mini_panel`: (local_days (m,), rows (m*T,)
    the panel's day of each mini-panel row, clv (m*T, I), cnv (m*T, I)),
    the maps int32."""
    days = np.asarray(days, np.int32)
    m = len(days)
    t = int(step_len)
    d_total = last_valid.shape[0]
    safe = np.maximum(days, 0).astype(np.int64)
    w_start = safe - t + 1                                             # (m,)
    p = w_start[:, None] + np.arange(t)                                # (m, T)
    pc = np.clip(p, 0, d_total - 1)
    base = (np.arange(m, dtype=np.int64) * t)[:, None]                 # (m, 1)
    lv = last_valid[pc]                                                # (m, T, I)
    ff_ok = (p >= 0)[:, :, None] & (lv >= np.maximum(w_start, 0)[:, None, None])
    clv = np.where(ff_ok, base[:, :, None] + (lv - w_start[:, None, None]),
                   -1).reshape(m * t, -1).astype(np.int32)
    cnv = np.full((m * t, lv.shape[-1]), m * t, np.int32)
    fv = next_valid[np.clip(w_start, 0, d_total - 1)]                  # (m, I)
    cnv[np.arange(m) * t] = np.where(fv <= safe[:, None], base + (fv - w_start[:, None]),
                                     m * t).astype(np.int32)
    local_days = np.where(days >= 0, np.arange(m, dtype=np.int32) * t + t - 1,
                          -1).astype(np.int32)
    return local_days, pc.reshape(-1), clv, cnv


def chunk_mini_panel(values: np.ndarray, last_valid: np.ndarray,
                     next_valid: np.ndarray, days: np.ndarray, step_len: int,
                     out: np.ndarray = None):
    """A relocatable mini-panel for a chunk of days (any order, -1 padding),
    the stream residency's unit of transfer: (local_days (m,), cvalues
    (I, m*T, C+1), clv (m*T, I), cnv (m*T, I)), the maps int32, such that
    `gather_days` over (cvalues, clv, cnv) at local_days gives bitwise the
    batches the whole panel gives at `days`.

    Day s of the chunk gets its own T-row slab, rows [s*T, (s+1)*T) holding
    the panel's days w..w+T-1 (w = day - T + 1, clipped into the panel), its
    query day at s*T + T - 1; the maps are remapped into the slab where the
    whole panel's ffill/bfill would accept that row, else -1 (clv) or m*T
    (cnv, out of range). A padding day keeps local day -1 over a slab of day
    0's window. `out` (I, m*T, C+1) float32, when given, receives cvalues
    (a pinned staging buffer: no temporary, no second host copy)."""
    local_days, rows, clv, cnv = mini_panel_maps(last_valid, next_valid, days, step_len)
    cvalues = np.take(values, rows, axis=1, out=out, mode="clip")
    return local_days, cvalues, clv, cnv
