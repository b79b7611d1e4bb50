"""Synthetic dense panels (`factorvae_tpu/data/synthetic.py`).

`synthetic_panel_dense` draws the same numbers from the same seed as the JAX
package's function: full cross-section every day, features ~ N(0, 1),
label = planted linear signal + noise, business days from 2015-01-01.
`continuation_panel` draws the JAX function's numbers too: the days after
an existing panel's last date, from a seed alone, so the walk-forward
command regenerates the same incoming days on a resume.
"""

from __future__ import annotations

import numpy as np

from factorvae_tpu_torch.data.panel import Panel


def business_days(start: str, periods: int) -> np.ndarray:
    first = np.busday_offset(np.datetime64(start, "D"), 0, roll="forward")
    return np.busday_offset(first, np.arange(periods), roll="forward")


def synthetic_panel_dense(num_days: int, num_instruments: int, num_features: int,
                          signal: float = 0.3, seed: int = 0) -> Panel:
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(num_instruments, num_days, num_features)).astype(np.float32)
    w = (rng.normal(size=(num_features,)) / np.sqrt(num_features)).astype(np.float32)
    label = signal * feats @ w + (1 - signal) * rng.normal(
        size=(num_instruments, num_days)
    ).astype(np.float32)
    values = np.concatenate([feats, label[..., None]], axis=-1)
    return Panel(
        values=values,
        valid=np.ones((num_days, num_instruments), bool),
        dates=business_days("2015-01-01", num_days),
        instruments=np.array([f"SH{600000 + k}" for k in range(num_instruments)]),
    )


def continuation_panel(instruments: np.ndarray, last_date, num_days: int,
                       num_features: int, signal: float = 0.3, seed: int = 0) -> Panel:
    """Dense synthetic days continuing a panel: the same instrument axis,
    the `num_days` business days after `last_date`, features and label
    drawn as in `synthetic_panel_dense` from `seed` alone (two calls with
    the same arguments give the same bytes)."""
    rng = np.random.default_rng(seed)
    instruments = np.asarray(instruments)
    n = len(instruments)
    last = np.datetime64(str(last_date)[:10], "D")
    first = np.busday_offset(last, 1, roll="backward")
    dates = np.busday_offset(first, np.arange(num_days), roll="forward")
    feats = rng.normal(size=(n, num_days, num_features)).astype(np.float32)
    w = (rng.normal(size=(num_features,)) / np.sqrt(num_features)).astype(np.float32)
    label = signal * feats @ w + (1 - signal) * rng.normal(size=(n, num_days)).astype(
        np.float32)
    values = np.concatenate([feats, label[..., None]], axis=-1)
    return Panel(values=values, valid=np.ones((num_days, n), bool), dates=dates,
                 instruments=instruments)
