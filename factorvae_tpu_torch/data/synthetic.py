"""Synthetic dense panels (`factorvae_tpu/data/synthetic.py`).

`synthetic_panel_dense` draws the same numbers from the same seed as the JAX
package's function: full cross-section every day, features ~ N(0, 1),
label = planted linear signal + noise, business days from 2015-01-01.
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
