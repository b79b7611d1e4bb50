"""Synthetic panels (`factorvae_tpu/data/synthetic.py`).

`synthetic_frame` is the reference-schema frame (MultiIndex (datetime,
instrument), C feature columns and LABEL0) with dropped (day, instrument)
rows and a planted linear signal; its `np.random.default_rng(seed)` draws
come in the JAX function's order, so both packages give the same frame,
and `synthetic_panel` is `build_panel` of it. Only these two import pandas,
when called.

`synthetic_panel_dense` draws the same numbers from the same seed as the JAX
package's function: full cross-section every day, features ~ N(0, 1),
label = planted linear signal + noise, business days from 2015-01-01.
`continuation_panel` draws the JAX function's numbers too: the days after
an existing panel's last date, from a seed alone, so the walk-forward
command regenerates the same incoming days on a resume.
"""

from __future__ import annotations

import numpy as np

from factorvae_tpu_torch.data.panel import Panel, build_panel


def business_days(start: str, periods: int) -> np.ndarray:
    first = np.busday_offset(np.datetime64(start, "D"), 0, roll="forward")
    return np.busday_offset(first, np.arange(periods), roll="forward")


def synthetic_frame(num_days: int = 30, num_instruments: int = 12,
                    num_features: int = 16, missing_prob: float = 0.1,
                    signal: float = 0.5, seed: int = 0, label_scale: float = 1.0):
    """Reference-schema frame over `num_days` business days from
    2020-01-01: each (day, instrument) row is dropped with probability
    `missing_prob`, its features ~ N(0, 1), and LABEL0 = label_scale *
    (signal * features @ w + (1 - signal) * noise)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    dates = pd.bdate_range("2020-01-01", periods=num_days)
    instruments = np.array([f"SH{600000 + k}" for k in range(num_instruments)])
    w = rng.normal(size=(num_features,)) / np.sqrt(num_features)
    rows, feats, labels = [], [], []
    for d in dates:
        for inst in instruments:
            if rng.random() < missing_prob:
                continue
            f = rng.normal(size=(num_features,)).astype(np.float32)
            y = label_scale * (signal * float(f @ w) + (1 - signal) * float(rng.normal()))
            rows.append((d, inst))
            feats.append(f)
            labels.append(y)
    idx = pd.MultiIndex.from_tuples(rows, names=["datetime", "instrument"])
    df = pd.DataFrame(np.asarray(feats), index=idx,
                      columns=[f"F{i}" for i in range(num_features)])
    df["LABEL0"] = np.asarray(labels, dtype=np.float32)
    return df


def synthetic_panel(**kw) -> Panel:
    """`build_panel` of `synthetic_frame(**kw)`."""
    return build_panel(synthetic_frame(**kw))


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
