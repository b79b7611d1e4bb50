"""Rank-IC evaluation (`factorvae_tpu/eval/metrics.py`).

`RankIC(df, column1, column2)` keeps the reference's DataFrame API
(utils.py:113-129): the per-day Spearman rank correlation of two columns of
a (datetime, instrument) frame, then one row with the mean `RankIC` and
`RankIC_IR` = mean / population std. It and `daily_rank_ic` import pandas
when called. `rank_ic_of_panel`, `panel_rank_ic` and `labeled_holdout_days`
work on the padded (D, N_max) arrays the scoring pass returns and need no
pandas: the CLI's path after the panel is loaded.
"""

from __future__ import annotations

import numpy as np
import torch

from factorvae_tpu_torch.ops.stats import rank_ic_series, rank_ic_summary

_DAY_CHUNK = 64     # days per pairwise-rank pass: (64, N, N) floats at a time


def daily_ic(x: np.ndarray, y: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Per-day Rank-IC of two (D, N_max) arrays over the entries that are
    valid and finite in both; NaN on a day with no defined correlation."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    mask = torch.from_numpy(np.asarray(valid, bool) & np.isfinite(x) & np.isfinite(y))
    xt = torch.from_numpy(np.nan_to_num(x))
    yt = torch.from_numpy(np.nan_to_num(y))
    parts = [rank_ic_series(xt[i:i + _DAY_CHUNK], yt[i:i + _DAY_CHUNK],
                            mask[i:i + _DAY_CHUNK])
             for i in range(0, x.shape[0], _DAY_CHUNK)]
    return torch.cat(parts).numpy() if parts else np.zeros(0, np.float32)


def rank_ic_of_panel(scores: np.ndarray, labels: np.ndarray, valid: np.ndarray) -> dict:
    """{"RankIC", "RankIC_IR"} of padded (D, N_max) scores and labels: the
    numbers `RankIC` gives on the score frame of the same days."""
    ic = torch.from_numpy(daily_ic(labels, scores, valid))
    if ic.numel() == 0:
        return {"RankIC": float("nan"), "RankIC_IR": float("nan")}
    mean, ir = rank_ic_summary(ic, torch.ones(ic.shape, dtype=torch.bool))
    return {"RankIC": float(mean), "RankIC_IR": float(ir)}


def panel_rank_ic(scores: np.ndarray, labels: np.ndarray, valid: np.ndarray) -> float:
    """Mean per-day Rank-IC over padded (D, N_max) panels (NaN days
    skipped); NaN when no day has a defined correlation."""
    ic = daily_ic(scores, labels, valid)
    return float(np.nanmean(ic)) if np.isfinite(ic).any() else float("nan")


def labeled_holdout_days(dataset, n: int = 1, min_labels: int = 3) -> list:
    """The newest `n` day indices whose cross-sections carry at least
    `min_labels` finite labels (possibly empty)."""
    days = dataset.split_days(None, None)
    labels = dataset.day_labels(days)
    ok = (np.isfinite(labels) & dataset.valid[days]).sum(axis=1) >= int(min_labels)
    idx = np.nonzero(ok)[0]
    return [int(days[i]) for i in idx[-max(1, int(n)):]]


def daily_rank_ic(df, column1: str = "LABEL0", column2: str = "score"):
    """Per-day Rank-IC series of a (datetime, instrument) frame (index:
    datetime)."""
    import pandas as pd

    dates = df.index.get_level_values(0)
    unique_dates = dates.unique()
    day_codes = unique_dates.get_indexer(dates)
    slots = df.groupby(level=0).cumcount().to_numpy()
    n_max = int(slots.max()) + 1 if len(df) else 0
    a = np.full((len(unique_dates), n_max), np.nan, np.float32)
    b = np.full((len(unique_dates), n_max), np.nan, np.float32)
    a[day_codes, slots] = df[column1].to_numpy()
    b[day_codes, slots] = df[column2].to_numpy()
    ic = daily_ic(a, b, np.ones(a.shape, bool))
    return pd.Series(ic, index=unique_dates, name="rank_ic")


def rank_ic_frame(df, column1: str = "LABEL0", column2: str = "score"):
    """Reference-API Rank-IC: a one-row DataFrame {'RankIC', 'RankIC_IR'}."""
    import pandas as pd

    ic = daily_rank_ic(df, column1, column2)
    if len(ic) == 0:
        return pd.DataFrame({"RankIC": [np.nan], "RankIC_IR": [np.nan]})
    mean, ir = rank_ic_summary(torch.tensor(ic.to_numpy()),
                               torch.ones(len(ic), dtype=torch.bool))
    return pd.DataFrame({"RankIC": [float(mean)], "RankIC_IR": [float(ir)]})


# The reference's name (utils.py:113).
RankIC = rank_ic_frame
