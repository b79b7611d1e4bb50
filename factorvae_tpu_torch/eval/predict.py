"""Inference scoring over a range of days (`factorvae_tpu/eval/predict.py`).

`predict_panel` walks the days in chunks of `chunk`: each chunk gathers its
windows from the device-resident panel, runs the day-batched prediction
and copies the (chunk, N_max) scores to the host. The last chunk is padded
with day -1, gathered as day 0 and masked out, exactly as in the JAX scan.

The stochastic mode draws its noise from a torch.Generator seeded with
`seed`; those numbers are not the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from factorvae_tpu_torch.data.loader import PanelDataset


def predict_panel(model, config, dataset: PanelDataset, days: np.ndarray,
                  stochastic: Optional[bool] = None, seed: int = 0,
                  chunk: int = 32) -> np.ndarray:
    """(len(days), N_max) float32 scores; padded or absent stocks are NaN.

    `model` is a `FactorVAE` on `dataset.device`; `config` its Config (kept
    for the JAX signature: the model already carries its ModelConfig)."""
    del config
    days = np.asarray(days, np.int64)
    n_days = len(days)
    out = np.full((n_days, dataset.n_max), np.nan, np.float32)
    generator = None
    sample = model.cfg.stochastic_inference if stochastic is None else stochastic
    if sample:
        generator = torch.Generator(device=dataset.device).manual_seed(seed)
    with torch.inference_mode():
        for c0 in range(0, n_days, chunk):
            sel = days[c0:c0 + chunk]
            padded = np.full(chunk, -1, np.int64)
            padded[:len(sel)] = sel
            day_idx = torch.from_numpy(padded).to(dataset.device)
            x, _, mask = dataset.gather(torch.clamp(day_idx, min=0))
            mask = mask & (day_idx >= 0)[:, None]
            scores = model.day_batched_prediction(
                x, mask, stochastic=sample, generator=generator)
            out[c0:c0 + len(sel)] = scores[:len(sel)].cpu().numpy()
    return out


def generate_prediction_scores(model, config, dataset: PanelDataset,
                               start: Optional[str] = None,
                               end: Optional[str] = None,
                               stochastic: Optional[bool] = None,
                               seed: int = 0, with_labels: bool = False):
    """Scores DataFrame indexed by (datetime, instrument) with a 'score'
    column (and 'LABEL0' when with_labels=True)."""
    import pandas as pd

    days = dataset.split_days(start, end)
    scores = predict_panel(model, config, dataset, days, stochastic, seed)
    valid = dataset.valid[days]
    day_pos, inst_pos = np.nonzero(valid)
    idx = pd.MultiIndex.from_arrays(
        [pd.DatetimeIndex(dataset.dates[days[day_pos]]),
         np.asarray(dataset.instruments)[inst_pos]],
        names=["datetime", "instrument"])
    df = pd.DataFrame({"score": scores[valid]}, index=idx)
    if with_labels:
        df["LABEL0"] = dataset.day_labels(days)[valid]
    return df
