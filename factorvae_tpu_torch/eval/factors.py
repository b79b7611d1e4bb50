"""Factor decomposition over a date range (`factorvae_tpu/eval/factors.py`).

Everything the training forward gives per day (loss, reconstruction loss,
KL, the factor posterior and prior) plus the decoder's internals (the
alpha and beta exposures of each stock), as pandas frames for factor
analysis: which latent factors the posterior loads on, how the prior tracks
it, and each stock's exposures.

The days go in `predict_panel`'s padded chunks (`eval/predict.py`; either
residency) through `FactorVAE.day_batched_decomposition` in eval mode under
`torch.inference_mode()`: the extractor runs once per chunk (K1's serving
variant), the prior predictor once (K4), and alpha and beta come from that
same latent. The JAX module runs the extractor a second time for them; the
numbers are the same. Each chunk's outputs cross to the host in ONE copy
(one flat tensor); the frames are built from host arrays.

Labels enter as the JAX module feeds them: `nan_to_num`, so a stock with a
missing label counts in the day's loss with label 0. The decoder's sample
(the "mse" reconstruction) draws eps (chunk, N_max) per chunk, padding days
included, from one `torch.Generator` on the dataset's device seeded with
`seed`, as `predict_panel`'s sampled path does; those numbers are not
`jax.random`'s. With `recon_loss="nll"` no noise enters any output.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from factorvae_tpu_torch.eval.predict import _score_chunks
from factorvae_tpu_torch.models.factorvae import call_with, with_compute_dtype


def _day_index(dates):
    import pandas as pd

    return pd.DatetimeIndex(np.asarray(dates).astype("datetime64[ns]"))


def decompose(model, config, dataset, start: Optional[str] = None,
              end: Optional[str] = None, seed: int = 0, chunk: int = 32,
              device=None, params: Optional[dict] = None) -> dict:
    """Frames over the days of [start, end] that have a valid stock:

    - 'factors': per (datetime, factor) the columns post_mu, post_sigma,
      prior_mu, prior_sigma (the KL's two sides);
    - 'exposures': per valid (datetime, instrument) the columns
      beta_0..beta_{K-1}, alpha_mu, alpha_sigma;
    - 'loss': per datetime the columns loss, recon, kl.

    `model` is a `FactorVAE` on the dataset's device (computing in
    `config.model.compute_dtype`); `params` (name -> tensor) replace its
    weights. `device`, when given, must be the dataset's: the card by
    default, "cpu" for the plain versions."""
    import pandas as pd

    if device is not None and torch.device(device).type != dataset.device.type:
        raise ValueError(f"the dataset lives on {dataset.device}, decompose was asked "
                         f"to run on {device}")
    # train=False below; the caller's model keeps its mode
    model = with_compute_dtype(model, config.model.compute_dtype)
    k_factors = config.model.num_factors
    days = dataset.split_days(start, end)
    generator = torch.Generator(device=dataset.device).manual_seed(seed)
    dates = np.asarray(dataset.dates)
    instruments = np.asarray(dataset.instruments)
    n_inst = len(instruments)
    per_day, exposure_parts = [], []
    with torch.inference_mode():
        for c0, n_sel, ds, day_idx in _score_chunks(dataset, days, chunk):
            x, y, mask = ds.gather(torch.clamp(day_idx, min=0))
            mask = mask & (day_idx >= 0)[:, None]
            y = torch.nan_to_num(y)
            if params is None:
                out, amu, asig, beta = model.day_batched_decomposition(
                    x, y, mask, generator=generator)
            else:
                out, amu, asig, beta = call_with(model, params, "day_batched_decomposition",
                                                 x, y, mask, generator=generator)
            n = amu.shape[1]
            parts = [out.factor_mu, out.factor_sigma, out.pred_mu, out.pred_sigma,
                     out.loss[:, None], out.recon_loss[:, None], out.kl[:, None],
                     amu, asig, beta.reshape(beta.shape[0], -1)]
            # the chunk's one device -> host copy
            flat = torch.cat([p.to(torch.float32) for p in parts], dim=1).cpu().numpy()
            *day_cols, a_mu, a_sig, beta_np = np.split(
                flat[:n_sel], np.cumsum([k_factors] * 4 + [1, 1, 1, n, n]), axis=1)
            sel = days[c0:c0 + n_sel]
            per_day.append((sel, day_cols))
            day_pos, inst_pos = np.nonzero(dataset.valid[sel][:, :n_inst])
            exposure_parts.append((
                sel[day_pos], inst_pos,
                beta_np.reshape(n_sel, n, k_factors)[day_pos, inst_pos],
                a_mu[day_pos, inst_pos], a_sig[day_pos, inst_pos]))
    return _frames(per_day, exposure_parts, dates, instruments, k_factors)


def _frames(per_day, exposure_parts, dates, instruments, k_factors: int) -> dict:
    """The three frames from each chunk's host arrays: per-day columns as
    float64 (the JAX module's `float()` of each f32), exposures as float32."""
    import pandas as pd

    sel = np.concatenate([s for s, _ in per_day]) if per_day else np.zeros(0, np.int64)

    def column(i):
        if not per_day:
            return np.zeros(0)
        return np.concatenate([cols[i] for _, cols in per_day]).reshape(-1).astype(np.float64)

    factors = pd.DataFrame(
        {name: column(i) for i, name in enumerate(
            ("post_mu", "post_sigma", "prior_mu", "prior_sigma"))},
        index=pd.MultiIndex.from_arrays(
            [_day_index(np.repeat(dates[sel], k_factors)),
             np.tile(np.arange(k_factors), len(sel))], names=["datetime", "factor"]))
    loss = pd.DataFrame({name: column(4 + i) for i, name in enumerate(("loss", "recon", "kl"))},
                        index=pd.Index(_day_index(dates[sel]), name="datetime"))
    if not exposure_parts:
        return {"factors": factors, "exposures": pd.DataFrame(), "loss": loss}
    day_of, inst_of, beta_rows, amu_rows, asig_rows = (
        np.concatenate([p[i] for p in exposure_parts]) for i in range(5))
    exposures = pd.DataFrame(
        beta_rows, columns=[f"beta_{k}" for k in range(k_factors)],
        index=pd.MultiIndex.from_arrays([_day_index(dates[day_of]), instruments[inst_of]],
                                        names=["datetime", "instrument"]))
    exposures["alpha_mu"] = amu_rows
    exposures["alpha_sigma"] = asig_rows
    return {"factors": factors, "exposures": exposures, "loss": loss}
