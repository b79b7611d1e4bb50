"""Inference scoring over a range of days (`factorvae_tpu/eval/predict.py`).

`predict_panel` walks the days in chunks of `chunk`: each chunk gathers its
windows on the device, runs the day-batched prediction and copies the
(chunk, N_max) scores to the host. The last chunk is padded with day -1,
gathered as day 0 and masked out, exactly as in the JAX scan. On an "hbm"
dataset the windows come from the resident panel; on a "stream" one each
chunk is a mini-panel copied one chunk ahead (`data/stream.py`), with the
same chunking, padding and generator order, so the scores are bitwise the
same.

The stochastic mode draws its noise from a torch.Generator seeded with
`seed`; those numbers are not the JAX package's.

The precision ladder: the compute dtype comes from `config.model`
(bfloat16 scoring keeps the float32 weights and computes the extractor in
bfloat16), and `int8=True` scores with weight-only int8 (`ops/quant.py`):
the weights are quantized once (`ensure_quantized`; a registry entry
arrives quantized) and dequantized to the compute dtype for each chunk.

Fleets: `predict_panel_fleet` scores S stacked parameter sets (a
`train/fleet.FleetTrainer`'s, or `stack_params` of S registry entries')
per chunk through `torch.func.vmap` of the model, so K1 and K4 launch once
per chunk for all lanes; the lanes share the chunk's windows and, when
sampling, its noise (the scoring seed of the serial sweep). With `int8` the
stacked tree holds QTensors with per-lane scales (a dense one is quantized
lane by lane) and is dequantized for each chunk. One lane is
`predict_panel` of that lane's model.

On a mesh (`mesh=`), each rank holds its 'stock' rows of the panel
(`parallel/sharding.shard_dataset`, or the stream's `chunk_placement`),
scores every day of the range on them (K1 on its rows, the predictor's
gather and K4 on the whole day) and all-gathers the chunk's scores over
'stock', so every rank returns the whole (days, N_max) array. A sampled
score draws each chunk's noise at the whole cross-section's shape and keeps
its stocks, so it is the serial run's noise.

`score_table` lays the scores out as the reference's score frame (one row
per valid (day, stock), day-major); `export_scores` writes it as the JAX
package's CSV with the `csv` module, and `score_frame` makes it the
DataFrame of `generate_prediction_scores`: only these two import pandas.
"""

from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np
import torch

from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.stream import epoch_chunks
from factorvae_tpu_torch.models.factorvae import call_with, model_from_params, with_compute_dtype
from factorvae_tpu_torch.ops.quant import (
    QTensor,
    dequantize_params,
    ensure_quantized,
    is_quantized,
    quantize_params,
)


def _score_chunks(dataset, days: np.ndarray, chunk: int, placement=None):
    """(c0, real days, dataset or mini-panel, day_idx (chunk,) with -1
    padding on the device) for each chunk of `days`."""
    n_days = len(days)
    padded = np.full(-(-n_days // chunk) * chunk, -1, np.int64)
    padded[:n_days] = days
    c0 = 0
    for ds, order in epoch_chunks(dataset, padded.reshape(-1, chunk), 1, placement):
        for day_idx in order:
            yield c0, min(chunk, n_days - c0), ds, day_idx
            c0 += chunk


def predict_panel(model, config, dataset: PanelDataset, days: np.ndarray,
                  stochastic: Optional[bool] = None, seed: int = 0,
                  chunk: int = 32, int8: bool = False,
                  params: Optional[dict] = None, mesh=None) -> np.ndarray:
    """(len(days), N_max) float32 scores; padded or absent stocks are NaN.

    `model` is a `FactorVAE` on `dataset.device` and `config` the Config to
    score under: its `model.compute_dtype` is the compute dtype. `params`
    (parameter name -> tensor, or a `quantize_params` tree) replace the
    model's own weights; with `int8`, the weights (these or the model's) are
    quantized unless they already are. On a `mesh` every rank scores its
    stocks and returns the whole array (the module docstring)."""
    model = with_compute_dtype(model, config.model.compute_dtype)
    if int8:
        params = ensure_quantized(model if params is None else params)
    days = np.asarray(days, np.int64)
    n_days = len(days)
    out = np.full((n_days, dataset.n_max), np.nan, np.float32)
    generator = None
    sample = model.cfg.stochastic_inference if stochastic is None else stochastic
    if sample:
        generator = torch.Generator(device=dataset.device).manual_seed(seed)
    placement, stock = _mesh_scoring(mesh, dataset)
    with torch.inference_mode():
        for c0, n_sel, ds, day_idx in _score_chunks(dataset, days, chunk, placement):
            x, _, mask = ds.gather(torch.clamp(day_idx, min=0))
            mask = mask & (day_idx >= 0)[:, None]
            kw = dict(stochastic=sample, generator=generator)
            if stock is not None:
                n = mask.shape[1]
                kw["stock"] = stock
                if sample:
                    kw["eps"] = torch.randn((mask.shape[0], n * stock.size), generator=generator,
                                            device=mask.device, dtype=model.cfg.dtype
                                            )[:, stock.index * n:(stock.index + 1) * n]
            if params is None:
                scores = model.day_batched_prediction(x, mask, **kw)
            else:
                weights = dequantize_params(params, model.cfg.dtype) if int8 else params
                scores = call_with(model, weights, "day_batched_prediction", x, mask, **kw)
            if stock is not None:
                from factorvae_tpu_torch.parallel.collective_ops import all_gather_stocks

                scores = all_gather_stocks(scores, stock, dim=1)
            out[c0:c0 + n_sel] = scores[:n_sel].cpu().numpy()
    return out


def _mesh_scoring(mesh, dataset):
    """(stream placement, 'stock' Axis) of scoring on `mesh`, the dataset
    sharded in place; (None, None) without one."""
    if mesh is None:
        return None, None
    from factorvae_tpu_torch.parallel.mesh import STOCK_AXIS
    from factorvae_tpu_torch.parallel.sharding import chunk_placement, shard_dataset

    shard_dataset(mesh, dataset)
    return chunk_placement(mesh), mesh.axis(STOCK_AXIS)


def stack_params(trees: list) -> dict:
    """S parameter trees (name -> tensor, or QTensor in a quantized tree)
    stacked on a leading lane axis; a QTensor stacks its q and s apart, so
    each lane keeps its own scales."""
    out = {}
    for name, first in trees[0].items():
        vals = [t[name] for t in trees]
        if isinstance(first, QTensor):
            out[name] = QTensor(torch.stack([v.q for v in vals]),
                                torch.stack([v.s for v in vals]))
        else:
            out[name] = torch.stack([v.detach() for v in vals])
    return out


def lane_params(params: dict, lane: int) -> dict:
    """Lane `lane` of a stacked tree (QTensors included)."""
    return {n: QTensor(v.q[lane], v.s[lane]) if isinstance(v, QTensor) else v[lane]
            for n, v in params.items()}


def predict_panel_fleet(params: dict, config, dataset: PanelDataset, days: np.ndarray,
                        stochastic: Optional[bool] = None, seed: int = 0,
                        int8: bool = False, mesh=None) -> np.ndarray:
    """(S, len(days), N_max) float32 scores of S stacked parameter sets
    (name -> (S, ...) tensors on `dataset.device`, QTensors with `int8`)
    under `config`, in `predict_panel`'s 32-day chunks. Lane i equals
    `predict_panel` of lane i's weights: bitwise at S = 1, which takes that
    path, within f32 rounding else (the batched products). On a `mesh`
    every rank scores every lane over its stocks (`predict_panel`'s)."""
    lanes = next(iter(params.values())).shape[0]
    if int8 and not is_quantized(params):
        params = stack_params([quantize_params(lane_params(params, i))
                               for i in range(lanes)])
    if lanes == 1:
        if int8:
            return predict_panel(model_from_params(config.model, None), config, dataset,
                                 days, stochastic, seed, int8=True,
                                 params=lane_params(params, 0), mesh=mesh)[None]
        return predict_panel(model_from_params(config.model, params, 0), config, dataset,
                             days, stochastic, seed, mesh=mesh)[None]
    model = model_from_params(config.model, None)
    days = np.asarray(days, np.int64)
    n_days = len(days)
    out = np.full((lanes, n_days, dataset.n_max), np.nan, np.float32)
    sample = model.cfg.stochastic_inference if stochastic is None else stochastic
    generator = (torch.Generator(device=dataset.device).manual_seed(seed)
                 if sample else None)

    placement, stock = _mesh_scoring(mesh, dataset)
    kw = {} if stock is None else {"stock": stock}

    def one(p, x, mask, eps):
        return call_with(model, p, "day_batched_prediction", x, mask, stochastic=sample,
                         eps=eps, **kw)

    with torch.inference_mode():
        for c0, n_sel, ds, day_idx in _score_chunks(dataset, days, 32, placement):
            x, _, mask = ds.gather(torch.clamp(day_idx, min=0))
            mask = mask & (day_idx >= 0)[:, None]
            n = mask.shape[1]
            eps = (torch.randn((mask.shape[0], n * (stock.size if stock else 1)),
                               generator=generator, device=dataset.device)
                   if sample else None)
            if eps is not None and stock is not None:
                eps = eps[:, stock.index * n:(stock.index + 1) * n]
            weights = dequantize_params(params, model.cfg.dtype) if int8 else params
            scores = torch.func.vmap(one, in_dims=(0, None, None, None))(weights, x, mask, eps)
            if stock is not None:
                from factorvae_tpu_torch.parallel.collective_ops import all_gather_stocks

                scores = all_gather_stocks(scores, stock, dim=2)
            out[:, c0:c0 + n_sel] = scores[:, :n_sel].cpu().numpy()
    return out


def fleet_prediction_scores(params: dict, config, dataset: PanelDataset,
                            start: Optional[str] = None, end: Optional[str] = None,
                            stochastic: Optional[bool] = None, seed: int = 0,
                            with_labels: bool = False) -> list:
    """Per-lane score DataFrames (`generate_prediction_scores`'s schema) from
    one lane-batched scoring pass."""
    days = dataset.split_days(start, end)
    scores = predict_panel_fleet(params, config, dataset, days, stochastic, seed)
    return [score_frame(score_table(dataset, days, s, with_labels)) for s in scores]


def score_table(dataset: PanelDataset, days: np.ndarray, scores: np.ndarray,
                with_labels: bool = False) -> dict:
    """The score frame's columns, one entry per valid (day, stock) of
    `days` in day-major order: "datetime" (datetime64[D]), "instrument",
    "score" (float32) and, with_labels=True, "LABEL0" (float32)."""
    days = np.asarray(days, np.int64)
    valid = dataset.valid[days]
    day_pos, inst_pos = np.nonzero(valid)
    table = {"datetime": np.asarray(dataset.dates)[days[day_pos]],
             "instrument": np.asarray(dataset.instruments)[inst_pos],
             "score": np.asarray(scores, np.float32)[valid]}
    if with_labels:
        table["LABEL0"] = dataset.day_labels(days)[valid].astype(np.float32)
    return table


def generate_prediction_scores(model, config, dataset: PanelDataset,
                               start: Optional[str] = None,
                               end: Optional[str] = None,
                               stochastic: Optional[bool] = None,
                               seed: int = 0, with_labels: bool = False,
                               int8: bool = False, mesh=None):
    """Scores DataFrame indexed by (datetime, instrument) with a 'score'
    column (and 'LABEL0' when with_labels=True)."""
    days = dataset.split_days(start, end)
    return score_frame(score_table(
        dataset, days, predict_panel(model, config, dataset, days, stochastic, seed,
                                     int8=int8, mesh=mesh), with_labels))


def score_frame(table: dict):
    """A `score_table` as the (datetime, instrument)-indexed DataFrame."""
    import pandas as pd

    idx = pd.MultiIndex.from_arrays(
        [pd.DatetimeIndex(table["datetime"].astype("datetime64[ns]")),
         table["instrument"]], names=["datetime", "instrument"])
    return pd.DataFrame({c: table[c] for c in ("score", "LABEL0") if c in table},
                        index=idx)


def _cell(v: np.float32) -> str:
    # the shortest text that parses back to the same float32; NaN empty,
    # as pandas writes it
    return "" if np.isnan(v) else str(v)


def export_scores(table: dict, config, out_dir: str = "./scores") -> str:
    """Write a `score_table` as `<out_dir>/<config.score_name()>.csv`: the
    JAX package's file (columns datetime, instrument, score[, LABEL0],
    dates as YYYY-MM-DD, the same row order)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, config.score_name() + ".csv")
    value_cols = [c for c in ("score", "LABEL0") if c in table]
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(["datetime", "instrument"] + value_cols)
        cols = [table["datetime"].astype(str), table["instrument"]]
        cols += [[_cell(v) for v in table[c]] for c in value_cols]
        w.writerows(zip(*cols))
    return path
