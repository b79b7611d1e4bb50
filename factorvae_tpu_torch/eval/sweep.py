"""Multi-seed Rank-IC sweeps and hyperparameter grids
(`factorvae_tpu/eval/sweep.py`).

Parity with the reference across random streams is statistical: the same
Rank-IC within tolerance across seeds. `seed_sweep` trains S seeds of a
config, scores each deterministically from its best-validation weights and
reports per-seed Rank-IC with their mean and spread; `grid_sweep` races an
(lr, kl_weight) grid, bucketed by shape, and names the winner.

Execution:
- serial (`seed_sweep` default): one `Trainer` per seed, one after another;
- `fleet=True`: the seeds not adopted from `prior_records` train in fleets
  of `seeds_per_program` (default: all of them in one;
  `train/fleet.FleetTrainer`), in order, each scored in one lane-batched
  pass (`eval/predict.predict_panel_fleet`); `grid_sweep` trains each shape
  bucket in programs of `lanes_per_program` lanes the same way. The frame,
  the per-seed artifacts (best weights under the serial names), `on_seed`
  and the adoption of finished seeds are the serial sweep's; per-seed
  numbers match it within f32 rounding, bitwise for a one-seed fleet.

The Rank-IC is computed on the padded score panel (`eval.metrics`), the
numbers the reference's `RankIC` gives on the score frame; pandas is
imported only to build the returned frames.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np

from factorvae_tpu_torch.config import Config
from factorvae_tpu_torch.eval.metrics import rank_ic_of_panel
from factorvae_tpu_torch.eval.predict import predict_panel, predict_panel_fleet
from factorvae_tpu_torch.models.factorvae import load_model
from factorvae_tpu_torch.train.fleet import FleetTrainer
from factorvae_tpu_torch.train.trainer import Trainer
from factorvae_tpu_torch.utils.logging import MetricsLogger

#: grid-point keys that change the step (a program per bucket): points that
#: share them share a fleet; the training dtype buckets like a shape
SHAPE_KEYS = ("num_factors", "hidden_size", "num_portfolios", "compute_dtype")
#: grid-point keys that ride the lane axis: run-time scalars, and the seed
LANE_KEYS = ("lr", "kl_weight", "seed")


def _float_or_nan(v) -> float:
    """A record value, with JSON's null (a NaN written out) as NaN."""
    return float("nan") if v is None else float(v)


def _rank_ic(dataset, days: np.ndarray, scores: np.ndarray) -> tuple:
    ic = rank_ic_of_panel(scores, dataset.day_labels(days), dataset.valid[days])
    return float(ic["RankIC"]), float(ic["RankIC_IR"])


def _adopted_record(seed: int, prev, logger: MetricsLogger, on_seed) -> dict:
    """The record of a seed adopted from `prior_records` without training
    (a bare float is its rank_ic, as older partial files stored it)."""
    if not isinstance(prev, dict):
        prev = {"rank_ic": prev}
    rec = {"seed": int(seed), "rank_ic": _float_or_nan(prev["rank_ic"]),
           "rank_ic_ir": _float_or_nan(prev.get("rank_ic_ir")),
           "best_val": _float_or_nan(prev.get("best_val"))}
    logger.log("sweep_seed_resumed", **rec)
    if on_seed is not None:
        on_seed(rec)
    return rec


def _fleet_scoring_params(state, out, names, logger: MetricsLogger) -> dict:
    """The per-lane best-validation snapshots; a lane whose selection never
    improved (a NaN loss stream) scores its final parameters, as the serial
    sweep does without a checkpoint."""
    best_val = np.asarray(out["best_val"])
    scoring = {n: p.detach().clone() for n, p in out["best_params"].items()}
    final = out.get("final_params", state.params)
    for i, name in enumerate(names):
        if not np.isfinite(best_val[i]):
            logger.log("sweep_warning", **name,
                       note="best-val selection never improved; scoring FINAL-epoch params")
            for n in scoring:
                scoring[n][i] = final[n][i].detach()
    return scoring


def _fleet_records(config: Config, dataset, pending: Sequence[int], days: np.ndarray,
                   logger: MetricsLogger, on_seed, fleet_resume: bool, device,
                   seeds_per_program: Optional[int] = None, mesh=None) -> list:
    """Train `pending` seeds in fleets of `seeds_per_program` (None or 0:
    one fleet), each scored in one lane-batched pass; records in `pending`
    order."""
    spp = len(pending) if not seeds_per_program else max(1, int(seeds_per_program))
    records = []
    for g0 in range(0, len(pending), spp):
        group = list(pending[g0:g0 + spp])
        trainer = FleetTrainer(config, dataset, group, device=device, logger=logger,
                               mesh=mesh)
        state, out = trainer.fit(resume=fleet_resume)
        scoring = _fleet_scoring_params(state, out, [{"seed": int(s)} for s in group],
                                        logger)
        scores = predict_panel_fleet(scoring, config, dataset, days, stochastic=False,
                                     mesh=mesh)
        for i, seed in enumerate(group):
            ic, ir = _rank_ic(dataset, days, scores[i])
            rec = {"seed": int(seed), "rank_ic": ic, "rank_ic_ir": ir,
                   "best_val": float(out["best_val"][i])}
            records.append(rec)
            logger.log("sweep_seed", **rec)
            if on_seed is not None:
                on_seed(rec)
    return records


def seed_sweep(config: Config, dataset, seeds: Sequence[int],
               score_start: Optional[str] = None, score_end: Optional[str] = None,
               logger: Optional[MetricsLogger] = None, on_seed=None,
               prior_records: Optional[dict] = None, fleet: bool = False,
               seeds_per_program: Optional[int] = None, fleet_resume: bool = False,
               device="cuda", mesh=None):
    """A DataFrame indexed by seed with columns [rank_ic, rank_ic_ir,
    best_val]; `.attrs["summary"]` holds their mean and spread.

    `on_seed(rec)` fires after each seed, adopted ones included, so a long
    sweep can persist partial results. `prior_records` maps seed -> a
    finished record (or a bare rank_ic) that is adopted without training.
    `fleet=True` trains the other seeds in fleets of `seeds_per_program`
    (None or 0: one fleet), each scored in one pass; `fleet_resume` lets a
    fleet restore from its lockstep checkpoints. The frame keeps the order
    of `seeds` either way. `mesh` trains and scores every fleet (or serial
    run) on that mesh (`train/fleet.py`, `eval/predict.py`)."""
    import pandas as pd

    logger = logger or MetricsLogger(echo=False)
    prior_records = prior_records or {}
    records, pending = [], []
    days = dataset.split_days(score_start, score_end)
    for seed in seeds:
        if int(seed) in prior_records or str(seed) in prior_records:
            prev = prior_records.get(int(seed), prior_records.get(str(seed)))
            records.append(_adopted_record(seed, prev, logger, on_seed))
            continue
        if fleet:
            pending.append(int(seed))
            continue
        cfg = dataclasses.replace(config, train=dataclasses.replace(config.train,
                                                                    seed=int(seed)))
        state, out = Trainer(cfg, dataset, device=device, logger=logger, mesh=mesh).fit()
        # score with the seed's best-validation weights (the reference's
        # selection rule; the checkpoint name encodes the seed)
        best = os.path.join(cfg.train.save_dir, cfg.checkpoint_name())
        if os.path.isdir(best):
            model = load_model(cfg, best, device=device)
        else:
            logger.log("sweep_warning", seed=int(seed),
                       note=f"best-val checkpoint missing at {best}; scoring FINAL-epoch "
                            "params")
            model = state.model.eval()
        ic, ir = _rank_ic(dataset, days, predict_panel(model, cfg, dataset, days,
                                                       stochastic=False, mesh=mesh))
        rec = {"seed": int(seed), "rank_ic": ic, "rank_ic_ir": ir,
               "best_val": float(out["best_val"])}
        records.append(rec)
        logger.log("sweep_seed", **rec)
        if on_seed is not None:
            on_seed(rec)
    if pending:
        records.extend(_fleet_records(config, dataset, pending, days, logger, on_seed,
                                      fleet_resume, device, seeds_per_program, mesh))
        order = {int(s): i for i, s in enumerate(seeds)}
        records.sort(key=lambda r: order[r["seed"]])
    df = pd.DataFrame(records).set_index("seed")
    df.attrs["summary"] = {
        "rank_ic_mean": float(df["rank_ic"].mean()),
        "rank_ic_std": float(df["rank_ic"].std(ddof=0)),
        "rank_ic_ir_mean": float(df["rank_ic_ir"].mean()),
        "rank_ic_ir_num_seeds": int(df["rank_ic_ir"].notna().sum()),
        "num_seeds": len(df),
    }
    logger.log("sweep_summary", **df.attrs["summary"])
    return df


# ---- hyperparameter grids ---------------------------------------------------


def parse_hyper_grid(spec: str) -> list:
    """'1e-4:1.0,3e-4:0.1' -> [{"lr": 1e-4, "kl_weight": 1.0}, ...]; an
    optional third field names the training compute dtype
    ('1e-4:1.0:bfloat16'), which buckets that point like a shape."""
    points = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        parts = tok.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(f"bad hyper-grid token {tok!r}: expected lr:kl_weight or "
                             "lr:kl_weight:compute_dtype")
        point = {"lr": float(parts[0]), "kl_weight": float(parts[1])}
        if len(parts) == 3:
            point["compute_dtype"] = parts[2]
        points.append(point)
    return points


def point_label(point: dict) -> str:
    """A grid point's compact label (the frame's index and the resume key)."""
    parts = []
    for key, tag in (("lr", "lr"), ("kl_weight", "kl"), ("num_factors", "K"),
                     ("hidden_size", "H"), ("num_portfolios", "M"),
                     ("compute_dtype", "dt"), ("seed", "s")):
        if key in point:
            v = point[key]
            parts.append(f"{tag}{v:g}" if isinstance(v, float) else f"{tag}{v}")
    return "_".join(parts) or "base"


def shape_bucket_key(point: dict) -> tuple:
    """The point's shape coordinates (None: the base config's)."""
    return tuple(point.get(k) for k in SHAPE_KEYS)


def shape_buckets(points: Sequence[dict]) -> list:
    """[(bucket key, [(index, point), ...]), ...]: buckets in order of first
    occurrence, points in the caller's order within a bucket."""
    order, buckets = [], {}
    for i, p in enumerate(points):
        k = shape_bucket_key(p)
        if k not in buckets:
            buckets[k] = []
            order.append(k)
        buckets[k].append((i, p))
    return [(k, buckets[k]) for k in order]


def _point_config(config: Config, point: dict, label: str) -> Config:
    """One grid point's Config: its shape keys on the model, its lane
    scalars on train and model, and the run_name tagged with the label so
    that same-seed lanes write their own artifacts."""
    bad = sorted(set(point) - set(SHAPE_KEYS) - set(LANE_KEYS))
    if bad:
        raise ValueError(f"unknown grid-point key(s) {bad}: shape keys are "
                         f"{list(SHAPE_KEYS)}, lane keys are {list(LANE_KEYS)}")
    model_kw = {k: point[k] for k in SHAPE_KEYS if k in point}
    if "kl_weight" in point:
        model_kw["kl_weight"] = float(point["kl_weight"])
    train_kw: dict = {"run_name": f"{config.train.run_name}_{label}"}
    if "lr" in point:
        train_kw["lr"] = float(point["lr"])
    if "seed" in point:
        train_kw["seed"] = int(point["seed"])
    return dataclasses.replace(config, model=dataclasses.replace(config.model, **model_kw),
                               train=dataclasses.replace(config.train, **train_kw))


def grid_sweep(config: Config, dataset, points: Sequence[dict],
               score_start: Optional[str] = None, score_end: Optional[str] = None,
               logger: Optional[MetricsLogger] = None, on_point=None,
               prior_records: Optional[dict] = None,
               lanes_per_program: Optional[int] = None, device="cuda", mesh=None):
    """Race a grid of points (dicts over SHAPE_KEYS and LANE_KEYS) through
    hyper-fleets: the points bucket by shape, each bucket trains in fleets
    of `lanes_per_program` lanes (None or 0: the whole bucket in one), in
    order, and every lane scores from its best-validation snapshot in one
    lane-batched pass per fleet.

    Returns a DataFrame indexed by `point_label` with the point's fields and
    [rank_ic, rank_ic_ir, best_val]; `.attrs["summary"]` names the winner.
    `on_point` and `prior_records` (label -> record) are `seed_sweep`'s
    callback and adoption; `mesh` as `seed_sweep`'s."""
    import pandas as pd

    logger = logger or MetricsLogger(echo=False)
    prior_records = prior_records or {}
    labels = [point_label(p) for p in points]
    dup = {v for v in labels if labels.count(v) > 1}
    if dup:
        raise ValueError(f"duplicate grid points: {sorted(dup)}")
    records: dict = {}
    for label, point in zip(labels, points):
        if label in prior_records:
            prev = dict(prior_records[label])
            rec = {"label": label, **point, "rank_ic": _float_or_nan(prev.get("rank_ic")),
                   "rank_ic_ir": _float_or_nan(prev.get("rank_ic_ir")),
                   "best_val": _float_or_nan(prev.get("best_val"))}
            records[label] = rec
            logger.log("grid_point_resumed", **rec)
            if on_point is not None:
                on_point(rec)
    pending = [(lbl, p) for lbl, p in zip(labels, points) if lbl not in records]
    days = dataset.split_days(score_start, score_end)
    for bucket_key, members in shape_buckets([p for _, p in pending]):
        bucket_labels = [pending[i][0] for i, _ in members]
        bucket_points = [p for _, p in members]
        lpp = (len(bucket_points) if not lanes_per_program
               else max(1, int(lanes_per_program)))
        shape_kw = {k: v for k, v in zip(SHAPE_KEYS, bucket_key) if v is not None}
        bucket_cfg = dataclasses.replace(config,
                                         model=dataclasses.replace(config.model, **shape_kw))
        logger.log("grid_bucket", shape=shape_kw, points=bucket_labels,
                   lanes_per_program=lpp)
        for g0 in range(0, len(bucket_points), lpp):
            group_labels = bucket_labels[g0:g0 + lpp]
            group = bucket_points[g0:g0 + lpp]
            lane_cfgs = [_point_config(config, p, lbl)
                         for p, lbl in zip(group, group_labels)]
            trainer = FleetTrainer(bucket_cfg, dataset, lane_configs=lane_cfgs,
                                   device=device, logger=logger, mesh=mesh)
            state, out = trainer.fit()
            scoring = _fleet_scoring_params(
                state, out, [{"label": lbl} for lbl in group_labels], logger)
            scores = predict_panel_fleet(scoring, bucket_cfg, dataset, days,
                                         stochastic=False, mesh=mesh)
            for i, (lbl, point) in enumerate(zip(group_labels, group)):
                ic, ir = _rank_ic(dataset, days, scores[i])
                rec = {"label": lbl, **point, "rank_ic": ic, "rank_ic_ir": ir,
                       "best_val": float(out["best_val"][i])}
                records[lbl] = rec
                logger.log("grid_point", **rec)
                if on_point is not None:
                    on_point(rec)
    df = pd.DataFrame([records[lbl] for lbl in labels]).set_index("label")
    finite = df["rank_ic"].dropna()
    df.attrs["summary"] = {
        "num_points": len(df),
        "num_buckets": len(shape_buckets(list(points))),
        "best_label": str(finite.idxmax()) if len(finite) else None,
        "best_rank_ic": float(finite.max()) if len(finite) else float("nan"),
    }
    logger.log("grid_summary", **df.attrs["summary"])
    return df
