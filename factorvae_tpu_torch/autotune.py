"""Race the planner's candidates on the card and write the winners as plan
rows (`scripts/autotune_plan.py` of the JAX package).

    python -m factorvae_tpu_torch.autotune                          # flagship, on the card
    python -m factorvae_tpu_torch.autotune --config alpha360-k60
    python -m factorvae_tpu_torch.autotune --fleet --hyper --stream --serve \\
        --train_precision --remat [--out PLAN_TABLE_TORCH.json] [--dry_run]
    python -m factorvae_tpu_torch.autotune --device cpu --days 4 --reps 1

For each width of the shape (`SHAPES`; the flagship at 300 and 356 stocks)
the tool trains and scores a synthetic panel of `--days` days with each
candidate and writes one row per width, merging adjacent widths whose
winners are identical into one [n_min, n_max] envelope (`race_widths`), into
the port's table (`plan.save_rows`, which supersedes overlapping rows).
The races, each on the winners before it:

- train: days_per_step {1, 8} x {float32, bfloat16} (the port always runs
  the flattened layout, so `flatten_days` is recorded as true), in seconds
  per trained day; score: {float32, bfloat16}, in windows per second;
- `--fleet` / `--hyper`: seeds / heterogeneous (lr, kl_weight) lanes per
  program {1, 2, 4, 8}, in aggregate windows per second;
- `--stream`: hbm against the stream residency at chunks of {16, 32, 64};
- `--serve`: the precision ladder through the registry, a lower rung
  eligible past `SERVE_FIDELITY_FLOOR` rank fidelity against float32, then
  the scheduler's tick window under concurrent clients;
- `--train_precision`: float32 against mixed bfloat16 training, bfloat16
  kept only if faster and past `TRAIN_FIDELITY_FLOOR`;
- `--remat`: none / dots / full, with a doubled days_per_step for a rung
  whose step adds less peak memory (`torch.cuda.max_memory_allocated`;
  None on the CPU, where the doubled batch is not raced).

The conservative default (days_per_step 1, float32, S = 1, hbm, float32
serving, remat none) is always in the raced set, every candidate's time is
stored in the row's `measured`, and a lower rung persists only past its
fidelity floor. Candidates are timed in turns, in ABBA order over `--reps`
rounds, and each keeps its median: hosts differ between calls and within
one. A candidate's first run (which builds or loads the kernel libraries)
is left out of its time and reported as its warm-up. On CUDA each timed run
ends in `torch.cuda.synchronize()`. A failure raises: nothing is retried,
and nothing falls back to the CPU. A row's `source` carries the card's name
and power limit, the commit (`_commit`), the command and `train <x> s/day`,
the form `obs/report` reads.

`--kernels` and `--mesh` exit 2: on CUDA the kernels always run, and a
race over mesh shapes needs more than one card (ROADMAP Queue 1 item 16). Progress goes to stderr (and to
`--metrics_jsonl`); stdout is the rows' JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from factorvae_tpu_torch import plan as planlib
from factorvae_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from factorvae_tpu_torch.utils.logging import MetricsLogger

# real (unpadded) widths; a list races each width as its own point
SHAPES = {
    "flagship": dict(stocks=[300, 356], features=158, seq_len=20, hidden=64,
                     factors=96, portfolios=128),
    "csi300-k60": dict(stocks=300, features=158, seq_len=20, hidden=60,
                       factors=60, portfolios=128),
    "csi800-k60": dict(stocks=800, features=158, seq_len=20, hidden=60,
                       factors=60, portfolios=128),
    "alpha360-k60": dict(stocks=300, features=360, seq_len=60, hidden=60,
                         factors=60, portfolios=128),
}

TRAIN_DAYS_PER_STEP = [1, 8]
DTYPES = ["float32", "bfloat16"]
FLEET_CANDIDATES = [1, 2, 4, 8]
HYPER_CANDIDATES = [1, 2, 4, 8]
STREAM_CHUNK_CANDIDATES = [16, 32, 64]
SERVE_PRECISIONS = ["float32", "bfloat16", "int8"]
SERVE_FIDELITY_FLOOR = 0.99
TRAIN_FIDELITY_FLOOR = 0.80
TRAIN_PRECISION_EPOCHS = 3
REMAT_CANDIDATES = ["none", "dots", "full"]
SERVE_TICK_CANDIDATES = [0.0, 2.0, 10.0]
SERVE_TICK_CLIENTS = 4
SERVE_TICK_MAX_BATCH = 64

_SAVE_DIR = os.path.join(tempfile.gettempdir(), "factorvae_torch_autotune")   # never written


def _log(logger, event: str, **fields) -> None:
    if logger is not None:
        logger.log(event, **fields)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _interleaved(runs: dict, reps: int, device) -> tuple:
    """({key: median seconds of one run}, {key: warm-up seconds}) of the
    zero-argument callables `runs`: each runs once untimed (it builds or
    loads the libraries), then every candidate once per round, the rounds in
    ABBA order."""
    warm, times = {}, {k: [] for k in runs}
    for key, run in runs.items():
        t0 = time.perf_counter()
        run()
        _sync(device)
        warm[key] = time.perf_counter() - t0
    keys = list(runs)
    for r in range(max(1, reps)):
        for key in (keys if r % 2 == 0 else keys[::-1]):
            _sync(device)
            t0 = time.perf_counter()
            runs[key]()
            _sync(device)
            times[key].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) for k, v in times.items()}, warm


def _setup(shape: dict, dtype: str, dps: int, days: int, device,
           residency: str = "hbm", chunk_days: int = 32):
    """(Config, PanelDataset) of one candidate: a synthetic panel of `days`
    days at the shape's real width, padded by the plan's pad policy."""
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense

    cfg = Config(
        model=ModelConfig(num_features=shape["features"], hidden_size=shape["hidden"],
                          num_factors=shape["factors"], num_portfolios=shape["portfolios"],
                          seq_len=shape["seq_len"], compute_dtype=dtype, flatten_days=True),
        data=DataConfig(seq_len=shape["seq_len"], start_time=None, fit_end_time=None,
                        val_start_time=None, val_end_time=None,
                        panel_residency=residency, stream_chunk_days=chunk_days),
        train=TrainConfig(num_epochs=1, days_per_step=dps, seed=0, checkpoint_every=0,
                          save_dir=_SAVE_DIR))
    panel = synthetic_panel_dense(days, shape["stocks"], shape["features"])
    ds = PanelDataset(panel, seq_len=shape["seq_len"],
                      max_stocks=planlib.pad_target_policy(shape["stocks"]), device=device,
                      residency=residency)
    return cfg, ds


def _trainer_run(cfg: Config, ds, device) -> tuple:
    """(run, trainer, state): `run()` trains the next epoch."""
    from factorvae_tpu_torch.train.loop import train_epoch
    from factorvae_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, ds, device=device, logger=MetricsLogger(echo=False))
    state = trainer.init_state()
    epochs = itertools.count()

    def run():
        train_epoch(state, trainer._chunks(trainer.train_days, True, next(epochs)),
                    guard=cfg.train.finite_guard, compute_dtype=trainer.model_cfg.dtype,
                    loss_scale_cfg=trainer.loss_scale_cfg, remat=cfg.train.remat)

    return run, trainer, state


def _fleet_run(cfg: Config, ds, device, lanes: Optional[list] = None,
               seeds: Optional[list] = None) -> Callable:
    from factorvae_tpu_torch.train.fleet import FleetTrainer

    trainer = FleetTrainer(cfg, ds, seeds=seeds, lane_configs=lanes, device=device,
                           logger=MetricsLogger(echo=False))
    run_state = trainer.init_fleet_state()
    epochs = itertools.count()
    return lambda: trainer._run_train_epoch(run_state, next(epochs))


def _train_key(dps: int, dtype: str) -> str:
    return f"flat=1_dps{dps}_{dtype}"


def race_train(name: str, shape: dict, days: int, reps: int, device, logger=None) -> dict:
    """The train race: seconds per trained day of each (days_per_step,
    dtype), and each candidate's warm-up."""
    runs, n_days = {}, {}
    for dps in TRAIN_DAYS_PER_STEP:
        for dtype in DTYPES:
            cfg, ds = _setup(shape, dtype, dps, days, device)
            run, trainer, _ = _trainer_run(cfg, ds, device)
            runs[_train_key(dps, dtype)] = run
            n_days[_train_key(dps, dtype)] = len(trainer.train_days)
    secs, warm = _interleaved(runs, reps, device)
    rates = {k: round(secs[k] / n_days[k], 5) for k in runs}
    for k in runs:
        _log(logger, "autotune_train_candidate", shape=name, candidate=k,
             s_per_day=rates[k], warmup_s=round(warm[k], 3))
    return {"rates": rates, "warmup_s": {k: round(v, 3) for k, v in warm.items()}}


def race_score(name: str, shape: dict, days: int, reps: int, device, logger=None) -> dict:
    """The score race: deterministic windows per second of each dtype
    through `predict_panel`."""
    from factorvae_tpu_torch.eval.predict import predict_panel
    from factorvae_tpu_torch.models.factorvae import load_model

    runs = {}
    for dtype in DTYPES:
        cfg, ds = _setup(shape, dtype, 1, days, device)
        model = load_model(cfg, device=device)
        day_idx = ds.split_days(None, None)
        chunk = min(16, len(day_idx))
        runs[f"flat=1_{dtype}"] = (lambda m=model, c=cfg, d=ds, i=day_idx, k=chunk:
                                   predict_panel(m, c, d, i, stochastic=False, chunk=k))
    secs, _ = _interleaved(runs, reps, device)
    rates = {k: round(len(day_idx) * shape["stocks"] / secs[k], 1) for k in runs}
    for k in runs:
        _log(logger, "autotune_score_candidate", shape=name, candidate=k,
             windows_per_sec=rates[k])
    return rates


def race_fleet(name: str, shape: dict, train_knobs: dict, days: int, reps: int, device,
               logger=None) -> dict:
    """`seeds_per_program`: aggregate windows per second and seed of a seed
    fleet of each width; S = 1 is the serial path."""
    runs = {}
    for s in FLEET_CANDIDATES:
        cfg, ds = _setup(shape, train_knobs["compute_dtype"], train_knobs["days_per_step"],
                         days, device)
        runs[s] = _fleet_run(cfg, ds, device, seeds=list(range(s)))
    secs, _ = _interleaved(runs, reps, device)
    measured = {f"S={s}": round(days * shape["stocks"] * s / secs[s], 1) for s in runs}
    best = max(FLEET_CANDIDATES, key=lambda s: measured[f"S={s}"])
    for s in runs:
        _log(logger, "autotune_fleet_candidate", shape=name, seeds=s,
             aggregate_windows_per_sec_seed=measured[f"S={s}"])
    return {"seeds_per_program": best, "measured": measured,
            "source": f"fleet race on {_knobs(train_knobs)}: best S={best} at "
                      f"{measured[f'S={best}']:,.0f} w/s·seed"}


def hyper_lane_spread(cfg: Config, num_lanes: int) -> list:
    """Lane i: lr x 1.25^i, kl_weight x 0.5^i, seed i, its own run_name."""
    return [dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, kl_weight=cfg.model.kl_weight * 0.5 ** i),
        train=dataclasses.replace(cfg.train, seed=i, lr=cfg.train.lr * 1.25 ** i,
                                  run_name=f"{cfg.train.run_name}_hl{i}"))
        for i in range(num_lanes)]


def race_hyper(name: str, shape: dict, train_knobs: dict, days: int, reps: int, device,
               logger=None) -> dict:
    """`lanes_per_program`: aggregate windows per second and config of a
    hyper-fleet of each width (S = 1 folds to the serial path)."""
    runs = {}
    for s in HYPER_CANDIDATES:
        cfg, ds = _setup(shape, train_knobs["compute_dtype"], train_knobs["days_per_step"],
                         days, device)
        runs[s] = _fleet_run(cfg, ds, device, lanes=hyper_lane_spread(cfg, s))
    secs, _ = _interleaved(runs, reps, device)
    measured = {f"S={s}": round(days * shape["stocks"] * s / secs[s], 1) for s in runs}
    best = max(HYPER_CANDIDATES, key=lambda s: measured[f"S={s}"])
    for s in runs:
        _log(logger, "autotune_hyper_candidate", shape=name, lanes=s,
             aggregate_windows_per_sec_config=measured[f"S={s}"])
    return {"lanes_per_program": best, "measured": measured,
            "source": f"hyper race on {_knobs(train_knobs)}: best S={best} at "
                      f"{measured[f'S={best}']:,.0f} w/s·config"}


def race_stream(name: str, shape: dict, train_knobs: dict, days: int, reps: int, device,
                logger=None) -> dict:
    """The residency: seconds per trained day under hbm and the stream at
    each chunk size."""
    runs, n_days = {}, {}
    for residency, chunk in [("hbm", 0)] + [("stream", c) for c in STREAM_CHUNK_CANDIDATES]:
        key = "hbm" if residency == "hbm" else f"stream_c{chunk}"
        cfg, ds = _setup(shape, train_knobs["compute_dtype"], train_knobs["days_per_step"],
                         days, device, residency=residency, chunk_days=chunk or 32)
        runs[key], trainer, _ = _trainer_run(cfg, ds, device)
        n_days[key] = len(trainer.train_days)
    secs, _ = _interleaved(runs, reps, device)
    measured = {k: round(secs[k] / n_days[k], 5) for k in runs}
    best = min(runs, key=lambda k: measured[k])
    for k in runs:
        _log(logger, "autotune_stream_candidate", shape=name, candidate=k,
             s_per_day=measured[k])
    return {"panel_residency": "hbm" if best == "hbm" else "stream",
            "chunk_days": 32 if best == "hbm" else int(best[len("stream_c"):]),
            "measured": measured,
            "source": f"residency race on {_knobs(train_knobs)}: best "
                      f"{best.replace('_c', ' c')} at {measured[best]:.4f} s/day"}


def _rank_corr(a: np.ndarray, b: np.ndarray) -> float:
    """Mean per-day Spearman correlation (average ranks, through
    `ops.stats.masked_spearman`) of two (D, N_max) score grids, NaN =
    padding; days with fewer than 3 common stocks are skipped."""
    from factorvae_tpu_torch.ops.stats import masked_spearman

    cs = []
    for i in range(a.shape[0]):
        v = np.isfinite(a[i]) & np.isfinite(b[i])
        if v.sum() < 3:
            continue
        c = float(masked_spearman(torch.from_numpy(np.nan_to_num(a[i]).astype(np.float32)),
                                  torch.from_numpy(np.nan_to_num(b[i]).astype(np.float32)),
                                  torch.from_numpy(v)))
        if np.isfinite(c):
            cs.append(c)
    return float(np.mean(cs)) if cs else float("nan")


def serve_winner(rates: dict, fidelity: dict) -> str:
    """The fastest rung whose rank fidelity against float32 clears
    SERVE_FIDELITY_FLOOR (float32 always does)."""
    eligible = [p for p in SERVE_PRECISIONS
                if p == "float32" or fidelity[p] >= SERVE_FIDELITY_FLOOR]
    return max(eligible, key=lambda p: rates[p])


def train_precision_winner(f32_s: float, bf16_s: float, corr: float) -> str:
    """bfloat16 only when faster per trained day and past
    TRAIN_FIDELITY_FLOOR; float32 otherwise."""
    ok = corr == corr and corr >= TRAIN_FIDELITY_FLOOR
    return "bfloat16" if ok and bf16_s < f32_s else "float32"


def race_serve(name: str, shape: dict, score_knobs: dict, days: int, reps: int, device,
               logger=None) -> dict:
    """The serving ladder through the registry's scoring path, then the
    scheduler's tick window at the winning rung."""
    from factorvae_tpu_torch.models.factorvae import load_model
    from factorvae_tpu_torch.serve.registry import ModelRegistry

    cfg, ds = _setup(shape, "float32", 1, days, device)
    model = load_model(cfg, device=device)
    day_idx = ds.split_days(None, None)
    reg = ModelRegistry(device=device)
    keys = {p: reg.register_params(model, cfg, precision=p) for p in SERVE_PRECISIONS}
    out: dict = {}

    def scorer(p):
        def run():
            out[p] = reg.score(keys[p], ds, day_idx)
        return run

    secs, _ = _interleaved({p: scorer(p) for p in SERVE_PRECISIONS}, reps, device)
    rates = {p: round(len(day_idx) * shape["stocks"] / secs[p], 1) for p in SERVE_PRECISIONS}
    fidelity = {p: round(1.0 if p == "float32" else _rank_corr(out[p], out["float32"]), 4)
                for p in SERVE_PRECISIONS}
    for p in SERVE_PRECISIONS:
        _log(logger, "autotune_serve_candidate", shape=name, precision=p,
             windows_per_sec=rates[p], rank_fidelity=fidelity[p])
    best = serve_winner(rates, fidelity)
    tick = race_serve_tick(name, cfg, model, reg, ds, day_idx, best, reps, device,
                           logger=logger)
    return {"precision": best, "tick_ms": tick["tick_ms"],
            "max_tick_batch": tick["max_tick_batch"], "measured": rates,
            "fidelity": fidelity, "tick_measured": tick["measured"],
            "source": f"serve precision race on score {_knobs(score_knobs)}: best {best} "
                      f"at {rates[best]:,.0f} w/s (rank-fidelity floor "
                      f"{SERVE_FIDELITY_FLOOR}); {tick['source']}"}


def race_serve_tick(name: str, cfg: Config, model, reg, ds, day_idx, precision: str,
                    reps: int, device, logger=None) -> dict:
    """The scheduler's window: requests per second of SERVE_TICK_CLIENTS
    closed-loop clients sending one-day requests for two models of the
    winning rung through a TickScheduler at each tick_ms."""
    from factorvae_tpu_torch.serve.daemon import ScoringDaemon, TickScheduler

    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              seed=cfg.train.seed + 1000))
    keys = [reg.register_params(model, c, precision=precision) for c in (cfg, cfg2)]
    daemon = ScoringDaemon(reg, ds)
    day = int(day_idx[-1])
    per_client = max(10, 5 * reps)

    def burst(tick_ms: float, n: int):
        sched = TickScheduler(daemon, tick_ms=tick_ms, max_tick_batch=SERVE_TICK_MAX_BATCH)
        try:
            def client(tid):
                for i in range(n):
                    resp = sched.submit([{"model": keys[(tid + i) % 2], "day": day,
                                          "top": 3}])
                    if not resp[0].get("ok"):
                        raise RuntimeError(f"scheduler race: {resp[0]}")

            errors = []

            def guarded(tid):
                try:
                    client(tid)
                except Exception as e:     # re-raised on the racing thread below
                    errors.append(e)

            threads = [threading.Thread(target=guarded, args=(t,))
                       for t in range(SERVE_TICK_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
        finally:
            sched.close()

    runs = {t: (lambda t=t: burst(t, per_client)) for t in SERVE_TICK_CANDIDATES}
    secs, _ = _interleaved(runs, reps, device)
    measured = {f"tick{t:g}ms": round(SERVE_TICK_CLIENTS * per_client / secs[t], 1)
                for t in SERVE_TICK_CANDIDATES}
    best = max(SERVE_TICK_CANDIDATES, key=lambda t: measured[f"tick{t:g}ms"])
    for t in SERVE_TICK_CANDIDATES:
        _log(logger, "autotune_serve_tick_candidate", shape=name, tick_ms=t,
             qps=measured[f"tick{t:g}ms"])
    return {"tick_ms": best, "max_tick_batch": SERVE_TICK_MAX_BATCH, "measured": measured,
            "source": f"scheduler race ({SERVE_TICK_CLIENTS} concurrent clients, "
                      f"{precision}): best tick_ms={best:g} at "
                      f"{measured[f'tick{best:g}ms']:,.0f} req/s"}


def race_train_precision(name: str, shape: dict, train_knobs: dict, train_rates: dict,
                         days: int, reps: int, device, logger=None) -> dict:
    """float32 against mixed bfloat16 training from one init at the winning
    days_per_step, each model scored deterministically in float32; the
    rates are the train race's."""
    from factorvae_tpu_torch.eval.predict import predict_panel

    dps = int(train_knobs["days_per_step"])
    epochs = max(TRAIN_PRECISION_EPOCHS, reps)
    grids = {}
    for dtype in DTYPES:
        cfg, ds = _setup(shape, "float32", dps, days, device)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                 compute_dtype=dtype))
        run, _, state = _trainer_run(cfg, ds, device)
        for _ in range(epochs):
            run()
        grids[dtype] = predict_panel(state.model.eval(), cfg, ds, ds.split_days(None, None),
                                     stochastic=False, chunk=min(16, days))
    corr = _rank_corr(grids["bfloat16"], grids["float32"])
    f32_s, bf16_s = (train_rates[_train_key(dps, d)] for d in DTYPES)
    best = train_precision_winner(f32_s, bf16_s, corr)
    fid = round(corr, 4) if corr == corr else None
    _log(logger, "autotune_train_precision_candidate", shape=name, rank_fidelity=fid,
         f32_s_per_day=f32_s, bf16_s_per_day=bf16_s, winner=best)
    return {"precision": best, "fidelity": fid,
            "measured": {"s_per_day": {"float32": f32_s, "bfloat16": bf16_s},
                         "fidelity": fid, "epochs": epochs},
            "source": f"train-precision race (epochs={epochs}, Rank-IC floor "
                      f"{TRAIN_FIDELITY_FLOOR}): bf16 fidelity "
                      + (f"{corr:.4f}" if corr == corr else "nan") + f", winner {best}"}


def _step_peak(trainer, state, device) -> Optional[int]:
    """The device bytes one train step adds at its peak; None off CUDA."""
    from factorvae_tpu_torch.train.loop import train_step

    if torch.device(device).type != "cuda":
        return None
    ((ds, order),) = trainer._chunks(trainer.train_days, True, 0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    train_step(state, ds, order[0], guard=trainer.cfg.train.finite_guard,
               compute_dtype=trainer.model_cfg.dtype, loss_scale_cfg=trainer.loss_scale_cfg,
               remat=trainer.cfg.train.remat)
    torch.cuda.synchronize()
    return int(torch.cuda.max_memory_allocated() - base)


def race_remat(name: str, shape: dict, train_knobs: dict, days: int, reps: int, device,
               logger=None) -> dict:
    """The remat rung at the winning knobs, in seconds per trained day and
    the peak bytes a step adds; a rung that adds less than "none" also races
    a doubled days_per_step."""
    base_dps = int(train_knobs["days_per_step"])
    points: dict = {}          # candidate key -> (remat, days_per_step)

    def candidates(pairs):
        runs, n_days, peaks = {}, {}, {}
        for remat, dps in pairs:
            cfg, ds = _setup(shape, train_knobs["compute_dtype"], dps, days, device)
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat=remat))
            key = remat if dps == base_dps else f"{remat}_dps{dps}"
            points[key] = (remat, dps)
            runs[key], trainer, state = _trainer_run(cfg, ds, device)
            n_days[key] = len(trainer.train_days)
            peaks[key] = _step_peak(trainer, state, device)
        secs, _ = _interleaved(runs, reps, device)
        return {k: {"s_per_day": round(secs[k] / n_days[k], 5), "peak_bytes": peaks[k]}
                for k in runs}

    measured = candidates([(r, base_dps) for r in REMAT_CANDIDATES])
    none_peak = measured["none"]["peak_bytes"]
    freed = [r for r in REMAT_CANDIDATES[1:] if none_peak and
             measured[r]["peak_bytes"] is not None and measured[r]["peak_bytes"] < none_peak]
    if freed and base_dps * 2 <= days:
        measured.update(candidates([(r, base_dps * 2) for r in freed]))
    for k, m in measured.items():
        _log(logger, "autotune_remat_candidate", shape=name, candidate=k, **m)
    best = min(measured, key=lambda k: measured[k]["s_per_day"])
    remat, dps = points[best]
    cut = {r: (round(1.0 - measured[r]["peak_bytes"] / none_peak, 4)
               if none_peak and measured[r]["peak_bytes"] is not None else None)
           for r in REMAT_CANDIDATES[1:]}
    measured["peak_reduction_frac"] = cut
    return {"remat": remat, "days_per_step": dps, "measured": measured,
            "source": f"remat race on {_knobs(train_knobs)} (peak cut dots={cut['dots']}, "
                      f"full={cut['full']}): best {remat} dps{dps} at "
                      f"{measured[best]['s_per_day']:.4f} s/day"}


def _knobs(k: dict) -> str:
    return (f"{k['compute_dtype']} flat={int(k.get('flatten_days', True))}"
            + (f" dps{k['days_per_step']}" if "days_per_step" in k else ""))


def _card() -> str:
    """`nvidia-smi`'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout
    return out.strip().splitlines()[0]


# `git archive` of a commit writes the commit's hash here (.gitattributes:
# export-subst); a checkout, or an archive of a bare tree, leaves it as is
_ARCHIVED_COMMIT = "$Format:%H$"
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _commit() -> str:
    """The commit the tool runs from: the one `git archive` stamped into
    this file, else the checkout's HEAD ("with uncommitted changes" when
    tracked files differ from it), else "commit not recorded"."""
    if not _ARCHIVED_COMMIT.startswith("$"):
        return f"commit {_ARCHIVED_COMMIT[:12]}"

    def git(*a):
        try:
            r = subprocess.run(["git", "-C", _REPO, *a], capture_output=True, text=True)
        except OSError:
            return None
        return r.stdout.strip() if r.returncode == 0 else None

    # only this checkout's own repository, not one it happens to sit in
    top = git("rev-parse", "--show-toplevel")
    if top is None or os.path.realpath(top) != os.path.realpath(_REPO):
        return "commit not recorded"
    head = git("rev-parse", "--short=12", "HEAD")
    if head is None:
        return "commit not recorded"
    dirty = git("status", "--porcelain", "--untracked-files=no")
    return f"commit {head}" + (" with uncommitted changes" if dirty else "")


def race_shape(name: str, shape: dict, days: int, reps: int, device="cuda",
               fleet: bool = False, stream: bool = False, serve: bool = False,
               hyper: bool = False, train_precision: bool = False, remat: bool = False,
               logger=None, context: str = "") -> dict:
    """Every race for one width (`shape["stocks"]` a scalar); returns its
    plan row. `context` goes into the row's source (the card, the commit,
    the command)."""
    plat = planlib.platform_kind(torch.device(device).type)
    train = race_train(name, shape, days, reps, device, logger=logger)
    best_key = min(train["rates"], key=lambda k: train["rates"][k])
    dps, dtype = int(best_key.split("_")[1][3:]), best_key.split("_")[2]
    best_train = {"flatten_days": True, "days_per_step": dps, "compute_dtype": dtype}
    score = race_score(name, shape, days, reps, device, logger=logger)
    best_score_key = max(score, key=lambda k: score[k])
    best_score = {"flatten_days": True, "compute_dtype": best_score_key.split("_", 1)[1]}
    measured: dict = {"train": train["rates"], "train_warmup_s": train["warmup_s"],
                      "score": score}
    kw = dict(days=days, reps=reps, device=device, logger=logger)
    blocks = {
        "fleet": race_fleet(name, shape, best_train, **kw) if fleet else None,
        "hyper": race_hyper(name, shape, best_train, **kw) if hyper else None,
        "stream": race_stream(name, shape, best_train, **kw) if stream else None,
        "serve": race_serve(name, shape, best_score, **kw) if serve else None,
        "train_precision": (race_train_precision(name, shape, best_train, train["rates"],
                                                 **kw) if train_precision else None),
        "train_remat": race_remat(name, shape, best_train, **kw) if remat else None,
    }
    n = int(shape["stocks"])
    row = {
        "platform": plat,
        "shape": {"c": shape["features"], "t": shape["seq_len"], "h": shape["hidden"],
                  "k": shape["factors"], "m": shape["portfolios"]},
        "n_min": n, "n_max": n, "pad_target": planlib.pad_target_policy(n, plat),
        "train": best_train, "score": best_score, "measured": measured,
        "source": f"autotune {name} n={n} on {plat} ({context}; days={days}, reps={reps}): "
                  f"train {train['rates'][best_key]:.4f} s/day (first epoch "
                  f"{train['warmup_s'][best_key]:.1f}s), score {score[best_score_key]:,.0f} w/s",
    }
    for key, block in blocks.items():
        if block is None:
            continue
        row["source"] += f"; {block['source']}"
        if key == "serve":
            measured["serve"] = {"rates": block["measured"], "fidelity": block["fidelity"],
                                 "tick": block["tick_measured"]}
            # float32 persists no precision key; the scheduler keys always
            row["serve"] = {"tick_ms": block["tick_ms"],
                            "max_tick_batch": block["max_tick_batch"]}
            if block["precision"] != "float32":
                row["serve"]["precision"] = block["precision"]
            continue
        measured[key] = block["measured"]
        if key == "fleet":
            row["fleet"] = {"seeds_per_program": block["seeds_per_program"]}
        elif key == "hyper":
            row["hyper"] = {"lanes_per_program": block["lanes_per_program"]}
        elif key == "stream":
            row["stream"] = {"panel_residency": block["panel_residency"],
                             "chunk_days": block["chunk_days"]}
        elif key == "train_precision" and block["precision"] != "float32":
            row["train_precision"] = {"precision": block["precision"],
                                      "fidelity": block["fidelity"]}
        elif key == "train_remat" and block["remat"] != "none":
            row["train_remat"] = {"remat": block["remat"]}
            if block["days_per_step"] != dps:
                row["train"] = dict(best_train, days_per_step=block["days_per_step"])
    return row


_WINNER_BLOCKS = ("train", "score", "fleet", "stream", "serve", "hyper",
                  "train_precision", "train_remat")


def race_widths(name: str, shape: dict, days: int, reps: int, **kw) -> list:
    """A row per width of `shape["stocks"]`; adjacent widths with identical
    winners merge into one [n_min, n_max] envelope (both bounds measured,
    nothing in between extrapolated)."""
    widths = shape["stocks"] if isinstance(shape["stocks"], (list, tuple)) \
        else [shape["stocks"]]
    rows = [race_shape(name, {**shape, "stocks": int(w)}, days, reps, **kw)
            for w in sorted(widths)]
    merged = [rows[0]]
    for r in rows[1:]:
        p = merged[-1]
        if any(r.get(b) != p.get(b) for b in _WINNER_BLOCKS):
            merged.append(r)
            continue
        if not any(k.startswith("n=") for k in p["measured"]):
            p["measured"] = {f"n={p['n_max']}": p["measured"]}
        p["measured"][f"n={r['n_min']}"] = r["measured"]
        p["n_max"] = r["n_max"]
        p.pop("pad_target", None)      # re-derived per queried width
        p["source"] += f"; identical winners at n={r['n_min']}"
    return merged


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m factorvae_tpu_torch.autotune",
                                description="race the planner's candidates and write "
                                            "plan rows")
    p.add_argument("--config", choices=sorted(SHAPES), default="flagship")
    p.add_argument("--all", action="store_true", help="race every shape")
    p.add_argument("--days", type=int, default=8, help="synthetic panel days per run")
    p.add_argument("--reps", type=int, default=2,
                   help="timed rounds per candidate (ABBA order; medians)")
    p.add_argument("--out", default=None,
                   help="table path (default: $FACTORVAE_TORCH_PLAN_TABLE, else "
                        "PLAN_TABLE_TORCH.json at the repo root)")
    p.add_argument("--fleet", action="store_true", help="race seeds_per_program")
    p.add_argument("--hyper", action="store_true", help="race lanes_per_program")
    p.add_argument("--stream", action="store_true", help="race the panel residency")
    p.add_argument("--serve", action="store_true",
                   help="race the serving precision ladder and the scheduler's tick")
    p.add_argument("--train_precision", action="store_true",
                   help="race float32 against mixed bfloat16 training")
    p.add_argument("--remat", action="store_true", help="race the remat rung")
    p.add_argument("--kernels", action="store_true", help="refused: exits 2")
    p.add_argument("--mesh", action="store_true", help="refused: exits 2")
    p.add_argument("--dry_run", action="store_true", help="print the rows, write nothing")
    p.add_argument("--metrics_jsonl", default=None,
                   help="also append the race events (and kernel builds) to this stream")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.kernels:
        print("error: --kernels: factorvae_tpu_torch has no kernel switch to race (on CUDA "
              "the kernels always run)", file=sys.stderr)
        return 2
    if args.mesh:
        print("error: --mesh: a race over mesh shapes needs more than one card; not "
              "ported to factorvae_tpu_torch (ROADMAP Queue 1 item 16)", file=sys.stderr)
        return 2
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to race on the CPU", file=sys.stderr)
        return 2
    from factorvae_tpu_torch.utils.logging import Timeline, install_timeline

    on_card = torch.device(args.device).type == "cuda"
    # the command as it measures: where the rows went is not part of it
    shown = [a for i, a in enumerate(argv) if a != "--out" and argv[i - 1:i] != ["--out"]]
    context = "; ".join([_card() if on_card else "cpu", _commit(),
                         "python -m factorvae_tpu_torch.autotune " + " ".join(shown)])
    with MetricsLogger(jsonl_path=args.metrics_jsonl, echo=True, echo_to=sys.stderr,
                       run_name="autotune") as lg:
        prev_tl = install_timeline(Timeline(lg)) if args.metrics_jsonl else None
        try:
            names = sorted(SHAPES) if args.all else [args.config]
            rows = [r for n in names
                    for r in race_widths(n, SHAPES[n], args.days, args.reps,
                                         device=args.device, fleet=args.fleet,
                                         stream=args.stream, serve=args.serve,
                                         hyper=args.hyper,
                                         train_precision=args.train_precision,
                                         remat=args.remat, logger=lg, context=context)]
            print(json.dumps({"rows": rows}, indent=1))
            if args.dry_run:
                lg.log("autotune_dry_run", rows=len(rows), note="table not written")
                return 0
            path = planlib.save_rows(rows, path=args.out)
            lg.log("autotune_table_written", rows=len(rows), path=path)
        finally:
            if args.metrics_jsonl:
                install_timeline(prev_tl)
    return 0


if __name__ == "__main__":
    sys.exit(main())
