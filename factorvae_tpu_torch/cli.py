"""The experiment CLI of the port (`factorvae_tpu/cli.py`).

    python -m factorvae_tpu_torch.cli --dataset ./data/csi_data.pkl --num_epochs 30
    python -m factorvae_tpu_torch.cli --score_only ...
    python -m factorvae_tpu_torch.cli --device cpu ...   # the kernels' plain versions

One command reads a reference-schema pickle, trains with validation,
best-validation weights and full-state checkpoints (`--resume` continues
from the newest; a bad streak rolls back, `train/trainer.py`), scores
[--score_start, --score_end] from the best weights, writes the score CSV
under the reference's name, logs RankIC and RankIC_IR, and with
`--backtest` runs the TopkDropout backtest; `--export PATH` writes an AOT
artifact of the best weights (`eval/export_aot.py`, for `--export_platform`
cuda or cpu, default `--device`). Every flag of the JAX CLI is
accepted with its name and default; `--device` (default cuda) picks the
card, where the CUDA kernels always run, or the CPU.

Fleets: `--fleet_seeds N` trains the seeds [seed, seed + N) in one fleet
(`train/fleet.py`, every kernel launched once per step for all of them),
reports the per-seed Rank-IC sweep (`fleet_sweep`), and scores, exports and
backtests the winner: the best Rank-IC among the seeds with a finite
best_val and best weights on disk. `--hyper_grid LR:KLW,...` races the grid
through hyper-fleets (`eval/sweep.grid_sweep`, `hyper_grid`) and goes on
with its winner the same way; `--resume` restores a fleet from its
lockstep checkpoints.

`--panel_residency stream` keeps the panel in host memory: training,
fleets and scoring take it in chunks of `--stream_chunk_days` copied to the
device one chunk ahead (`data/stream.py`), with the "hbm" run's results.

`--auto_plan` takes the knobs the flags leave unset from the port's plan
table (`plan.py`, `PLAN_TABLE_TORCH.json`) for this shape, width and
`--device`: days_per_step, the training and scoring dtypes, the pad target,
the residency, the probes, remat, and the fleets' program widths
(`seeds_per_program` for `--fleet_seeds`; `lanes_per_program`, else
`seeds_per_program` above 1, else the whole grid for `--hyper_grid`); the
`plan` record says what it resolved and from where. An explicit flag keeps
its value. `--compile_cache DIR` (default `$FACTORVAE_COMPILE_CACHE`; `off`
turns it off) builds and loads the CUDA kernels' libraries in DIR, so a
later process given DIR compiles none.

Parallelism: `--mesh` runs on a ('data', 'stock') mesh of every rank of
the world (`parallel/mesh.py`), with `--mesh_stock` ranks on the 'stock'
axis; under `torchrun` (`python -m torch.distributed.run
--nproc_per_node N -m factorvae_tpu_torch.cli --mesh ...`) one rank per
card, and in a single process the 1 x 1 mesh. The process group's backend
follows `--device`: NCCL on cuda (each rank takes `cuda:LOCAL_RANK`), gloo
on the CPU (ranks sharing one card over gloo are `parallel.multihost.
maybe_initialize(backend="gloo")`'s, from Python). The cross-section pads to a multiple of
the 'stock' size too (`config.stock_pad_multiple`). Rank 0 writes the
metrics stream, the checkpoints, the weights and the scores CSV; every rank
trains and scores its shard. `--fleet_seeds` and `--hyper_grid` lay their
lanes over 'data' (a grid of as many points as 'data' ranks trains one
lane a rank). A plan row's mesh block applies only under `--mesh` without
`--mesh_stock`, as in the JAX CLI.

A hidden size above the CUDA kernels' maximum on `--device cuda` exits
with code 2 before the dataset is read.
`--pallas` and `--pallas_auto` change nothing (the kernels always run on
CUDA), and `--num_workers` is unused, as in the JAX CLI.

Precision: `--bf16` trains through the mixed path (float32 master weights
and optimizer, a bfloat16 compute copy per step, a dynamic loss scale) and
scores in bfloat16; `--int8_scores` scores with weight-only int8. An
explicit `--bf16`/`--no-bf16` beats a preset. Unset, the port computes in
float32: the JAX CLI's bfloat16 default is the best setting measured on a
TPU, and the port carries over no default tuned there.

Observability: `--metrics_jsonl PATH` (or `--obs`, whose stream defaults
to `RUN.jsonl`) installs a `Timeline` on the stream, so epochs, stream
chunks, checkpoint saves and kernel builds write their spans there;
`--obs` also turns on the training-health probes (`train.obs_probes`) and
logs an `obs` record. `--prom_textfile PATH` rewrites a Prometheus textfile
after each epoch (`obs/metrics.TextfileExporter`). `--profile DIR` captures
training and scoring under `torch.profiler` (`utils/profiling.trace`;
`python -m factorvae_tpu_torch.utils.trace_summary DIR` reads it), and
`--debug_nans` runs them in autograd's anomaly mode, which raises where a
backward function returns a NaN (`utils/profiling.debug_nans`).

After the panel is built, `run` imports pandas only for `--backtest`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from typing import Optional

import torch

from factorvae_tpu_torch import plan as planlib
from factorvae_tpu_torch.config import Config, DataConfig, MeshConfig, ModelConfig, TrainConfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import build_panel, load_frame
from factorvae_tpu_torch.eval.metrics import rank_ic_of_panel
from factorvae_tpu_torch.eval.predict import export_scores, predict_panel, score_table
from factorvae_tpu_torch.models.factorvae import load_model
from factorvae_tpu_torch.ops.kernels import hidden_refusal
from factorvae_tpu_torch.train.trainer import Trainer
from factorvae_tpu_torch.obs.metrics import TextfileExporter, install_exporter
from factorvae_tpu_torch.utils.logging import MetricsLogger, Timeline, install_timeline
from factorvae_tpu_torch.utils.profiling import debug_nans, trace

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train a FactorVAE model on stock data (PyTorch/CUDA port)")
    # --- reference flags (main.py:92-113) ---
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--num_latent", type=int, default=158,
                   help="number of input features C (reference --num_latent)")
    p.add_argument("--num_portfolio", type=int, default=128)
    p.add_argument("--seq_len", type=int, default=20)
    p.add_argument("--num_factor", type=int, default=96)
    p.add_argument("--hidden_size", type=int, default=64)
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--start_time", type=str, default=None)
    p.add_argument("--fit_end_time", type=str, default=None)
    p.add_argument("--val_start_time", type=str, default=None)
    p.add_argument("--val_end_time", type=str, default=None)
    p.add_argument("--end_time", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--num_workers", type=int, default=4,
                   help="accepted for reference parity; unused (no loader workers)")
    p.add_argument("--wandb", action="store_true")
    # --- extensions of the JAX CLI ---
    p.add_argument("--days_per_step", type=int, default=None,
                   help="days whose grads are averaged per update (1 = reference)")
    p.add_argument("--mesh", action="store_true",
                   help="shard over every rank of the world (a data x stock mesh; "
                        "torchrun starts one rank per card). Composes with "
                        "--fleet_seeds (seed lanes ride the 'data' axis) and "
                        "--panel_residency stream (each rank's rows of every chunk)")
    p.add_argument("--mesh_stock", type=int, default=None,
                   help="size of the 'stock' (cross-section) mesh axis "
                        "(default: 1, or a measured plan row's 'mesh' block under "
                        "--auto_plan)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest full-state checkpoint")
    p.add_argument("--fleet_seeds", type=int, default=None,
                   help="train N seeds [seed, seed+N) at once in one fleet, report the "
                        "per-seed Rank-IC sweep, then score/export with the best seed's "
                        "best-val weights")
    p.add_argument("--hyper_grid", type=str, default=None, metavar="LR:KLW,LR:KLW,...",
                   help="race an lr:kl_weight grid through hyper-fleets (one lane per "
                        "point), then score/export with the best point's best-val weights")
    p.add_argument("--kl_weight", type=float, default=None,
                   help="scale on the summed-over-K KL term (default 1.0)")
    p.add_argument("--recon_loss", choices=["mse", "nll"], default=None,
                   help="mse = the reference's single-sample MSE; nll = Gaussian "
                        "NLL (default: mse, or the preset's choice)")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=None,
                   help="bfloat16 compute: mixed-precision training (float32 master "
                        "weights, a dynamic loss scale) and bfloat16 scoring. Unset "
                        "means float32, the port's default (the JAX CLI's bfloat16 "
                        "default was tuned on a TPU); an explicit flag beats a preset")
    p.add_argument("--pallas", action=argparse.BooleanOptionalAction, default=None,
                   help="--pallas changes nothing (the CUDA kernels always run on "
                        "the card); --no-pallas is refused")
    p.add_argument("--pallas_auto", action="store_true", help="changes nothing")
    p.add_argument("--max_stocks", type=int, default=None,
                   help="cross-section padding N_max (default: inferred)")
    p.add_argument("--panel_residency", choices=["hbm", "stream"], default=None,
                   help="hbm: the panel lives on the device (default); stream: it stays "
                        "in host memory and epochs and scoring take it in chunks copied "
                        "one chunk ahead, with the same results")
    p.add_argument("--stream_chunk_days", type=int, default=None,
                   help="days per chunk under --panel_residency stream (default 32)")
    p.add_argument("--auto_plan", action=argparse.BooleanOptionalAction, default=False,
                   help="take the unset knobs from the measured plan row for this shape "
                        "and device (plan.py), else the conservative default")
    p.add_argument("--score_only", action="store_true",
                   help="skip training; score [--score_start, --score_end] from "
                        "the best checkpoint")
    p.add_argument("--score_start", type=str, default="2019-01-01")
    p.add_argument("--score_end", type=str, default="2020-12-31")
    p.add_argument("--score_dir", type=str, default="./scores")
    p.add_argument("--stochastic_scores", dest="stochastic_scores", action="store_true",
                   default=None,
                   help="sample at inference like the reference (the default)")
    p.add_argument("--deterministic_scores", dest="stochastic_scores",
                   action="store_false",
                   help="score with the prior mean instead of sampling")
    p.add_argument("--int8_scores", action="store_true",
                   help="score with per-channel int8 weights, dequantized to the "
                        "compute dtype for each scoring chunk")
    p.add_argument("--metrics_jsonl", type=str, default=None)
    p.add_argument("--prom_textfile", type=str, default=None, metavar="PATH",
                   help="rewrite a Prometheus textfile of each epoch's metrics here "
                        "(atomically, after every epoch)")
    p.add_argument("--compile_cache", type=str, default=None, metavar="DIR",
                   help="build and load the CUDA kernels' libraries in DIR (default: "
                        "$FACTORVAE_COMPILE_CACHE; 'off' keeps the checkout's _build/)")
    p.add_argument("--obs", action=argparse.BooleanOptionalAction, default=None,
                   help="training-health probes in every epoch record, and a metrics "
                        "stream with a timeline (RUN.jsonl unless --metrics_jsonl)")
    p.add_argument("--preset", type=str, default=None,
                   help="named config preset (factorvae_tpu_torch.presets). It fixes "
                        "the architecture; explicitly passed data and training "
                        "flags override its values")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="capture training and scoring with torch.profiler into DIR")
    p.add_argument("--debug_nans", action="store_true",
                   help="autograd anomaly mode: raise where a backward function "
                        "returns a NaN")
    p.add_argument("--backtest", action="store_true",
                   help="run the TopkDropout backtest on the scores (backtest.ipynb "
                        "cell 6: topk 50, n_drop 10, costs 5bp/15bp)")
    p.add_argument("--backtest_topk", type=int, default=50)
    p.add_argument("--backtest_n_drop", type=int, default=10)
    p.add_argument("--backtest_plot", type=str, default=None, metavar="PNG",
                   help="with --backtest, write the report_graph figure here")
    p.add_argument("--export", type=str, default=None, metavar="PATH",
                   help="write an AOT artifact of the best-val weights here "
                        "(eval/export_aot.py: a torch.export program the serving "
                        "registry admits); int8 with --int8_scores")
    p.add_argument("--export_platform", type=str, default=None,
                   help="the device the artifact is for: cuda or cpu (default: "
                        "--device); the export itself runs on the CPU")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, through the CUDA kernels) or cpu (their "
                        "plain PyTorch versions)")
    return p


def refusal(args: argparse.Namespace) -> Optional[str]:
    """The error line for a flag of a path this package does not port, or
    None."""
    if args.mesh_stock is not None and args.mesh_stock < 1:
        return f"--mesh_stock {args.mesh_stock}: the 'stock' axis needs at least one rank"
    if args.export_platform not in (None, "cuda", "cpu"):
        return (f"--export_platform {args.export_platform}: the port exports "
                "torch.export programs for cuda or cpu; a TPU artifact is the JAX "
                "package's (python -m factorvae_tpu.cli --export)")
    if args.pallas is False:
        return ("--no-pallas: factorvae_tpu_torch has no switch that turns a kernel "
                "off on the card (ROADMAP: on CUDA the kernels always run); "
                "--device cpu runs their plain versions")
    return hidden_refusal(_hidden_size(args), args.device)


def _hidden_size(args: argparse.Namespace) -> int:
    """The hidden size `config_from_args` will give: the preset's, else the
    flag's."""
    if args.preset:
        from factorvae_tpu_torch.presets import get_preset

        try:
            return get_preset(args.preset).model.hidden_size
        except KeyError:        # config_from_args reports the unknown preset
            pass
    return args.hidden_size


# Reference CLI defaults (main.py:92-113), applied when a flag is neither
# passed nor supplied by a preset.
_DEFAULTS = dict(
    num_epochs=30, lr=1e-4, dataset="./data/csi_data.pkl",
    start_time="2009-01-01", fit_end_time="2017-12-31",
    val_start_time="2018-01-01", val_end_time="2018-12-31",
    end_time="2020-12-31", seed=42, run_name="VAE-Revision2",
    save_dir="./best_models", days_per_step=1,
)


def config_from_args(args: argparse.Namespace) -> Config:
    def resolve(name, preset_value=None):
        """Explicit flag > preset value > reference default."""
        v = getattr(args, name)
        if v is not None:
            return v
        return preset_value if preset_value is not None else _DEFAULTS[name]

    if args.preset:
        from factorvae_tpu_torch.presets import get_preset

        try:
            cfg = get_preset(args.preset)
        except KeyError as e:
            raise SystemExit(f"error: {e.args[0]}")
        return dataclasses.replace(
            cfg,
            # the preset fixes the architecture; these behaviour knobs
            # follow the flags
            model=dataclasses.replace(
                cfg.model,
                stochastic_inference=(cfg.model.stochastic_inference
                                      if args.stochastic_scores is None
                                      else args.stochastic_scores),
                recon_loss=args.recon_loss or cfg.model.recon_loss,
                kl_weight=cfg.model.kl_weight if args.kl_weight is None else args.kl_weight,
                compute_dtype=(cfg.model.compute_dtype if args.bf16 is None
                               else "bfloat16" if args.bf16 else "float32")),
            data=dataclasses.replace(
                cfg.data,
                dataset_path=resolve("dataset", cfg.data.dataset_path),
                start_time=resolve("start_time", cfg.data.start_time),
                fit_end_time=resolve("fit_end_time", cfg.data.fit_end_time),
                val_start_time=resolve("val_start_time", cfg.data.val_start_time),
                val_end_time=resolve("val_end_time", cfg.data.val_end_time),
                end_time=resolve("end_time", cfg.data.end_time),
                panel_residency=args.panel_residency or cfg.data.panel_residency,
                stream_chunk_days=(cfg.data.stream_chunk_days
                                   if args.stream_chunk_days is None
                                   else args.stream_chunk_days)),
            train=dataclasses.replace(
                cfg.train,
                num_epochs=resolve("num_epochs", cfg.train.num_epochs),
                lr=resolve("lr", cfg.train.lr),
                seed=resolve("seed", cfg.train.seed),
                run_name=resolve("run_name", cfg.train.run_name),
                save_dir=resolve("save_dir", cfg.train.save_dir),
                days_per_step=resolve("days_per_step", cfg.train.days_per_step),
                wandb=args.wandb,
                obs_probes=cfg.train.obs_probes if args.obs is None else args.obs))
    return Config(
        model=ModelConfig(
            num_features=args.num_latent, hidden_size=args.hidden_size,
            num_factors=args.num_factor, num_portfolios=args.num_portfolio,
            seq_len=args.seq_len, recon_loss=args.recon_loss or "mse",
            kl_weight=1.0 if args.kl_weight is None else args.kl_weight,
            # float32 unless --bf16: the JAX CLI's bfloat16 default was
            # measured best on a TPU
            compute_dtype="bfloat16" if args.bf16 else "float32",
            stochastic_inference=(True if args.stochastic_scores is None
                                  else args.stochastic_scores)),
        data=DataConfig(
            dataset_path=resolve("dataset"), start_time=resolve("start_time"),
            fit_end_time=resolve("fit_end_time"), val_start_time=resolve("val_start_time"),
            val_end_time=resolve("val_end_time"), end_time=resolve("end_time"),
            seq_len=args.seq_len, max_stocks=args.max_stocks,
            panel_residency=args.panel_residency or "hbm",
            stream_chunk_days=32 if args.stream_chunk_days is None else args.stream_chunk_days),
        train=TrainConfig(
            num_epochs=resolve("num_epochs"), lr=resolve("lr"), seed=resolve("seed"),
            days_per_step=resolve("days_per_step"), run_name=resolve("run_name"),
            save_dir=resolve("save_dir"), wandb=args.wandb, obs_probes=bool(args.obs)),
        mesh=MeshConfig(stock_axis=args.mesh_stock or 1),
    )


def _join_world(args: argparse.Namespace) -> argparse.Namespace:
    """`args` of a --mesh run after joining torchrun's process group (a no-op
    in a single process: a world of one), `--device` this rank's card."""
    from factorvae_tpu_torch.parallel import multihost

    multihost.maybe_initialize(device=args.device)
    return argparse.Namespace(**{**vars(args),
                                 "device": str(multihost.local_device(args.device))})


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refused = refusal(args)
    if refused:
        print(f"error: {refused}", file=sys.stderr)
        return 2
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    cfg = config_from_args(args)
    if not os.path.exists(cfg.data.dataset_path):
        print(f"error: dataset not found: {cfg.data.dataset_path} "
              f"(see data/README.md for the qlib ETL recipe)", file=sys.stderr)
        return 2
    try:
        return run(cfg, args, build_panel(load_frame(cfg.data.dataset_path,
                                                     cfg.data.select_feature)))
    finally:
        if args.mesh and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run(cfg: Config, args: argparse.Namespace, panel) -> int:
    """Everything after the panel is built: the compile cache and the plan,
    train (or restore the best weights for --score_only), score, export the
    CSV, RankIC, --backtest, --export's artifact. Returns the exit code."""
    cache_dir = planlib.setup_compilation_cache(args.compile_cache)
    if args.mesh:
        args = _join_world(args)
    rank0 = not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0
    metrics_path = args.metrics_jsonl or ("RUN.jsonl" if args.obs else None)
    if not rank0:
        metrics_path = None
    logger = (MetricsLogger(jsonl_path=metrics_path, use_wandb=cfg.train.wandb,
                            run_name=cfg.train.run_name, config=cfg.to_dict()) if rank0
              else MetricsLogger(echo=False))
    prev_tl = install_timeline(Timeline(logger)) if metrics_path else None
    prev_exp = (install_exporter(TextfileExporter(args.prom_textfile))
                if args.prom_textfile else None)
    # --profile and --debug_nans hold over training and scoring
    observed = contextlib.ExitStack()
    try:
        logger.log("config", json=cfg.to_json())
        if cache_dir:
            logger.log("compile_cache", dir=cache_dir)
        plan = None
        if args.auto_plan:
            plan = planlib.plan_for_config(cfg, panel.num_instruments, platform=args.device,
                                           shard=(args.mesh_stock or 1) if args.mesh else 1)
            cfg = planlib.apply_plan(
                cfg, plan, keep_days_per_step=args.days_per_step is not None,
                keep_dtype=args.bf16 is not None, keep_pad=args.max_stocks is not None,
                keep_residency=(args.panel_residency is not None
                                or args.stream_chunk_days is not None),
                keep_obs=args.obs is not None,
                # a measured mesh-shape row only matters under --mesh, and an
                # explicit --mesh_stock still wins
                keep_mesh=not args.mesh or args.mesh_stock is not None)
            logger.log("plan", **plan.describe(planlib.shape_of(cfg, panel.num_instruments),
                                               platform=args.device))
        if args.obs:
            logger.log("obs", probes=cfg.train.obs_probes, run_jsonl=metrics_path)
        if panel.num_features != cfg.model.num_features:
            print(f"error: model expects {cfg.model.num_features} features "
                  f"(--num_latent/preset) but {cfg.data.dataset_path} has "
                  f"{panel.num_features}", file=sys.stderr)
            return 2
        # the mesh the run trains and scores on, built after the plan (whose
        # row may shape it): a shape the world cannot hold exits 2
        run_mesh, pad = None, cfg.data.pad_multiple
        if args.mesh:
            from factorvae_tpu_torch.config import stock_pad_multiple
            from factorvae_tpu_torch.parallel.mesh import make_mesh

            try:
                run_mesh = make_mesh(cfg.mesh)
            except ValueError as e:
                print(f"error: cannot build the requested (data x stock) mesh over the "
                      f"visible ranks: {e} (--mesh_stock overrides a plan row's shape)",
                      file=sys.stderr)
                return 2
            pad = stock_pad_multiple(pad, cfg.mesh.stock_axis)
        dataset = PanelDataset(panel, seq_len=cfg.data.seq_len,
                               max_stocks=cfg.data.max_stocks,
                               pad_multiple=pad, device=args.device,
                               residency=cfg.data.panel_residency)
        best = os.path.join(cfg.train.save_dir, cfg.checkpoint_name())
        observed.enter_context(trace(args.profile))
        if args.debug_nans:
            observed.enter_context(debug_nans())
        if args.score_only:
            if not os.path.isdir(best):
                print(f"error: no checkpoint at {best}; train first", file=sys.stderr)
                return 2
            model = load_model(cfg, best, device=args.device)
        elif args.hyper_grid or (args.fleet_seeds or 1) > 1:
            try:
                won = (_hyper_grid(cfg, args, dataset, logger, plan, run_mesh)
                       if args.hyper_grid
                       else _fleet_seeds(cfg, args, dataset, logger, plan, run_mesh))
            except ValueError as e:
                if "empty training split" not in str(e):
                    raise
                print(f"error: no trading days in [{cfg.data.start_time}, "
                      f"{cfg.data.fit_end_time}]; adjust --start_time/--fit_end_time",
                      file=sys.stderr)
                return 2
            if isinstance(won, str):
                print(f"error: {won}", file=sys.stderr)
                return 2
            cfg, best = won
            model = load_model(cfg, best, device=args.device)
        else:
            try:
                trainer = Trainer(cfg, dataset, device=args.device, logger=logger,
                                  mesh=run_mesh)
            except ValueError as e:
                if "empty training split" not in str(e):
                    raise
                print(f"error: no trading days in [{cfg.data.start_time}, "
                      f"{cfg.data.fit_end_time}] — the dataset covers "
                      f"[{dataset.dates[0]}, {dataset.dates[-1]}]; "
                      f"adjust --start_time/--fit_end_time", file=sys.stderr)
                return 2
            state, _ = trainer.fit(resume=args.resume)
            # score with the best-validation weights, as the reference's
            # backtest does, not the last step's
            model = (load_model(cfg, best, device=args.device) if os.path.isdir(best)
                     else state.model.eval())

        score_cfg = cfg
        if plan is not None:
            # the plan's scoring knobs; an explicit --bf16/--no-bf16 wins
            m = planlib.score_model_config(cfg.model, plan)
            if args.bf16 is not None:
                m = dataclasses.replace(m, compute_dtype=cfg.model.compute_dtype)
            score_cfg = dataclasses.replace(cfg, model=m)
        t0 = time.perf_counter()
        days = dataset.split_days(args.score_start, args.score_end)
        scores = predict_panel(model, score_cfg, dataset, days, int8=args.int8_scores,
                               mesh=run_mesh)
        score_s = time.perf_counter() - t0
        table = score_table(dataset, days, scores, with_labels=True)
        t0 = time.perf_counter()
        path = export_scores(table, cfg, args.score_dir) if rank0 else None
        export_s = time.perf_counter() - t0
        ic = rank_ic_of_panel(scores, dataset.day_labels(days), dataset.valid[days])
        logger.log("scores", path=path, rank_ic=ic["RankIC"], rank_ic_ir=ic["RankIC_IR"],
                   days=len(days), windows=len(table["score"]), score_s=score_s,
                   export_s=export_s)
        observed.close()
        if not rank0:
            return 0
        if args.backtest:
            _backtest(cfg, args, table, logger)
        if args.export:
            from factorvae_tpu_torch.eval.export_aot import export_prediction

            blob = export_prediction(
                model, cfg, n_max=dataset.n_max, stochastic=cfg.model.stochastic_inference,
                int8=args.int8_scores,
                platform=args.export_platform or torch.device(args.device).type)
            with open(args.export, "wb") as fh:
                fh.write(blob)
            logger.log("export", path=args.export, bytes=len(blob))
        return 0
    finally:
        observed.close()
        logger.finish()
        if metrics_path:
            install_timeline(prev_tl)
        if args.prom_textfile:
            install_exporter(prev_exp)


def _winner(df, ckpt_of) -> "object | None":
    """The frame's index of the best Rank-IC among the rows with a finite
    best_val whose best weights are on disk (`ckpt_of(index)`), or None. A
    row whose selection never improved was scored on its final weights, and
    a directory of that name may be an earlier run's."""
    import numpy as np

    ranked = df["rank_ic"].dropna()
    ranked = ranked[np.isfinite(df.loc[ranked.index, "best_val"].to_numpy(float))]
    ranked = ranked[[os.path.isdir(ckpt_of(i)) for i in ranked.index]]
    return None if ranked.empty else ranked.idxmax()


def _fleet_seeds(cfg: Config, args: argparse.Namespace, dataset, logger, plan,
                 mesh=None):
    """--fleet_seeds: (the winning seed's Config, its best-weights path), or
    the error line. Under --auto_plan the seeds train in fleets of the
    plan's `seeds_per_program`."""
    from factorvae_tpu_torch.eval.sweep import seed_sweep

    seeds = list(range(cfg.train.seed, cfg.train.seed + args.fleet_seeds))
    df = seed_sweep(cfg, dataset, seeds=seeds, score_start=args.score_start,
                    score_end=args.score_end, logger=logger, fleet=True,
                    seeds_per_program=plan.seeds_per_program if plan else None,
                    fleet_resume=args.resume, device=args.device, mesh=mesh)

    def seed_cfg(seed):
        return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=int(seed)))

    def ckpt(seed):
        c = seed_cfg(seed)
        return os.path.join(c.train.save_dir, c.checkpoint_name())

    best_seed = _winner(df, ckpt)
    if best_seed is None:
        return ("no fleet seed with finite rank_ic and a best-val checkpoint; nothing "
                "to score/export (check lr / data ranges)")
    logger.log("fleet_sweep", best_seed=int(best_seed), seeds=seeds, **df.attrs["summary"])
    return seed_cfg(best_seed), ckpt(best_seed)


def _hyper_grid(cfg: Config, args: argparse.Namespace, dataset, logger, plan,
                mesh=None):
    """--hyper_grid: (the winning point's Config, its best-weights path), or
    the error line. Under --auto_plan a bucket trains in fleets of the
    plan's `lanes_per_program`, else of its `seeds_per_program` above 1
    (1 is no signal: single-lane fleets would serialize the grid), else
    whole."""
    from factorvae_tpu_torch.eval.sweep import (
        _point_config,
        grid_sweep,
        parse_hyper_grid,
        point_label,
    )

    points = parse_hyper_grid(args.hyper_grid)
    if not points:
        return "--hyper_grid parsed to zero points (format: LR:KLW,LR:KLW,...)"
    lpp = None
    if plan is not None:
        lpp = plan.lanes_per_program or (
            plan.seeds_per_program if plan.seeds_per_program > 1 else None)
    df = grid_sweep(cfg, dataset, points, score_start=args.score_start,
                    score_end=args.score_end, logger=logger, lanes_per_program=lpp,
                    device=args.device, mesh=mesh)
    by_label = {point_label(p): p for p in points}

    def point_cfg(label):
        return _point_config(cfg, by_label[label], label)

    def ckpt(label):
        c = point_cfg(label)
        return os.path.join(c.train.save_dir, c.checkpoint_name())

    best_label = _winner(df, ckpt)
    if best_label is None:
        return ("no grid point with finite rank_ic and a best-val checkpoint; nothing "
                "to score/export (check the grid / data ranges)")
    logger.log("hyper_grid", best_label=str(best_label), points=list(by_label),
               **{k: v for k, v in df.attrs["summary"].items() if k != "best_label"})
    return point_cfg(best_label), ckpt(best_label)


def _backtest(cfg: Config, args: argparse.Namespace, table: dict, logger) -> None:
    from factorvae_tpu_torch.eval.backtest import simulate_topk_account, topk_dropout_backtest
    from factorvae_tpu_torch.eval.predict import score_frame

    scores = score_frame(table)
    bt = topk_dropout_backtest(scores.dropna(), topk=args.backtest_topk,
                               n_drop=args.backtest_n_drop)
    logger.log("backtest", **{k: v for k, v in bt.summary().items() if v is not None})
    # the account simulator owns the NaN semantics: give it the whole frame
    acct = simulate_topk_account(scores, topk=args.backtest_topk,
                                 n_drop=args.backtest_n_drop)
    logger.log("backtest_account", **{
        k: (v if v is None or isinstance(v, (int, float)) else float(v))
        for k, v in acct.summary().items()})
    if args.backtest_plot:
        from factorvae_tpu_torch.eval.plots import report_graph

        logger.log("backtest_plot", path=report_graph(acct.report, args.backtest_plot,
                                                      title=cfg.train.run_name))


if __name__ == "__main__":
    sys.exit(main())
