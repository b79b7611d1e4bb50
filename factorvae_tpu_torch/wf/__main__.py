"""The walk-forward command: the nightly loop as one resumable command
(`factorvae_tpu/wf/__main__.py`).

    # bootstrap a synthetic rig and run 3 nightly cycles on the card,
    # serving HTTP throughout
    python -m factorvae_tpu_torch.wf --run_dir ./wf_run --cycles 3 \
        --force_refit --epochs 4 --http 8787 --metrics_jsonl RUN_WF.jsonl

    # killed at any stage? the same command resumes the open cycle off the
    # cycle journal (<run_dir>/walkforward_wf.json)
    python -m factorvae_tpu_torch.wf --run_dir ./wf_run --cycles 3 ...

    # the same on the CPU (the kernels' plain versions)
    python -m factorvae_tpu_torch.wf --run_dir ./wf_run --device cpu ...

The command owns the whole triple: a `PanelStore` (seeded from --dataset or
a synthetic panel), a stream-resident `PanelDataset` (appended days are
taken in place), a `ModelRegistry` + `ScoringDaemon` (behind HTTP on
--http while cycles run) and a `WalkForwardOperator` journaling every
stage. Incoming days come from --incoming pickles (one per cycle, the
reference schema) or are synthesized per target generation from the seed,
which is what makes a killed append resumable.

The JAX command's flags, plus `--device` (default cuda). `--compile_cache
DIR` (default `$FACTORVAE_COMPILE_CACHE`; `off` turns it off) builds and
loads the CUDA kernels' libraries in DIR (`plan.setup_compilation_cache`).
Startup lines go to stderr, one JSON summary per cycle to stdout. Exit 2 on
an append, journal or operator error, with its message.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m factorvae_tpu_torch.wf",
        description="walk-forward operator: drift-triggered retrain and "
                    "zero-downtime rollover")
    p.add_argument("--run_dir", required=True,
                   help="operator workspace: journal, incumbent and candidate "
                        "checkpoints, default store location")
    p.add_argument("--store", default=None,
                   help="panel store directory (default: <run_dir>/store)")
    p.add_argument("--dataset", default=None,
                   help="seed the store from this reference-schema pickle when the "
                        "store does not exist yet")
    p.add_argument("--incoming", action="append", default=[], metavar="PICKLE",
                   help="per-cycle incoming panel pickle (repeatable, taken in "
                        "order); without it the incoming days are synthesized")
    p.add_argument("--cycles", type=int, default=1,
                   help="nightly cycles to run (resuming an open cycle counts as one)")
    p.add_argument("--new_days", type=int, default=2,
                   help="synthetic incoming days per cycle")
    p.add_argument("--alias", default="prod", help="serving alias the rollover flips")
    p.add_argument("--epochs", type=int, default=None,
                   help="bootstrap and refit epochs (default: the config's schedule)")
    p.add_argument("--force_refit", action="store_true",
                   help="retrain every cycle instead of only on drift triggers")
    p.add_argument("--cold_ab", action="store_true",
                   help="race a cold-start fit against the warm start each refit "
                        "(holdout Rank-IC decides)")
    p.add_argument("--min_margin", type=float, default=0.0,
                   help="fidelity gate slack: promote when candidate Rank-IC >= "
                        "incumbent - margin")
    p.add_argument("--drift_threshold", type=float, default=0.5,
                   help="day-over-day rank-correlation floor; served correlations "
                        "below it trigger a refit")
    p.add_argument("--holdout_days", type=int, default=1,
                   help="newest labeled days held out for the gate and the A/B")
    p.add_argument("--window_days", type=int, default=0,
                   help="rolling train window in days (0 = expanding)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve scoring HTTP on 127.0.0.1:PORT on a background thread "
                        "while cycles run")
    p.add_argument("--seed", type=int, default=0,
                   help="model seed and synthetic feed seed base")
    # the synthetic rig's shapes (a --dataset sets the features)
    p.add_argument("--init_days", type=int, default=32)
    p.add_argument("--stocks", type=int, default=12)
    p.add_argument("--features", type=int, default=6)
    p.add_argument("--hidden", type=int, default=8)
    p.add_argument("--factors", type=int, default=4)
    p.add_argument("--portfolios", type=int, default=8)
    p.add_argument("--seq_len", type=int, default=5)
    p.add_argument("--metrics_jsonl", default=None,
                   help="RUN.jsonl stream of stage spans, train epochs and serve spans")
    p.add_argument("--compile_cache", default=None, metavar="DIR",
                   help="build and load the CUDA kernels' libraries in DIR (default: "
                        "$FACTORVAE_COMPILE_CACHE; 'off' keeps the checkout's _build/)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, through the CUDA kernels) or cpu (their "
                        "plain PyTorch versions)")
    return p


def _incoming(args, store, gen: int, pending: list):
    """Cycle `gen`'s incoming panel: the next --incoming pickle, else days
    synthesized from the seed after slab gen-1's end (whether or not slab
    gen committed before a crash), the same bytes on every run."""
    if pending:
        from factorvae_tpu_torch.data.panel import build_panel, load_frame

        return build_panel(load_frame(pending.pop(0)))
    from factorvae_tpu_torch.data.synthetic import continuation_panel

    prev_end = store.slabs[gen - 2]["end"] if store.generation >= gen else store.end_date
    return continuation_panel(store.instruments, prev_end, args.new_days,
                              store.num_columns - 1, seed=args.seed * 100003 + gen)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import os
    import threading

    import torch

    from factorvae_tpu_torch.ops.kernels import hidden_refusal

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    refused = hidden_refusal(args.hidden, args.device)
    if refused:
        print(f"error: {refused}", file=sys.stderr)
        return 2
    from factorvae_tpu_torch import plan as planlib

    # before any kernel is built or loaded: a resumed run loads yesterday's
    planlib.setup_compilation_cache(args.compile_cache)

    from factorvae_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from factorvae_tpu_torch.data.append import AppendError, PanelStore
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.serve.daemon import ScoringDaemon, serve_http
    from factorvae_tpu_torch.serve.registry import ModelRegistry
    from factorvae_tpu_torch.utils.logging import MetricsLogger, Timeline, install_timeline
    from factorvae_tpu_torch.wf.journal import CycleJournal, JournalError
    from factorvae_tpu_torch.wf.operator import WalkForwardError, WalkForwardOperator

    run_dir = os.path.abspath(args.run_dir)
    os.makedirs(run_dir, exist_ok=True)
    store_dir = os.path.abspath(args.store or os.path.join(run_dir, "store"))
    logger = MetricsLogger(jsonl_path=args.metrics_jsonl, echo=False, run_name="walkforward")
    prev_tl = install_timeline(Timeline(logger)) if args.metrics_jsonl else None
    http_thread = daemon = None
    try:
        # ---- store -----------------------------------------------------------
        try:
            store = PanelStore(store_dir)
        except AppendError:
            store = None
        if store is None or store.generation == 0:
            # missing, or empty (a create killed before its seed slab): seed it
            if args.dataset:
                from factorvae_tpu_torch.data.panel import build_panel, load_frame

                seed_panel = build_panel(load_frame(args.dataset))
            else:
                seed_panel = synthetic_panel_dense(
                    num_days=args.init_days, num_instruments=args.stocks,
                    num_features=args.features, seed=args.seed)
            store = PanelStore.create(store_dir, seed_panel)
            print(f"[wf] created store {store_dir}: {store.num_days}d x "
                  f"{len(store.instruments)} instruments", file=sys.stderr)
        dataset = PanelDataset(store.load_panel(), seq_len=args.seq_len,
                               device=args.device, residency="stream")

        # ---- config ----------------------------------------------------------
        cfg = Config(
            model=ModelConfig(num_features=dataset.panel.num_features,
                              hidden_size=args.hidden, num_factors=args.factors,
                              num_portfolios=args.portfolios, seq_len=args.seq_len,
                              stochastic_inference=False),
            data=DataConfig(seq_len=args.seq_len, start_time=None, fit_end_time=None,
                            val_start_time=None, val_end_time=None,
                            panel_residency="stream"),
            train=TrainConfig(seed=args.seed, run_name="walkforward",
                              **({"num_epochs": args.epochs} if args.epochs else {})))

        # ---- serving plane ---------------------------------------------------
        daemon = ScoringDaemon(ModelRegistry(device=args.device), dataset,
                               stochastic=False, seed=args.seed,
                               drift_threshold=args.drift_threshold)
        if args.http is not None:
            http_thread = threading.Thread(target=serve_http, args=(daemon, args.http),
                                           name="wf-http")
            http_thread.start()
            print(f"[wf] serving http://127.0.0.1:{args.http}/score during cycles",
                  file=sys.stderr)

        journal = CycleJournal(os.path.join(run_dir, f"{cfg.train.run_name}_wf.json"))
        if journal.recovered_from_backup:
            print("[wf] journal main document was damaged; resumed from .bak (one "
                  "stage may re-run)", file=sys.stderr)
        op = WalkForwardOperator(
            store, dataset, daemon, cfg, run_dir, alias=args.alias, journal=journal,
            refit_epochs=args.epochs, cold_ab=args.cold_ab, force_refit=args.force_refit,
            min_margin=args.min_margin, drift_threshold=args.drift_threshold,
            holdout_days=args.holdout_days, window_days=args.window_days,
            logger=logger, device=args.device)
        key = op.ensure_incumbent(epochs=args.epochs)
        print(f"[wf] incumbent {key[:12]} behind alias {args.alias!r}", file=sys.stderr)

        # ---- cycles ----------------------------------------------------------
        pending = list(args.incoming)
        for _ in range(max(1, args.cycles)):
            gen = int(op.next_cycle_id()[1:])
            summary = op.run_cycle(_incoming(args, store, gen, pending))
            print(json.dumps(summary))
            sys.stdout.flush()
        return 0
    except (AppendError, JournalError, WalkForwardError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if daemon is not None and http_thread is not None:
            daemon.request_drain()
            http_thread.join(timeout=10)
        if args.metrics_jsonl:
            install_timeline(prev_tl)
        logger.finish()


if __name__ == "__main__":
    sys.exit(main())
