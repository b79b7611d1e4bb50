"""`python -m factorvae_tpu_torch.serve`: the scoring daemon.

    printf '%s\\n' '{"id":1,"model":"flagship","day":5,"top":3}' \\
        '{"cmd":"stats"}' \\
      | python -m factorvae_tpu_torch.serve --synthetic 80,300

    python -m factorvae_tpu_torch.serve --model DIR --dataset panel.pkl --batch reqs.jsonl
    python -m factorvae_tpu_torch.serve --model DIR --dataset panel.pkl --http 8787 --scheduler

Serves a synthetic dense panel (`--synthetic DAYS,STOCKS`) or a reference
pickle (`--dataset`). Models come from weights directories (`--model DIR`,
repeatable; alias = the directory name) or, without one, a preset with
random weights drawn from `--seed` (alias = the preset name), each admitted
at `--precision` (float32, bfloat16 or int8; `plan`, the default, resolves
to float32: the port has no plan table yet, and the JAX package's plan
rows were measured on a TPU). Requests come from stdin (JSONL; an array
line is one tick), a `--batch` file, or HTTP (`--http PORT`, threaded with
`--scheduler`). Runs on CUDA unless `--device cpu` is given. The worker
pool, the router and the AOT store (`--workers` above 1, `--router_port`,
`--aot_store`, `--join`, ...) are ROADMAP Queue 1 item 6's second half and
exit 2. Startup lines go to stderr; stdout is the response stream.
"""

from __future__ import annotations

import argparse
import sys

import torch

# flag -> the value that means "not asked for"; anything else exits 2
_POOL_FLAGS = {"workers": 1, "router_port": None, "aot_store": None, "join": None,
               "advertise_host": None, "slo_ms": None, "hedge_ms": None,
               "no_hedge": False, "autoscale": 0, "max_inflight": None}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m factorvae_tpu_torch.serve",
                                description="long-lived scoring daemon over a registry "
                                            "of resident models")
    p.add_argument("--model", action="append", default=[], metavar="DIR",
                   help="weights directory (params.save_weights layout), repeatable")
    p.add_argument("--preset", default="flagship",
                   help="preset served with random weights when no --model")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights and of sampling")
    p.add_argument("--synthetic", default=None, metavar="DAYS,STOCKS")
    p.add_argument("--dataset", default=None, help="reference-schema pickle")
    p.add_argument("--max_stocks", type=int, default=None)
    p.add_argument("--stochastic", action="store_true",
                   help="sample at inference (default: deterministic scores)")
    p.add_argument("--precision", choices=["plan", "float32", "bfloat16", "int8"],
                   default="plan",
                   help="the rung every model is admitted at; plan = float32 (no "
                        "plan table is ported)")
    p.add_argument("--budget_mb", type=float, default=0,
                   help="registry bytes budget; LRU eviction past it (0 = unbounded). "
                        "Evicted weights directories cold-start back in on demand")
    p.add_argument("--warmup", action="store_true",
                   help="make every model's first scoring call before serving")
    p.add_argument("--batch", default=None, metavar="FILE",
                   help="score this JSONL request file and exit")
    p.add_argument("--out", default=None, help="response JSONL path for --batch "
                                               "(default stdout)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve HTTP on 127.0.0.1:PORT instead of stdin")
    p.add_argument("--tick_ms", type=float, default=None,
                   help="batching window: stdin lines (default 20) or, with "
                        "--scheduler, how long an under-full tick waits (default 2)")
    p.add_argument("--max_batch", type=int, default=None,
                   help="most requests per tick (default 64)")
    p.add_argument("--scheduler", action="store_true",
                   help="with --http: continuous batching (a threaded server and one "
                        "scheduler thread; concurrent clients fuse into shared ticks)")
    p.add_argument("--deadline_ms", type=float, default=0.0,
                   help="per-request scoring deadline (0 = none; a request's own "
                        "deadline_ms overrides)")
    p.add_argument("--breaker_k", type=int, default=3,
                   help="consecutive failures that open a model's circuit breaker")
    p.add_argument("--breaker_cooldown_s", type=float, default=5.0,
                   help="open-breaker cooldown before one half-open probe")
    p.add_argument("--drift_threshold", type=float, default=0.5,
                   help="day-over-day rank correlation of served scores below which "
                        "a score_drift mark is made (-1 disables)")
    p.add_argument("--metrics_jsonl", default=None,
                   help="RUN.jsonl stream for the timeline's spans and marks")
    p.add_argument("--trace_off", action="store_true",
                   help="no trace contexts or trace fields on spans")
    p.add_argument("--compile_cache", default=None, metavar="DIR",
                   help="accepted and ignored: the kernels' build directory "
                        "(factorvae_tpu_torch/_build) is the port's cache")
    p.add_argument("--device", default="cuda")
    g = p.add_argument_group("worker pool and router (not ported: ROADMAP Queue 1 item 6)")
    g.add_argument("--workers", type=int, default=1)
    g.add_argument("--router_port", type=int, default=None)
    g.add_argument("--aot_store", default=None)
    g.add_argument("--join", default=None)
    g.add_argument("--advertise_host", default=None)
    g.add_argument("--slo_ms", type=float, default=None)
    g.add_argument("--hedge_ms", type=float, default=None)
    g.add_argument("--no_hedge", action="store_true")
    g.add_argument("--autoscale", type=int, default=0)
    g.add_argument("--max_inflight", type=int, default=None)
    return p


def _refusal(args) -> "str | None":
    for name, off in _POOL_FLAGS.items():
        if getattr(args, name) != off:
            return (f"--{name} is not ported: the worker pool, router, remote workers "
                    "and autoscaler are ROADMAP Queue 1 item 6")
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    precision = "float32" if args.precision == "plan" else args.precision
    refused = _refusal(args)
    if refused:
        print(f"error: {refused}", file=sys.stderr)
        return 2
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to serve on the CPU",
              file=sys.stderr)
        return 2
    if bool(args.synthetic) == bool(args.dataset):
        print("error: pass exactly one of --synthetic DAYS,STOCKS and --dataset",
              file=sys.stderr)
        return 2

    import dataclasses

    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.models.factorvae import load_model
    from factorvae_tpu_torch.ops.kernels import hidden_refusal
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.serve.daemon import (
        ScoringDaemon,
        TickScheduler,
        serve_batch_file,
        serve_http,
        serve_stdin,
    )
    from factorvae_tpu_torch.serve.registry import (
        ModelRegistry,
        RegistryError,
        checkpoint_config,
    )
    from factorvae_tpu_torch.utils.logging import MetricsLogger, Timeline, install_timeline

    try:
        if args.model:
            config = checkpoint_config(args.model[0])
        else:
            config = get_preset(args.preset)
            config = dataclasses.replace(
                config, train=dataclasses.replace(config.train, seed=args.seed))
    except (KeyError, OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    refused = hidden_refusal(config.model.hidden_size, args.device)
    if refused:        # before the panel is read
        print(f"error: {refused}", file=sys.stderr)
        return 2

    if args.synthetic:
        from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense

        try:
            n_days, n_stocks = (int(v) for v in args.synthetic.split(","))
        except ValueError:
            print("error: --synthetic wants DAYS,STOCKS (e.g. 80,300)", file=sys.stderr)
            return 2
        panel = synthetic_panel_dense(n_days, n_stocks, config.model.num_features,
                                      seed=args.seed)
    else:
        from factorvae_tpu_torch.data.panel import build_panel, load_frame

        panel = build_panel(load_frame(args.dataset))
    dataset = PanelDataset(panel, seq_len=config.model.seq_len,
                           max_stocks=args.max_stocks, device=args.device)

    logger = MetricsLogger(jsonl_path=args.metrics_jsonl, echo=False, run_name="serve")
    prev_tl = install_timeline(Timeline(logger)) if args.metrics_jsonl else None
    try:
        registry = ModelRegistry(device=args.device,
                                 budget_bytes=int(args.budget_mb * 1e6))
        try:
            if args.model:
                for path in args.model:
                    key = registry.register_checkpoint(path, precision=precision,
                                                       n_stocks=dataset.n_max)
                    entry = registry.get(key)
                    print(f"[serve] admitted {path} as {key} (alias {entry.alias}, "
                          f"{entry.precision}, {entry.nbytes} bytes)", file=sys.stderr)
            else:
                model = load_model(config, device=args.device)
                registry.register_params(model, config, precision=precision,
                                         alias=args.preset)
        except RegistryError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        daemon = ScoringDaemon(registry, dataset,
                               stochastic=None if args.stochastic else False,
                               seed=args.seed, deadline_ms=args.deadline_ms,
                               breaker_k=args.breaker_k,
                               breaker_cooldown_s=args.breaker_cooldown_s,
                               drift_threshold=args.drift_threshold,
                               trace=not args.trace_off)
        if args.warmup:
            for key, wall in registry.warmup(dataset, stochastic=daemon.stochastic).items():
                print(f"[serve] warmed {key} in {wall:.3f}s", file=sys.stderr)
        logger.log("serve_start", _echo=False, models=registry.keys(),
                   n_days=len(dataset.dates), n_max=dataset.n_max)
        print(f"[serve] ready: {len(registry.keys())} model(s) "
              f"{sorted(registry.stats()['aliases'])} at {precision}, panel "
              f"{len(dataset.dates)}d x {dataset.n_max} on {dataset.device}",
              file=sys.stderr)
        max_batch = args.max_batch or 64
        if args.batch:
            out = open(args.out, "w") if args.out else sys.stdout
            try:
                n = serve_batch_file(daemon, args.batch, out, max_batch=max_batch)
            finally:
                if args.out:
                    out.close()
            print(f"[serve] answered {n} request(s) from {args.batch}", file=sys.stderr)
        elif args.http is not None:
            scheduler = None
            if args.scheduler:
                tick_ms = 2.0 if args.tick_ms is None else args.tick_ms
                scheduler = TickScheduler(daemon, tick_ms=tick_ms, max_tick_batch=max_batch)
                print(f"[serve] continuous batching: tick_ms={tick_ms:g} "
                      f"max_tick_batch={max_batch}", file=sys.stderr)
            print(f"[serve] http://127.0.0.1:{args.http}/score", file=sys.stderr)
            serve_http(daemon, args.http, scheduler=scheduler)
        else:
            n = serve_stdin(daemon, sys.stdin, sys.stdout,
                            tick_s=(20.0 if args.tick_ms is None else args.tick_ms) / 1e3,
                            max_batch=max_batch)
            print(f"[serve] answered {n} request(s)", file=sys.stderr)
        logger.log("serve_stop", _echo=False, **{k: v for k, v in daemon.stats().items()
                                                 if k != "run_meta"})
        return 0
    finally:
        if args.metrics_jsonl:
            install_timeline(prev_tl)
        logger.finish()


if __name__ == "__main__":
    sys.exit(main())
