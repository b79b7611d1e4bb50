"""`python -m factorvae_tpu_torch.serve`: the scoring daemon.

    printf '%s\\n' '{"id":1,"model":"flagship","day":5,"top":3}' \\
        '{"cmd":"stats"}' \\
      | python -m factorvae_tpu_torch.serve --synthetic 80,300

    python -m factorvae_tpu_torch.serve --model DIR --dataset panel.pkl --batch reqs.jsonl
    python -m factorvae_tpu_torch.serve --model DIR --dataset panel.pkl --http 8787 --scheduler

    # N workers behind the sticky router, their AOT store, an autoscaler
    python -m factorvae_tpu_torch.serve --model DIR0 --model DIR1 --synthetic 80,300 \\
        --workers 2 --router_port 8800 [--autoscale 4 --slo_ms 50]
    # a worker that joins that fleet from its artifact service
    python -m factorvae_tpu_torch.serve --join http://127.0.0.1:8800 --http 8790

Serves a synthetic dense panel (`--synthetic DAYS,STOCKS`) or a reference
pickle (`--dataset`). Models come from weights directories or AOT artifact
files (`--model PATH`, repeatable; alias = the file's name;
`eval/export_aot.py`) or, without one, a preset with
random weights drawn from `--seed` (alias = the preset name), each admitted
at `--precision` (float32, bfloat16 or int8; `plan`, the default, takes the
`serve` block of the port's plan row for the model's shape at the panel's
width and `--device`, `plan.py`, else float32). Requests come from stdin
(JSONL; an array line is one tick), a `--batch` file, or HTTP (`--http
PORT`, threaded with `--scheduler`, whose `--tick_ms` and `--max_batch`
default to the plan row's, else 2 ms and 64). `--compile_cache DIR`
(default `$FACTORVAE_COMPILE_CACHE`) builds and loads the kernels'
libraries in DIR. Runs on CUDA unless `--device cpu` is given.

`--workers N` above 1 starts the fleet instead (`serve/pool.py`,
`serve/router.py`): N daemon processes behind a router on `--router_port`,
with the AOT store at `--aot_store`, the shed bound `--max_inflight`, the
hedge delay `--hedge_ms` and the declared SLO `--slo_ms` (default: the plan
row of the first weights directory at the fleet's panel width, else a
measured hedge delay, the router's p90, and no SLO; `--no_hedge` turns
hedging off) and, with `--autoscale MAX`, an autoscaler between N and MAX
workers; the workers get `--compile_cache`. This process builds no panel
and never touches the card: it routes, and exports the store on the CPU.
`--join URL` makes this daemon a remote worker of that fleet
(`serve/remote.py`): it downloads the fleet's artifacts into `--aot_store`,
verified, mirrors the fleet's panel arguments, serves, and registers as
`--advertise_host`. Startup lines go to stderr; stdout is the response
stream.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m factorvae_tpu_torch.serve",
                                description="long-lived scoring daemon over a registry "
                                            "of resident models")
    p.add_argument("--model", action="append", default=[], metavar="PATH",
                   help="weights directory (params.save_weights layout) or AOT "
                        "artifact file (cli --export), repeatable")
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
                   help="the rung every model is admitted at; plan = the plan row's "
                        "serve block for its shape and the panel width, else float32")
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
                        "--scheduler, how long an under-full tick waits (default: "
                        "the plan row's, else 2)")
    p.add_argument("--max_batch", type=int, default=None,
                   help="most requests per tick (default: with --scheduler the plan "
                        "row's, else 64)")
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
                   help="build and load the CUDA kernels' libraries in DIR (default: "
                        "$FACTORVAE_COMPILE_CACHE; 'off' keeps the checkout's _build/)")
    p.add_argument("--device", default="cuda")
    g = p.add_argument_group("worker pool, router and remote workers")
    g.add_argument("--workers", type=int, default=1,
                   help="above 1: N daemon processes behind a sticky router")
    g.add_argument("--router_port", type=int, default=8800,
                   help="the router's port with --workers above 1")
    g.add_argument("--aot_store", default=None, metavar="DIR",
                   help="the AOT artifact store the pool exports into and respawns "
                        "from (default: <work dir>/aot_store); with --join, where the "
                        "downloads land")
    g.add_argument("--join", default=None, metavar="URL",
                   help="join the fleet behind this router as a remote worker")
    g.add_argument("--advertise_host", default="127.0.0.1",
                   help="the address registered with --join (what the router "
                        "forwards to)")
    g.add_argument("--slo_ms", type=float, default=None,
                   help="declared p99 SLO the router publishes and --autoscale defends "
                        "(default: the plan row's, else none)")
    g.add_argument("--hedge_ms", type=float, default=None,
                   help="hedged-forward delay (default: the plan row's, else the "
                        "router's measured p90)")
    g.add_argument("--no_hedge", action="store_true", help="no hedged forwards")
    g.add_argument("--autoscale", type=int, default=0, metavar="MAX",
                   help="scale the fleet between --workers and MAX workers (0: off)")
    g.add_argument("--max_inflight", type=int, default=64,
                   help="router shed bound on client requests in flight (0: none)")
    return p


def _pool_refusal(args) -> "str | None":
    """The error line for pool flags that cannot run, or None."""
    if args.workers < 1:
        return f"--workers must be at least 1; got {args.workers}"
    if args.join:
        if not args.join.startswith(("http://", "https://")):
            return f"--join wants the router's URL (http://host:port); got {args.join!r}"
        if args.workers > 1:
            return ("--join runs one worker; scale by joining more hosts or with "
                    "--autoscale on the router")
        if not args.advertise_host:
            return "--advertise_host must name an address"
    if args.workers > 1:
        if not args.model:
            return "--workers above 1 needs --model (the weights the workers serve)"
        if not 0 < args.router_port < 65536:
            return f"--router_port must be a TCP port; got {args.router_port}"
        if args.aot_store and os.path.isfile(args.aot_store):
            return f"--aot_store {args.aot_store} is a file, not a directory"
    if args.slo_ms is not None and args.slo_ms < 0:
        return f"--slo_ms must be >= 0; got {args.slo_ms:g}"
    if args.hedge_ms is not None:
        if args.hedge_ms < 0:
            return f"--hedge_ms must be >= 0; got {args.hedge_ms:g}"
        if args.no_hedge:
            return "--hedge_ms and --no_hedge contradict each other"
    if args.autoscale and args.autoscale <= args.workers:
        return (f"--autoscale MAX must exceed --workers ({args.workers}); got "
                f"{args.autoscale}")
    if args.autoscale < 0:
        return f"--autoscale must be >= 0; got {args.autoscale}"
    if args.max_inflight < 0:
        return f"--max_inflight must be >= 0; got {args.max_inflight}"
    return None


def serving_plan(config, n_max: int, device: str):
    """The plan for serving `config` (None: an artifact, which carries no
    Config) at panel width `n_max` on `device`: the default source of the
    serving knobs the flags leave unset."""
    if config is None:
        return None
    from factorvae_tpu_torch import plan as planlib

    return planlib.plan_for_config(config, n_max, platform=device)


def scheduler_knobs(args, pl) -> tuple:
    """(tick_ms, max_tick_batch) of a `--scheduler` front: the flags, else
    the plan row's measured values, else 2 ms and 64."""
    tick_ms = args.tick_ms if args.tick_ms is not None else (
        pl.serve_tick_ms if pl is not None and pl.serve_tick_ms >= 0 else 2.0)
    max_tick = args.max_batch if args.max_batch is not None else (
        pl.serve_max_tick_batch if pl is not None and pl.serve_max_tick_batch > 0 else 64)
    return tick_ms, max_tick


def fleet_plan_defaults(args, n_max: int) -> tuple:
    """(slo_ms, hedge_ms) of a fleet: the flags, else the plan row of the
    first weights directory at the width worker 0 reported, else no SLO (0)
    and a measured hedge delay (-1)."""
    from factorvae_tpu_torch.serve.registry import RegistryError, checkpoint_config

    slo_ms, hedge_ms = args.slo_ms, args.hedge_ms
    if slo_ms is None or hedge_ms is None:
        pl = None
        if args.model and os.path.isdir(args.model[0]) and n_max:
            try:
                pl = serving_plan(checkpoint_config(args.model[0]), n_max, args.device)
            except RegistryError:         # no serve_config.json: no shape to look up
                pl = None
        if slo_ms is None:
            slo_ms = pl.serve_slo_ms if pl is not None else 0.0
        if hedge_ms is None:
            hedge_ms = pl.serve_hedge_ms if pl is not None else -1.0
    return slo_ms, hedge_ms


def build_fleet(args, work_dir: str):
    """(pool, router, autoscaler or None) configured from the pool flags,
    nothing started. The workers get this command's panel, precision,
    compile-cache and resilience flags; an unset `--slo_ms` or `--hedge_ms`
    holds no SLO and a measured hedge delay until `run_pool` reads the plan
    row at the width worker 0 reports (`fleet_plan_defaults`)."""
    from factorvae_tpu_torch.serve.autoscale import AutoScaler
    from factorvae_tpu_torch.serve.pool import WorkerPool
    from factorvae_tpu_torch.serve.router import Router

    dataset_args = (["--dataset", args.dataset] if args.dataset
                    else ["--synthetic", args.synthetic])
    if args.max_stocks is not None:
        dataset_args += ["--max_stocks", str(args.max_stocks)]
    extra = ["--seed", str(args.seed), "--breaker_k", str(args.breaker_k),
             "--breaker_cooldown_s", str(args.breaker_cooldown_s),
             "--drift_threshold", str(args.drift_threshold)]
    if args.precision != "plan":
        extra += ["--precision", args.precision]
    if args.budget_mb:
        extra += ["--budget_mb", str(args.budget_mb)]
    if args.stochastic:
        extra.append("--stochastic")
    if args.deadline_ms:
        extra += ["--deadline_ms", str(args.deadline_ms)]
    if args.trace_off:
        extra.append("--trace_off")
    pool = WorkerPool(args.model, dataset_args, args.workers,
                      args.aot_store or os.path.join(work_dir, "aot_store"),
                      work_dir=work_dir, device=args.device, extra_args=extra,
                      tick_ms=args.tick_ms, max_tick_batch=args.max_batch,
                      metrics_base=args.metrics_jsonl, compile_cache=args.compile_cache)
    pool.router_url = f"http://127.0.0.1:{args.router_port}"
    slo_ms = args.slo_ms or 0.0
    router = Router(pool, max_inflight=args.max_inflight, slo_ms=slo_ms,
                    hedge_ms=-1.0 if args.hedge_ms is None else args.hedge_ms,
                    hedge=not args.no_hedge, trace=not args.trace_off)
    scaler = None
    if args.autoscale:
        scaler = AutoScaler(pool, router, min_workers=args.workers,
                            max_workers=args.autoscale, slo_ms=slo_ms)
        router.autoscaler = scaler
    return pool, router, scaler


def run_pool(args) -> int:
    """The fleet (`--workers` above 1): start the pool, then route on
    `--router_port` until SIGTERM drains it."""
    import tempfile

    from factorvae_tpu_torch.serve.pool import PoolError
    from factorvae_tpu_torch.utils.logging import MetricsLogger, Timeline, install_timeline

    work_dir = tempfile.mkdtemp(prefix="serve_pool_")
    # the router never makes a CUDA context, its stream's header included
    logger = MetricsLogger(jsonl_path=args.metrics_jsonl, echo=False, run_name="serve_router",
                           device_name=False)
    prev_tl = install_timeline(Timeline(logger)) if args.metrics_jsonl else None
    pool, router, scaler = build_fleet(args, work_dir)
    try:
        print(f"[pool] starting {args.workers} worker(s) on {args.device} (aot store "
              f"{pool.store.root}, logs {work_dir})", file=sys.stderr)
        pool.start()
        router.slo_ms, router.hedge_ms = fleet_plan_defaults(args, pool.n_max)
        if scaler is not None:
            scaler.slo_ms = router.slo_ms
        for w in pool.stats()["workers"]:
            print(f"[pool] {w['worker_id']} pid={w['pid']} {w['url']} ({w['state']})",
                  file=sys.stderr)
        if scaler is not None:
            scaler.start()
            print(f"[pool] autoscaler: {args.workers}..{args.autoscale} workers, SLO "
                  f"{router.slo_ms:g}ms", file=sys.stderr)
        print(f"[pool] router ready: http://127.0.0.1:{args.router_port}/score "
              f"({args.workers} workers, hedge={'off' if args.no_hedge else 'on'})",
              file=sys.stderr)
        try:
            router.serve(args.router_port)
        finally:
            if scaler is not None:
                scaler.stop()
        return 0
    except PoolError as e:
        print(f"error: {e}", file=sys.stderr)
        pool.stop()
        return 2
    finally:
        if args.metrics_jsonl:
            install_timeline(prev_tl)
        logger.finish()


def _artifact_header(path: str) -> "dict | None":
    """The AOT header of an artifact file; None for a weights directory."""
    from factorvae_tpu_torch.eval.export_aot import ArtifactError, read_artifact_header

    if os.path.isdir(path):
        return None
    with open(path, "rb") as fh:
        header = read_artifact_header(fh.read())
    if header is None:
        raise ArtifactError(f"{path} is neither a weights directory nor an AOT artifact")
    return header


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    precision = None if args.precision == "plan" else args.precision
    refused = _pool_refusal(args)
    if refused:
        print(f"error: {refused}", file=sys.stderr)
        return 2
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to serve on the CPU",
              file=sys.stderr)
        return 2
    if args.join:
        from factorvae_tpu_torch.serve import remote
        from factorvae_tpu_torch.serve.pool import free_port

        if args.http is None:
            args.http = free_port()
        args.scheduler = True
        try:
            capability = remote.prepare_join(args, parser)
        except remote.JoinError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"[join] synced {len(args.model)} artifact(s) from {args.join} into "
              f"{args.aot_store}", file=sys.stderr)
        remote.register_when_healthy(args.join, args.http, capability,
                                     host=args.advertise_host)
    if bool(args.synthetic) == bool(args.dataset):
        print("error: pass exactly one of --synthetic DAYS,STOCKS and --dataset",
              file=sys.stderr)
        return 2
    if args.workers > 1:
        return run_pool(args)

    import dataclasses

    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.eval.export_aot import ArtifactError
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

    config = None                   # the first model's, when it has one
    try:
        headers = {path: _artifact_header(path) for path in args.model}
        if args.model and headers[args.model[0]] is not None:
            first = headers[args.model[0]]     # the panel follows the artifact
            num_features, seq_len = int(first["num_features"]), int(first["seq_len"])
        else:
            if args.model:
                config = checkpoint_config(args.model[0])
            else:
                config = get_preset(args.preset)
                config = dataclasses.replace(
                    config, train=dataclasses.replace(config.train, seed=args.seed))
            refused = hidden_refusal(config.model.hidden_size, args.device)
            if refused:        # before the panel is read
                print(f"error: {refused}", file=sys.stderr)
                return 2
            num_features, seq_len = config.model.num_features, config.model.seq_len
    except (ArtifactError, KeyError, OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.synthetic:
        from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense

        try:
            n_days, n_stocks = (int(v) for v in args.synthetic.split(","))
        except ValueError:
            print("error: --synthetic wants DAYS,STOCKS (e.g. 80,300)", file=sys.stderr)
            return 2
        panel = synthetic_panel_dense(n_days, n_stocks, num_features, seed=args.seed)
    else:
        from factorvae_tpu_torch.data.panel import build_panel, load_frame

        panel = build_panel(load_frame(args.dataset))
    dataset = PanelDataset(panel, seq_len=seq_len, max_stocks=args.max_stocks,
                           device=args.device)

    from factorvae_tpu_torch import plan as planlib

    cache_dir = planlib.setup_compilation_cache(args.compile_cache)
    logger = MetricsLogger(jsonl_path=args.metrics_jsonl, echo=False, run_name="serve")
    prev_tl = install_timeline(Timeline(logger)) if args.metrics_jsonl else None
    try:
        registry = ModelRegistry(device=args.device,
                                 budget_bytes=int(args.budget_mb * 1e6))
        try:
            if args.model:
                expected = getattr(args, "_expected_sha256", {})
                for path in args.model:
                    if headers[path] is not None:
                        key = registry.register_artifact(
                            path, expected_sha256=expected.get(path))
                    else:
                        key = registry.register_checkpoint(path, precision=precision,
                                                           n_stocks=dataset.n_max)
                    entry = registry.get(key)
                    print(f"[serve] admitted {path} as {key} (alias {entry.alias}, "
                          f"{entry.precision}, {entry.nbytes} bytes)", file=sys.stderr)
            else:
                model = load_model(config, device=args.device)
                registry.register_params(model, config, precision=precision,
                                         n_stocks=dataset.n_max, alias=args.preset)
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
                   compile_cache=cache_dir, n_days=len(dataset.dates), n_max=dataset.n_max)
        rungs = sorted({e["precision"] for e in registry.stats()["entries"]})
        print(f"[serve] ready: {len(registry.keys())} model(s) "
              f"{sorted(registry.stats()['aliases'])} at {'/'.join(rungs)}, panel "
              f"{len(dataset.dates)}d x {dataset.n_max} on {dataset.device} "
              f"(cache: {cache_dir or 'off'})", file=sys.stderr)
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
                tick_ms, max_tick = scheduler_knobs(
                    args, serving_plan(config, dataset.n_max, args.device))
                scheduler = TickScheduler(daemon, tick_ms=tick_ms, max_tick_batch=max_tick)
                print(f"[serve] continuous batching: tick_ms={tick_ms:g} "
                      f"max_tick_batch={max_tick}", file=sys.stderr)
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
