"""`python -m factorvae_tpu_torch.serve`: score JSONL requests from stdin.

    printf '%s\\n' '{"id":1,"model":"flagship","day":5,"top":3}' \\
        '{"cmd":"stats"}' \\
      | python -m factorvae_tpu_torch.serve --synthetic 80,300

Serves a synthetic dense panel (`--synthetic DAYS,STOCKS`) or a reference
pickle (`--dataset`). Models come from weights directories (`--model DIR`,
repeatable; alias = the directory name) or, without one, a preset with
random weights drawn from `--seed` (alias = the preset name), each admitted
at `--precision` (float32, bfloat16 or int8; `plan`, the default, resolves
to float32: the port has no plan table yet, and the JAX package's plan
rows were measured on a TPU). Runs on CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m factorvae_tpu_torch.serve")
    p.add_argument("--model", action="append", default=[], metavar="DIR",
                   help="weights directory (params.save_weights layout)")
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
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    precision = "float32" if args.precision == "plan" else args.precision

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
    from factorvae_tpu_torch.params import read_config
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.serve.daemon import ScoringDaemon, serve_stdin
    from factorvae_tpu_torch.serve.registry import ModelRegistry, RegistryError

    registry = ModelRegistry(device=args.device)
    try:
        if args.model:
            config = read_config(args.model[0])
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
            print("error: --synthetic wants DAYS,STOCKS (e.g. 80,300)",
                  file=sys.stderr)
            return 2
        panel = synthetic_panel_dense(n_days, n_stocks, config.model.num_features,
                                      seed=args.seed)
    else:
        from factorvae_tpu_torch.data.panel import build_panel, load_frame

        panel = build_panel(load_frame(args.dataset))
    dataset = PanelDataset(panel, seq_len=config.model.seq_len,
                           max_stocks=args.max_stocks, device=args.device)

    try:
        if args.model:
            for path in args.model:
                registry.admit(path, precision=precision)
        else:
            model = load_model(config, device=args.device)
            registry.admit(model, config, alias=args.preset, precision=precision)
    except RegistryError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"[serve] ready: {len(registry.keys())} model(s) "
          f"{sorted(registry.stats()['aliases'])} at {precision}, panel "
          f"{len(dataset.dates)}d x {dataset.n_max} on {dataset.device}",
          file=sys.stderr)
    daemon = ScoringDaemon(registry, dataset,
                           stochastic=None if args.stochastic else False,
                           seed=args.seed)
    n = serve_stdin(daemon, sys.stdin, sys.stdout)
    print(f"[serve] answered {n} request(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
