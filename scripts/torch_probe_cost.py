#!/usr/bin/env python3
"""Time the training-health probes (`train.obs_probes`) of the port's
training step on one GPU, and split their host cost by op.

    python3 scripts/torch_probe_cost.py [--blocks 20] [--steps 10] [--seed 0] [--out FILE]

The step is `chip_smoke.py`'s train phase's: the flagship preset (f32,
days_per_step 1) on an 80-day synthetic panel of 300 stocks made from
--seed. One state takes `train_step`s over the epoch's day order in blocks
of --steps, probes off and on in turn (ABAB), with a synchronize at each
block's end: `step_ms` is each block's wall per step, the medians and
minima per mode and their differences (a shared host spreads the blocks
widely; the minimum is the least disturbed). `probe_only_ms` is the wall of
the probes' own calls on one step's gradients and parameters (the loss
probes, `grad_probes`, the parameters' flat copy, `update_probes` and their
aux sums),
--calls times with one synchronize at the end. Then --steps steps of each
mode under `torch.profiler` (CPU activity): the host ops whose self CPU
time or call count the probes raise, per step. Prints one JSON line with
the card's `nvidia-smi` name and power limit; exits 1 without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--blocks", type=int, default=20)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--calls", type=int, default=200)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_probe_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import dataclasses
    import tempfile

    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.obs import probes
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.train.loop import _accumulate, train_step
    from factorvae_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_preset("flagship")
    panel = synthetic_panel_dense(80, 300, base.model.num_features, seed=args.seed)
    dates = [str(d) for d in panel.dates]
    save = tempfile.TemporaryDirectory(prefix="probe_cost_")
    cfg = dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, start_time=dates[0], fit_end_time=dates[49],
                                 val_start_time=dates[50], val_end_time=dates[69]),
        train=dataclasses.replace(base.train, seed=args.seed, days_per_step=1,
                                  checkpoint_every=0, save_dir=save.name))
    ds = PanelDataset(panel, seq_len=base.model.seq_len, device="cuda")
    tr = Trainer(cfg, ds, device="cuda")
    state = tr.init_state()
    order = tr._order(tr.train_days, True, 0)
    at = {"i": 0}

    def steps(on: bool, n: int) -> None:
        for _ in range(n):
            train_step(state, ds, order[at["i"] % order.shape[0]], guard=True, probes=on)
            at["i"] += 1

    steps(False, 20)
    steps(True, 20)                    # both paths warm
    walls = {"off": [], "on": []}
    for _ in range(args.blocks):
        for mode in ("off", "on"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps(mode == "on", args.steps)
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - t0) * 1e3 / args.steps)
    med = {k: statistics.median(v) for k, v in walls.items()}
    low = {k: min(v) for k, v in walls.items()}

    # the probes' own calls, on the last step's gradients and parameters
    params = list(state.model.parameters())
    grads = [q.grad for q in params if q.grad is not None]
    day_w = torch.ones(1, device="cuda")

    class Out:
        loss = torch.ones(1, device="cuda")
        factor_mu = torch.randn(1, base.model.num_factors, device="cuda")
        factor_sigma = torch.rand(1, base.model.num_factors, device="cuda")

    def probe_calls(sums):
        aux = {**probes.loss_probes(Out, day_w), **probes.grad_probes(grads)}
        aux.update(probes.update_probes(probes.flatten(params), params))
        return _accumulate(sums, aux)

    sums = probe_calls(None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.calls):
        sums = probe_calls(sums)
    torch.cuda.synchronize()
    probe_only_ms = (time.perf_counter() - t0) * 1e3 / args.calls

    from torch.profiler import ProfilerActivity, profile

    ops = {}
    for mode in ("off", "on"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            steps(mode == "on", args.steps)
            torch.cuda.synchronize()
        ops[mode] = {e.key: (e.self_cpu_time_total / args.steps, e.count / args.steps)
                     for e in prof.key_averages()}
    delta = []
    for key in set(ops["on"]) | set(ops["off"]):
        on_us, on_n = ops["on"].get(key, (0.0, 0.0))
        off_us, off_n = ops["off"].get(key, (0.0, 0.0))
        delta.append({"op": key, "self_cpu_us_per_step": on_us - off_us,
                      "calls_per_step": on_n - off_n})
    delta.sort(key=lambda d: -d["self_cpu_us_per_step"])
    out = {"card": _card(), "torch": torch.__version__,
           "config": "flagship C158/T20/H64/K96/M128, f32, days_per_step=1, 300 stocks",
           "blocks": args.blocks, "steps_per_block": args.steps,
           "step_ms": walls, "median_step_ms": med, "min_step_ms": low,
           "probe_ms_per_step": med["on"] - med["off"],
           "probe_frac": med["on"] / med["off"] - 1.0,
           "probe_ms_per_step_min": low["on"] - low["off"],
           "probe_only_ms": probe_only_ms,
           "calls_per_step": {m: sum(n for _, n in ops[m].values()) for m in ops},
           "top_ops_added": delta[:15]}
    save.cleanup()
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
