#!/usr/bin/env python3
"""Time the port's solo training path on one GPU: warm epochs and the host
cost of one differentiable kernel call.

    python3 scripts/torch_train_times.py [--tree DIR] [--epochs 5] [--calls 200] [--out FILE]

Imports `factorvae_tpu_torch` from DIR (default: this checkout), so two trees
(a parent commit unpacked with `git archive`, and this one) can be timed in
turns on one card in one call: parent, change, change, parent. The run is
`chip_smoke.py`'s train phase: the flagship preset (f32, days_per_step 1) on
an 80-day synthetic panel of 300 stocks made from --seed, 50 training and 20
validation days. One `Trainer.fit` of one epoch pays the first-use set-up;
then --epochs more fits each give their epoch's `seconds` (validation
included). `call_ms` is the wall per call, from Python, of the forward and
backward of `gru` (one training day, 304 x 20 x 64) and of `attention` (one
day, K = 96, H = 64), --calls of each with one synchronize at the end: the
host's cost of the autograd Function, its wrappers and its launches. Prints
one JSON line with the card's `nvidia-smi` name and power limit; exits 1
without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time


def _call_ms(torch, fn, calls: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--calls", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also append the JSON line here")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_train_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    from factorvae_tpu_torch import _build
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.ops.kernels.attention import attention
    from factorvae_tpu_torch.ops.kernels.gru import gru
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()

    base = get_preset("flagship")
    m = base.model
    panel = synthetic_panel_dense(80, 300, m.num_features, seed=args.seed)
    dates = [str(d) for d in panel.dates]
    work = tempfile.TemporaryDirectory(prefix="torch_train_times_")
    cfg = dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, start_time=dates[0], fit_end_time=dates[49],
                                 val_start_time=dates[50], val_end_time=dates[69]),
        train=dataclasses.replace(base.train, seed=args.seed, num_epochs=1, days_per_step=1,
                                  checkpoint_every=0, save_dir=work.name))
    dataset = PanelDataset(panel, seq_len=m.seq_len, device="cuda")
    trainer = Trainer(cfg, dataset, device="cuda")
    first = trainer.fit()[1]["history"][0]["seconds"]
    epochs = [trainer.fit()[1]["history"][0]["seconds"] for _ in range(args.epochs)]
    work.cleanup()

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    n, t_len, h, k = 304, m.seq_len, m.hidden_size, m.num_factors

    def leaf(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale).requires_grad_()

    xi, wh, bh = leaf(n, t_len, 3 * h), leaf(h, 3 * h, scale=h ** -0.5), leaf(3 * h)
    latent = leaf(1, n, h)
    mask = torch.ones(1, n, dtype=torch.bool, device="cuda")
    mask[:, 300:] = False
    weights = (leaf(k, h), leaf(k, h, h, scale=h ** -0.5), leaf(k, h),
               leaf(k, h, h, scale=h ** -0.5), leaf(k, h))
    call_ms = {"gru": _call_ms(torch, lambda: gru(xi, wh, bh).sum().backward(), args.calls),
               "attention": _call_ms(
                   torch, lambda: attention(latent, mask, *weights).sum().backward(),
                   args.calls)}
    out = {"tree": os.path.abspath(args.tree), "nvidia_smi": smi, "epoch_s_first": first,
           "epoch_s": epochs, "epoch_s_median": statistics.median(epochs),
           "call_ms": call_ms}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
