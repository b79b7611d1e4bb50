#!/usr/bin/env python3
"""Time the port's attention kernels (K4 forward, K5 backward) on one GPU.

    python3 scripts/torch_attention_times.py [--tree DIR] [--hidden 64,128,256] [--groups]
        [--profile] [--out FILE]

Imports `factorvae_tpu_torch` from DIR (default: this checkout), so two trees
(a parent commit unpacked with `git archive`, and this one) can be timed in
turns on one card in one call: parent, change, change, parent. Inputs are the
flagship widths (N = 304 with 300 stocks, ~5 % of them missing, K = 96) at
each hidden size of --hidden (default 64), made from --seed: K4 at a 32-day
serving chunk and at one training day, K5 at one and at 8 training days with
a keep-mask. A shape's key is its label at H = 64 (`K4_serve`) and the label
with `_H<h>` above (`K4_serve_H256`). Each time is `graph_ms`,
the CUDA-event time of 20 replays of a CUDA graph of one call, and `ms`, 20
calls from Python. With --groups, and a tree whose wrappers take a heads-per-
CTA override (`_fwd_launch` / `_bwd_launch`), every size of its GROUPS is
timed too. With --profile, torch.profiler gives each kernel's device time
per call at the rule's size (`kernels_us`). Prints one JSON line with the
card's `nvidia-smi` name and power limit; exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = {"K4_serve": ("fwd", 32), "K4_day": ("fwd", 1),
          "K5_day": ("bwd", 1), "K5_8_days": ("bwd", 8)}


def _ms(torch, fn, graph: bool, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        fn = g.replay
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_us(torch, fn, calls: int = 10) -> dict:
    """Device microseconds per call of each CUDA kernel `fn` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us:
            out[ev.key[:80]] = us / calls
    return out


def _inputs(torch, gen, b, n=304, k=96, h=64, n_real=300):
    mask = torch.zeros(b, n, dtype=torch.bool, device="cuda")
    mask[:, :n_real] = torch.rand(b, n_real, device="cuda", generator=gen) > 0.05
    scale = 1.0 / h ** 0.5

    def uni(*shape):
        return (torch.rand(*shape, device="cuda", generator=gen) * 2 - 1) * scale

    latent = torch.rand(b, n, h, device="cuda", generator=gen) * 2 - 1
    weights = (torch.randn(k, h, device="cuda", generator=gen), uni(k, h, h), uni(k, h),
               uni(k, h, h), uni(k, h))
    keep = (torch.rand(b, k, n, device="cuda", generator=gen) > 0.1).float() / 0.9
    dctx = torch.randn(b, k, h, device="cuda", generator=gen) * 0.1
    return latent, mask, weights, keep, dctx


def _time_shape(torch, mod, gen, kind: str, b: int, h: int, groups, profile: bool) -> dict:
    latent, mask, weights, keep, dctx = _inputs(torch, gen, b, h=h)
    if kind == "fwd":
        def call(g=None):
            if g is None:
                return mod.attention_fwd(latent, mask, *weights)
            return mod._fwd_launch(latent, mask, *weights, None, g)
    else:
        def call(g=None):
            if g is None:
                return mod.attention_bwd(latent, mask, *weights, dctx, keep=keep)
            return mod._bwd_launch(latent, mask, *weights, dctx, keep, g)
    row = {"graph_ms": _ms(torch, call, True), "ms": _ms(torch, call, False)}
    if hasattr(mod, "_group"):
        row["heads_per_cta"] = mod._group(latent, weights[0].shape[0])
    if profile:
        row["kernels_us"] = _kernel_us(torch, call)
    if groups:
        row["by_group_graph_ms"] = {str(g): _ms(torch, lambda g=g: call(g), True)
                                    for g in groups}
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--hidden", default="64", help="comma-separated hidden sizes")
    p.add_argument("--groups", action="store_true")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also append the JSON line here")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_attention_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    from factorvae_tpu_torch import _build
    from factorvae_tpu_torch.ops.kernels import attention as mod

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(("attention_fwd", "attention_bwd"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    groups = getattr(mod, "GROUPS", ()) if args.groups else ()
    out = {"tree": os.path.abspath(args.tree), "nvidia_smi": smi, "times": {}}
    for h in (int(x) for x in args.hidden.split(",")):
        for label, (kind, b) in SHAPES.items():
            key = label if h == 64 else f"{label}_H{h}"
            out["times"][key] = _time_shape(torch, mod, gen, kind, b, h, groups, args.profile)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
