#!/usr/bin/env python3
"""Digest and time the port's kernels on one GPU.

    python3 scripts/torch_kernel_digest.py [--tree DIR] [--seed 0] [--out FILE]

Imports `factorvae_tpu_torch` from DIR (default: this checkout), so two trees
(a parent commit unpacked with `git archive`, and this one) can be run in
turns on one card in one call: parent, change, change, parent. Each call of
each kernel (K1's serving and residual variants, the walk, dWh, K4, K5) runs
on inputs made from --seed at the flagship widths (N = 304 with 300 stocks,
T = 20, H = 64, K = 96; K1 also at a 32-day serving chunk; the walk also at
T = 60, H = 60; K4 and K5 also at H = 37 and on a day with a NaN row, the
exact path), K1's two variants at H = 128 and 256 at one day and at a
32-day chunk (its wide instance), the walk and dWh at H = 128 and 256 at
one day and at T = 60 (dWh on the plain walk's outputs), and K4 and K5 at H
= 128 and 256 (K4 at one day and at a 32-day chunk, K5 at one and at 8
days, both on 2 days with a NaN row: the wide exact path); the line holds
the sha256 of each call's outputs' bytes beside its `graph_ms` (the
CUDA-event time of 20 replays of a CUDA graph of one call). Equal digests
from two trees mean the two compute bitwise the same values.
The library's full ptxas report (`-Xptxas -v`) for each kernel source goes
to the --out file's directory. Prints one JSON line with the card's
`nvidia-smi` name and power limit; exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def graph_ms(torch, fn, reps: int = 20) -> float:
    """CUDA-event milliseconds of one call of `fn`: the mean of `reps`
    replays of a CUDA graph of it."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _digest(out) -> str:
    h = hashlib.sha256()
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def parse_args(doc: str, argv=None) -> argparse.Namespace:
    """--tree (the checkout whose `factorvae_tpu_torch` is imported), --seed
    and --out, as this script and scripts/torch_gru_fwd_probe.py take them."""
    p = argparse.ArgumentParser(description=doc.split("\n")[0])
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also append the JSON line here")
    return p.parse_args(argv)


def use_tree(args, script: str):
    """torch, with `args.tree` first on sys.path; None without a CUDA device
    (after saying so on stderr)."""
    import torch

    if not torch.cuda.is_available():
        print(f"{script}: no CUDA device", file=sys.stderr)
        return None
    sys.path.insert(0, os.path.abspath(args.tree))
    return torch


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def emit(out: dict, path) -> None:
    """Print `out` as one JSON line, and append it to `path` if given."""
    line = json.dumps(out)
    print(line, flush=True)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a") as fh:
            fh.write(line + "\n")


def main(argv=None) -> int:
    args = parse_args(__doc__, argv)
    torch = use_tree(args, "torch_kernel_digest")
    if torch is None:
        return 1
    from factorvae_tpu_torch import _build
    from factorvae_tpu_torch.ops.kernels import attention as att
    from factorvae_tpu_torch.ops.kernels import gru

    torch.backends.cuda.matmul.allow_tf32 = False
    logs = _build.build()
    smi = nvidia_smi()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def rand(*shape, scale=1.0):
        return (torch.rand(*shape, device="cuda", generator=gen) * 2 - 1) * scale

    calls = {}
    for label, (n, t, h) in {"day": (304, 20, 64), "serve": (9728, 20, 64),
                             "T60_H60": (304, 60, 60)}.items():
        xi, wh, bh = rand(n, t, 3 * h), rand(h, 3 * h, scale=h ** -0.5), rand(3 * h, scale=0.1)
        dh = rand(n, h, scale=0.1)
        _, hseq, gseq = gru.gru_fwd_residuals(xi, wh, bh)
        dxi, dgn = gru._walk_launch(xi, wh, hseq, gseq, dh, gru._shape(xi))
        calls[f"gru_fwd_{label}"] = lambda a=(xi, wh, bh): gru.gru_fwd(*a)
        if label != "serve":
            calls[f"gru_fwd_residuals_{label}"] = lambda a=(xi, wh, bh): gru.gru_fwd_residuals(*a)
            calls[f"gru_bwd_{label}"] = lambda a=(xi, wh, bh, dh), r=(hseq, gseq): gru.gru_bwd(
                *a, residuals=r)
            calls[f"gru_dwh_{label}"] = lambda a=(hseq, dxi, dgn): gru.gru_dwh(*a)
    for label, (b, n, k, h, nan) in {"day": (1, 304, 96, 64, False),
                                     "serve": (32, 304, 96, 64, False),
                                     "nan_day": (2, 304, 96, 64, True),
                                     "H37": (3, 70, 6, 37, True)}.items():
        latent = rand(b, n, h)
        mask = torch.zeros(b, n, dtype=torch.bool, device="cuda")
        mask[:, :n - 4] = torch.rand(b, n - 4, device="cuda", generator=gen) > 0.05
        if nan:
            latent[1, 5, 2] = float("nan")
            mask[1, 5] = True
        w = (torch.randn(k, h, device="cuda", generator=gen), rand(k, h, h, scale=h ** -0.5),
             rand(k, h, scale=h ** -0.5), rand(k, h, h, scale=h ** -0.5),
             rand(k, h, scale=h ** -0.5))
        keep = (torch.rand(b, k, n, device="cuda", generator=gen) > 0.1).float() / 0.9
        dctx = rand(b, k, h, scale=0.1)
        calls[f"attention_fwd_{label}"] = lambda a=(latent, mask, *w): att.attention_fwd(*a)
        if label != "serve":
            calls[f"attention_bwd_{label}"] = lambda a=(latent, mask, *w, dctx), kp=keep: (
                att.attention_bwd(*a, keep=kp))
    # K1 above H = 64, drawn last so that the calls above keep their inputs
    for h in (128, 256):
        for label, n in (("day", 304), ("serve", 9728)):
            a = (rand(n, 20, 3 * h), rand(h, 3 * h, scale=h ** -0.5), rand(3 * h, scale=0.1))
            calls[f"gru_fwd_{label}_H{h}"] = lambda a=a: gru.gru_fwd(*a)
            calls[f"gru_fwd_residuals_{label}_H{h}"] = lambda a=a: gru.gru_fwd_residuals(*a)
    # the walk and dWh above H = 64, drawn after the rest: the walk from
    # K1's residuals at the tree's walk shape, dWh on the plain walk's
    # outputs (so that its digest moves only with the dWh kernel)
    walk_shape = getattr(gru, "_walk_shape", None) or gru._shape
    for h in (128, 256):
        for label, t in (("day", 20), ("T60", 60)):
            xi, wh = rand(304, t, 3 * h), rand(h, 3 * h, scale=h ** -0.5)
            bh = rand(3 * h, scale=0.1)
            dh = rand(304, h, scale=0.1)
            _, hseq, gseq = gru.gru_fwd_residuals(xi, wh, bh)
            plain = gru.gru_walk_plain(xi, wh, hseq, gseq, dh)
            calls[f"gru_walk_{label}_H{h}"] = lambda a=(xi, wh, hseq, gseq, dh): (
                gru._walk_launch(*a, walk_shape(a[0])))
            calls[f"gru_dwh_{label}_H{h}"] = lambda a=(hseq, *plain): gru.gru_dwh(*a)
    # K4 and K5 above H = 64, drawn after the rest
    for h in (128, 256):
        for label, (b, nan) in (("day", (1, False)), ("serve", (32, False)),
                                ("8_days", (8, False)), ("nan_day", (2, True))):
            latent = rand(b, 304, h)
            mask = torch.zeros(b, 304, dtype=torch.bool, device="cuda")
            mask[:, :300] = torch.rand(b, 300, device="cuda", generator=gen) > 0.05
            if nan:
                latent[1, 5, 2] = float("nan")
                mask[1, 5] = True
            w = (torch.randn(96, h, device="cuda", generator=gen),
                 rand(96, h, h, scale=h ** -0.5), rand(96, h, scale=h ** -0.5),
                 rand(96, h, h, scale=h ** -0.5), rand(96, h, scale=h ** -0.5))
            keep = (torch.rand(b, 96, 304, device="cuda", generator=gen) > 0.1).float() / 0.9
            dctx = rand(b, 96, h, scale=0.1)
            if label != "8_days":
                calls[f"attention_fwd_{label}_H{h}"] = lambda a=(latent, mask, *w): (
                    att.attention_fwd(*a))
            if label != "serve":
                calls[f"attention_bwd_{label}_H{h}"] = lambda a=(latent, mask, *w, dctx), \
                    kp=keep: att.attention_bwd(*a, keep=kp)
    out = {"tree": os.path.abspath(args.tree), "nvidia_smi": smi, "calls": {}}
    for name, fn in calls.items():
        out["calls"][name] = {"digest": _digest(fn()), "graph_ms": graph_ms(torch, fn)}
    emit(out, args.out)
    if args.out:
        tag = hashlib.sha256(out["tree"].encode()).hexdigest()[:6]
        for lib, log in logs.items():
            if not log:
                continue                # built by an earlier run of this tree
            with open(os.path.join(os.path.dirname(os.path.abspath(args.out)),
                                   f"ptxas_{tag}_{lib}.log"), "w") as fh:
                fh.write(log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
