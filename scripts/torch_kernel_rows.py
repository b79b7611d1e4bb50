#!/usr/bin/env python3
"""Time the kernel-table shapes that `chip_smoke.py` does not time: K1 at
T = 60 and K5 over 8 training days, at each hidden size, on one GPU.

    python3 scripts/torch_kernel_rows.py [--hidden 64,128,256] [--seed 0] [--out FILE]

K1 (the serving and the residual variant) on one alpha360-k60-length day,
xi (304, 60, 3H), against its plain version (checked within K1_TOL) and
cuDNN's nn.GRU forward (an identity input weight, checked within
LIBRARY_TOL), with the bound; K5 over 8 clean flagship days (N = 304 with
300 stocks, K = 96, a keep-mask) with its bound over this run's valid rows.
The inputs, checks, clocks and bounds are `chip_smoke.py`'s (`_k1_case`,
`_k1_timing`, `_k5_timing`): `ms` is CUDA events around 20 calls from
Python, `graph_ms` 20 CUDA-graph replays. Prints the card's `nvidia-smi`
name and power limit, then one JSON line; exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hidden", default="64,128,256", help="comma-separated hidden sizes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also append the JSON line here")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_rows: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else None
    print(card, flush=True)
    cs.phase_build()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = {}
    for h in (int(x) for x in args.hidden.split(",")):
        k1_args = cs._gru_inputs(torch, g, 304, 60, h)
        check = cs._k1_case(torch, k1_args, f"K1 T=60 H={h}")
        clean = cs._k4_inputs(torch, g, 8, 304, 96, h, 300)
        k5_args = (*clean, torch.randn(8, 96, h, device="cuda", generator=g) * 0.1,
                   (torch.rand(8, 96, 304, device="cuda", generator=g) > 0.1).float() / 0.9)
        rows[h] = {"K1_T60": {**cs._k1_timing(torch, k1_args, f"T=60 H={h}"),
                              "max_abs_err": check["max_abs_err"],
                              "residual_errors": check["residual_errors"],
                              "tolerance": cs.K1_TOL},
                   "K5_8_days": cs._k5_timing(torch, *k5_args)}
    line = json.dumps({"script": "scripts/torch_kernel_rows.py", "card": card,
                       "kind": torch.cuda.get_device_name(0), "rows": rows})
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
