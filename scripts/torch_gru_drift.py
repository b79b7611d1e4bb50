#!/usr/bin/env python3
"""How far the GRU's plain version in float32 drifts from float64, and on a
CUDA device the kernels beside it.

    python3 scripts/torch_gru_drift.py [--seed 11] [--device cuda]

The kernels are held against their plain versions at rtol 1e-5 / atol 1e-5
(`tests/test_torch_cuda.py`). That only means something where float32
itself computes the function to that accuracy. For each (N, T, H) below and
each scale of Wh (normal with std 0.3, the cuda tests' scale up to H = 64,
and 1/sqrt(H), the model's), this runs `gru_fwd_plain` and `gru_bwd_plain`
on the same inputs in float32 and float64 and prints one JSON line per
case: max |h32 - h64|, max |dxi32 - dxi64| beside max |dxi64|, and the
weight gradient's max |dWh32 - dWh64| / max(1, max |dWh64|). With
`--device cuda` everything runs on the card, and each line also holds the
same three drifts of the kernels (`gru_fwd`, `gru_bwd`) from the f64 plain
version (`kernel_*`), the comparison `tests/test_torch_cuda.py`'s chaotic
case asserts. Inputs come from numpy with --seed (xi ~ 0.5 N(0, 1), b ~
0.1 N(0, 1), dh ~ N(0, 1)).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

CASES = [(304, 20, 64), (304, 20, 128), (333, 7, 200), (304, 20, 256)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = p.parse_args(argv)

    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from factorvae_tpu_torch.ops.kernels.gru import (
        gru_bwd,
        gru_bwd_plain,
        gru_fwd,
        gru_fwd_plain,
    )

    def drifts(h32, g32, h64, g64) -> dict:
        return {"h_drift": float((h32.double() - h64).abs().max()),
                "dxi_drift": float((g32[0].double() - g64[0]).abs().max()),
                "dwh_rel_drift": float((g32[1].double() - g64[1]).abs().max()
                                       / max(1.0, float(g64[1].abs().max())))}

    for n, t, h in CASES:
        for label, scale in (("0.3", 0.3), ("1/sqrt(H)", h ** -0.5)):
            rng = np.random.default_rng(args.seed)
            arrays = ((rng.normal(size=(n, t, 3 * h)) * 0.5).astype(np.float32),
                      (rng.normal(size=(h, 3 * h)) * scale).astype(np.float32),
                      (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32),
                      rng.normal(size=(n, h)).astype(np.float32))
            f32 = [torch.from_numpy(a).to(args.device) for a in arrays]
            f64 = [a.double() for a in f32]
            h64, g64 = gru_fwd_plain(*f64[:3]), gru_bwd_plain(*f64)
            line = {"shape": [n, t, h], "wh_scale": label, "device": args.device,
                    **drifts(gru_fwd_plain(*f32[:3]), gru_bwd_plain(*f32), h64, g64),
                    "dxi_max": float(g64[0].abs().max())}
            if args.device == "cuda":
                line.update({"kernel_" + k: v for k, v in drifts(
                    gru_fwd(*f32[:3]), gru_bwd(*f32), h64, g64).items()})
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
