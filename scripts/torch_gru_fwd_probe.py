#!/usr/bin/env python3
"""Split K1's time (the GRU forward, `csrc/gru_fwd.cu`) on one GPU.

    python3 scripts/torch_gru_fwd_probe.py [--tree DIR] [--seed 0] [--out FILE]

Imports `factorvae_tpu_torch` from DIR (default: this checkout), so a parent
commit unpacked with `git archive` and this tree can run in turns on one
card in one call: parent, change, change, parent. Touches no kernel: it
calls the public wrappers `gru_fwd` (serving) and `gru_fwd_residuals`
(training) on inputs made from --seed, and times each with `graph_ms` (the
CUDA-event time of 20 replays of a CUDA graph of one call;
scripts/torch_kernel_digest.py's timer and options). At H in {64, 128,
256}:

- `steps`: N in {304, 9728} at T = 1 and T = 20, both variants. The T = 1
  time is the fixed cost (the launch, staging Wh, the first step); (T20 -
  T1) / 19 is the cost of one more step.
- `sweep`: the serving variant at T = 20 over N = 8 ... 9728, beside the
  launch shape the wrapper picked, its CTAs and the clusters the library
  launches (`gru_fwd_clusters`, where the tree's library has it): the cost
  of a wave, or of a persistent cluster's round of tiles.
- `tiles` (a tree whose forward has its own rule, `FWD_ROWS`): above H = 64
  the serving variant at T = 20, N in {304, 9728} and 1 or 2 lanes,
  launched at each row tile of FWD_ROWS with the rule's cluster, beside
  the clusters the card holds at that tile and the tile the rule picks:
  the times its launch rule weighs.

Prints one JSON line with the card's `nvidia-smi` name and power limit;
exits 1 without a CUDA device.
"""

from __future__ import annotations

import os
import sys

from torch_kernel_digest import emit, graph_ms, nvidia_smi, parse_args, use_tree

HIDDEN = (64, 128, 256)
STEP_ROWS = (304, 9728)
SWEEP_ROWS = (8, 32, 64, 128, 304, 608, 1216, 2432, 4864, 9728)
TILE_LANES = (1, 2)


def _shape(gru, xi) -> tuple:
    """The forward's launch shape in this tree: its own rule where the tree
    has one, else the rule it shares with the walk."""
    return tuple((getattr(gru, "_fwd_shape", None) or gru._shape)(xi))


def main(argv=None) -> int:
    args = parse_args(__doc__, argv)
    torch = use_tree(args, "torch_gru_fwd_probe")
    if torch is None:
        return 1
    from factorvae_tpu_torch import _build
    from factorvae_tpu_torch.ops.kernels import gru

    _build.build(("gru_fwd",))
    lib = gru._lib("gru_fwd")
    clusters_of = getattr(lib, "gru_fwd_clusters", None)
    if clusters_of is not None:
        clusters_of.argtypes = [gru._I] * 5
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    # the tiles' inputs apart, so both trees time `steps` and `sweep` on the same
    tile_gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)

    def inputs(n, t, h, g=gen, lane=()):
        xi = torch.randn(*lane, n, t, 3 * h, device="cuda", generator=g) * 0.5
        wh = (torch.rand(*lane, h, 3 * h, device="cuda", generator=g) * 2 - 1) / h ** 0.5
        bh = (torch.rand(*lane, 3 * h, device="cuda", generator=g) * 2 - 1) / h ** 0.5
        return xi, wh, bh

    out = {"tree": os.path.abspath(args.tree), "nvidia_smi": nvidia_smi(), "steps": {},
           "sweep": {}, "tiles": {}}
    for h in HIDDEN:
        steps = {}
        for n in STEP_ROWS:
            row = {}
            for t in (1, 20):
                a = inputs(n, t, h)
                row[f"T{t}"] = {
                    "serve_ms": graph_ms(torch, lambda a=a: gru.gru_fwd(*a)),
                    "residual_ms": graph_ms(torch, lambda a=a: gru.gru_fwd_residuals(*a))}
            for v in ("serve_ms", "residual_ms"):
                row[f"{v[:-3]}_step_ms"] = (row["T20"][v] - row["T1"][v]) / 19
            row["launch_shape"] = list(_shape(gru, a[0]))
            steps[str(n)] = row
        out["steps"][str(h)] = steps
        sweep = {}
        for n in SWEEP_ROWS:
            a = inputs(n, 20, h)
            rows, cluster = _shape(gru, a[0])
            entry = {"graph_ms": graph_ms(torch, lambda a=a: gru.gru_fwd(*a)),
                     "launch_shape": [rows, cluster], "tiles": -(-n // rows)}
            if clusters_of is not None:
                entry["clusters"] = clusters_of(n, h, rows, cluster, 1)
                entry["ctas"] = entry["clusters"] * cluster
            else:
                entry["ctas"] = entry["tiles"] * cluster
            sweep[str(n)] = entry
        out["sweep"][str(h)] = sweep
        if h > 64 and hasattr(gru, "FWD_ROWS"):
            tiles = {}
            for lanes in TILE_LANES:
                for n in STEP_ROWS:
                    a = inputs(n, 20, h, tile_gen, () if lanes == 1 else (lanes,))
                    picked, cluster = _shape(gru, a[0])
                    tiles[f"S{lanes}_N{n}"] = {
                        "picked": picked,
                        "resident": {str(rows): clusters_of(1 << 20, h, rows, cluster, 1)
                                     for rows in gru.FWD_ROWS},
                        "ms": {str(rows): graph_ms(torch, lambda a=a, s=(rows, cluster): (
                            gru._fwd_launch("gru_fwd", *a, False, s))) for rows in gru.FWD_ROWS}}
            out["tiles"][str(h)] = tiles
    emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
