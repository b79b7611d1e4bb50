#!/usr/bin/env python3
"""Split the GRU backward's time (the walk and dWh, `csrc/gru_bwd.cu`) on one
GPU.

    python3 scripts/torch_gru_walk_probe.py [--tree DIR] [--seed 0] [--out FILE]

Imports `factorvae_tpu_torch` from DIR (default: this checkout), so a parent
commit unpacked with `git archive` and this tree can run in turns on one
card in one call: parent, change, change, parent. Touches no kernel: it
calls the wrappers on inputs made from --seed and times each call with
`graph_ms` (the CUDA-event time of 20 replays of a CUDA graph of one call;
scripts/torch_kernel_digest.py's timer and options). At H in {64, 128, 256}
and N = 304 (one training day of 300 stocks):

- `steps`: at T in {1, 20, 60}, the walk alone (`_walk_launch` at the
  tree's launch shape for it, from K1's residuals), dWh alone (`gru_dwh` on
  the walk's outputs), `torch.matmul(hseq^T, dg)` (dWh's product without
  db, TF32 off), the walk + dWh (`gru_bwd` from given residuals), the pair
  (the residual forward, then the walk + dWh: a training step's GRU) and
  cuDNN's `nn.GRU` backward (identity input weight, forward graph kept).
  The T = 1 time is the walk's fixed cost (the launch, staging Wh, one
  step); (T20 - T1) / 19 and (T60 - T1) / 59 the cost of one more step.
- `tiles` (a tree whose walk has its own rule, `walk_launch_shape`): above
  H = 64 the walk at T = 20, N in {304, 2432} and 1 or 2 lanes, launched at
  every shape its kernel takes (`walk_shapes`), beside the clusters the
  card holds at that shape (`gru_walk_clusters`) and the shape the rule
  picks: the times the launch rule weighs.

Prints one JSON line with the card's `nvidia-smi` name and power limit;
exits 1 without a CUDA device.
"""

from __future__ import annotations

import os
import sys

from torch_kernel_digest import emit, graph_ms, nvidia_smi, parse_args, use_tree

HIDDEN = (64, 128, 256)
ROWS = 304
STEPS = (1, 20, 60)
TILE_ROWS = (304, 2432)
TILE_LANES = (1, 2)


def walk_shape(gru, xi) -> tuple:
    """The walk's launch shape in this tree: its own rule where the tree has
    one, else the rule it shares with the forward."""
    return tuple((getattr(gru, "_walk_shape", None) or gru._shape)(xi))


def main(argv=None) -> int:
    args = parse_args(__doc__, argv)
    torch = use_tree(args, "torch_gru_walk_probe")
    if torch is None:
        return 1
    from factorvae_tpu_torch import _build
    from factorvae_tpu_torch.ops.kernels import gru

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(("gru_fwd", "gru_bwd"))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    tile_gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)

    def inputs(n, t, h, g=gen, lane=()):
        xi = torch.randn(*lane, n, t, 3 * h, device="cuda", generator=g) * 0.5
        wh = (torch.rand(*lane, h, 3 * h, device="cuda", generator=g) * 2 - 1) / h ** 0.5
        bh = (torch.rand(*lane, 3 * h, device="cuda", generator=g) * 2 - 1) / h ** 0.5
        dh = torch.randn(*lane, n, h, device="cuda", generator=g) * 0.1
        return xi, wh, bh, dh

    def cudnn_bwd(xi, wh, bh, dh):
        """cuDNN's GRU backward on the same function: identity input weight,
        zero input bias, the forward's graph kept."""
        h = wh.shape[0]
        net = torch.nn.GRU(3 * h, h, batch_first=True).cuda()
        with torch.no_grad():
            net.weight_ih_l0.copy_(torch.eye(3 * h, device="cuda"))
            net.bias_ih_l0.zero_()
            net.weight_hh_l0.copy_(wh.T)
            net.bias_hh_l0.copy_(bh)
        x = xi.clone().requires_grad_()
        out = net(x)[1][0]
        wrt = (x, net.weight_hh_l0, net.bias_hh_l0)
        return lambda: torch.autograd.grad(out, wrt, dh, retain_graph=True)

    def library_ms(fn):
        """`graph_ms` of a yardstick, None where its graph cannot be captured."""
        try:
            return graph_ms(torch, fn)
        except RuntimeError:
            torch.cuda.synchronize()
            return None

    out = {"tree": os.path.abspath(args.tree), "nvidia_smi": nvidia_smi(), "steps": {},
           "tiles": {}}
    for h in HIDDEN:
        by_t = {}
        for t in STEPS:
            xi, wh, bh, dh = a = inputs(ROWS, t, h)
            _, hseq, gseq = gru.gru_fwd_residuals(xi, wh, bh)
            shape = walk_shape(gru, xi)
            dxi, dgn = gru._walk_launch(xi, wh, hseq, gseq, dh, shape)
            dg = torch.cat([dxi[..., :2 * h], dgn], dim=-1).reshape(-1, 3 * h)
            hflat = hseq.reshape(-1, h)
            row = {"launch_shape": list(shape),
                   "walk_ms": graph_ms(torch, lambda: gru._walk_launch(
                       xi, wh, hseq, gseq, dh, shape)),
                   "dwh_ms": graph_ms(torch, lambda: gru.gru_dwh(hseq, dxi, dgn)),
                   "matmul_ms": graph_ms(torch, lambda: torch.matmul(hflat.T, dg)),
                   "walk_dwh_ms": graph_ms(torch, lambda: gru.gru_bwd(
                       *a, residuals=(hseq, gseq))),
                   "pair_ms": graph_ms(torch, lambda: gru.gru_bwd(
                       *a, residuals=gru.gru_fwd_residuals(xi, wh, bh)[1:])),
                   "cudnn_bwd_ms": library_ms(cudnn_bwd(*a))}
            if hasattr(gru, "walk_launch_shape") and h > gru.MAX_UNITS:
                row["walk_clusters"] = gru._lib("gru_bwd").gru_walk_clusters(
                    ROWS, h, *shape, 1)
            by_t[f"T{t}"] = row
        for t in STEPS[1:]:
            by_t[f"walk_step_ms_T{t}"] = (
                (by_t[f"T{t}"]["walk_ms"] - by_t["T1"]["walk_ms"]) / (t - 1))
        out["steps"][str(h)] = by_t
        if h > 64 and hasattr(gru, "walk_launch_shape"):
            lib = gru._lib("gru_bwd")
            tiles = {}
            for lanes in TILE_LANES:
                for n in TILE_ROWS:
                    xi, wh, bh, dh = inputs(n, 20, h, tile_gen, () if lanes == 1 else (lanes,))
                    _, hseq, gseq = gru.gru_fwd_residuals(xi, wh, bh)
                    shapes = gru.walk_shapes(h)
                    tiles[f"S{lanes}_N{n}"] = {
                        "picked": list(walk_shape(gru, xi)),
                        "resident": {f"{r}x{c}": lib.gru_walk_clusters(1 << 20, h, r, c, 1)
                                     for r, c in shapes},
                        "ms": {f"{r}x{c}": graph_ms(torch, lambda s=(r, c): gru._walk_launch(
                            xi, wh, hseq, gseq, dh, s)) for r, c in shapes}}
            out["tiles"][str(h)] = tiles
    emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
