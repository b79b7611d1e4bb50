"""The GRU backward's share of its roofline: the walk back through time and
dWh together, from the forward's residuals, once per training step. Moves
train_windows_per_s."""

from benchmark.harness import flops, roofline

COUNTERS = {k: roofline.COUNTERS[k] for k in ("gru_bwd",)}
RANGES = ("gru_bwd", "gru_dwh")
NAME_TABLE = roofline.NAME_TABLE


def least(ctx) -> float:
    s = ctx.shapes
    return ctx.counts["gru_bwd"] * flops.gru_bwd(s["rows"], s["t"], s["h"])


def read(ctx):
    return roofline.share(ctx, RANGES, least(ctx))
