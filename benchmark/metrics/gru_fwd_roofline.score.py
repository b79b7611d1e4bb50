"""The GRU forward's (serving variant's) share of its roofline, once per
scoring chunk. Moves score_windows_per_s."""

from benchmark.harness import flops, roofline

COUNTERS = {k: roofline.COUNTERS[k] for k in ("gru_fwd",)}
RANGES = ("gru_fwd",)
NAME_TABLE = roofline.NAME_TABLE


def least(ctx) -> float:
    s = ctx.shapes
    return ctx.counts["gru_fwd"] * flops.gru_fwd(s["rows"], s["t"], s["h"], residuals=False)


def read(ctx):
    return roofline.share(ctx, RANGES, least(ctx))
