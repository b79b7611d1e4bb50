"""The GRU forward's share of its roofline in the training cells: the
training variant (with the backward's residuals) in each step, the serving
variant in validation. Moves train_windows_per_s."""

from benchmark.harness import flops, roofline

COUNTERS = {k: roofline.COUNTERS[k] for k in ("gru_fwd", "gru_fwd_residuals")}
RANGES = ("gru_fwd", "gru_fwd_residuals")
NAME_TABLE = roofline.NAME_TABLE


def least(ctx) -> float:
    s, c = ctx.shapes, ctx.counts
    return (c["gru_fwd_residuals"] * flops.gru_fwd(s["rows"], s["t"], s["h"], residuals=True)
            + c["gru_fwd"] * flops.gru_fwd(s["rows"], s["t"], s["h"], residuals=False))


def read(ctx):
    return roofline.share(ctx, RANGES, least(ctx))
