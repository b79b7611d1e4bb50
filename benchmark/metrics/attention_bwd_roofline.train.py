"""The attention backward's share of its roofline, once per training step.
Moves train_windows_per_s."""

from benchmark.harness import flops, roofline

COUNTERS = {k: roofline.COUNTERS[k] for k in ("attention_bwd",)}
RANGES = ("attention_bwd",)
NAME_TABLE = roofline.NAME_TABLE


def least(ctx) -> float:
    s = ctx.shapes
    return ctx.counts["attention_bwd"] * flops.attention_bwd(
        s["days"], s["n"], s["k"], s["h"], s["valid_train"])


def read(ctx):
    return roofline.share(ctx, RANGES, least(ctx))
