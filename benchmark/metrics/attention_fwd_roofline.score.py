"""The cross-section attention's share of its roofline, once per scoring
chunk (no keep-mask). Moves score_windows_per_s."""

from benchmark.harness import flops, roofline

COUNTERS = {k: roofline.COUNTERS[k] for k in ("attention_fwd",)}
RANGES = ("attention_fwd",)
NAME_TABLE = roofline.NAME_TABLE


def least(ctx) -> float:
    s = ctx.shapes
    return ctx.counts["attention_fwd"] * flops.attention_fwd(
        s["days"], s["n"], s["k"], s["h"], s["valid_eval"], keep=False)


def read(ctx):
    return roofline.share(ctx, RANGES, least(ctx))
