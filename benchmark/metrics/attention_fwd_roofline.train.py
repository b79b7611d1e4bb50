"""The cross-section attention's share of its roofline in the training
cells: with the dropout keep-mask in each step (one backward each), without
it in validation. Moves train_windows_per_s."""

from benchmark.harness import flops, roofline

COUNTERS = {k: roofline.COUNTERS[k] for k in ("attention_fwd", "attention_bwd")}
RANGES = ("attention_fwd",)
NAME_TABLE = roofline.NAME_TABLE


def least(ctx) -> float:
    s, c = ctx.shapes, ctx.counts
    train_calls = c["attention_bwd"]
    eval_calls = c["attention_fwd"] - train_calls
    one = (s["days"], s["n"], s["k"], s["h"])
    return (train_calls * flops.attention_fwd(*one, s["valid_train"], keep=True)
            + eval_calls * flops.attention_fwd(*one, s["valid_eval"], keep=False))


def read(ctx):
    return roofline.share(ctx, RANGES, least(ctx))
