"""The kernel operations' share of their roofline together in the training
cells: the least time of the GRU forward, the GRU backward, the attention
and its backward over the device time of all four. Moves
train_windows_per_s."""

from benchmark.harness import roofline
from benchmark.harness.cells import metric_reader

PARTS = ("gru_fwd_roofline.train", "gru_bwd_roofline.train",
         "attention_fwd_roofline.train", "attention_bwd_roofline.train")

_MODS = [metric_reader(p) for p in PARTS]
COUNTERS = {k: v for m in _MODS for k, v in m.COUNTERS.items()}
RANGES = tuple(r for m in _MODS for r in m.RANGES)
NAME_TABLE = roofline.NAME_TABLE


def read(ctx):
    return roofline.share(ctx, RANGES, sum(m.least(ctx) for m in _MODS))
