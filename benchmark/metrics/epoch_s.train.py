"""The median epoch of the window, from the benchmark's own span around
each (its training, validation and the previous epoch's checkpoint), read
beside the rate. Moves train_windows_per_s."""

import statistics


def read(ctx):
    spans = ctx.spans.get("epoch") or []
    return statistics.median(spans) if spans else None
