"""The median pass over the span, from the benchmark's own span around each
`predict_panel` call. Moves score_windows_per_s."""

import statistics


def read(ctx):
    spans = ctx.spans.get("pass") or []
    return statistics.median(spans) if spans else None
