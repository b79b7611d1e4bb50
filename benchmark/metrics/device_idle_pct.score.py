"""The share of the traced window in which nothing ran on the card: one
minus the union of its kernel, copy and set intervals over the window.
Moves score_windows_per_s."""


def read(ctx):
    red = ctx.reduced
    if red is None or red.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - red.busy_s / red.window_s)
