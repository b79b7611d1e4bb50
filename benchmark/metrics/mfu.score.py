"""The whole scoring chunk's share of the card's f32 peak: the forward's
product FLOPs per valid window (from shapes) times the window's scored
windows per second, over 67 TFLOP/s. Moves score_windows_per_s."""

from benchmark.harness import flops


def read(ctx):
    if ctx.window_s <= 0.0 or ctx.windows <= 0:
        return None
    per_window = flops.forward_flops_per_window(ctx.config["model"], ctx.valid_per_day,
                                                train=False)
    return 100.0 * ctx.windows / ctx.window_s * per_window / flops.F32_PEAK
