"""The whole training step's share of the card's f32 peak: the model's
forward and backward product FLOPs per valid training window (from shapes,
no recompute counted) times the window's training windows per second, over
67 TFLOP/s. Moves train_windows_per_s."""

from benchmark.harness import flops


def read(ctx):
    if ctx.window_s <= 0.0 or ctx.windows <= 0:
        return None
    per_window = flops.train_flops_per_window(ctx.config["model"], ctx.valid_per_day)
    return 100.0 * ctx.windows / ctx.window_s * per_window / flops.F32_PEAK
