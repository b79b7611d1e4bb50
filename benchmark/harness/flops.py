"""Peaks of the card and the least work of the model and of its kernels,
counted from shapes.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit. The f32 rate
is that of the CUDA cores; the GRU's matrix products run on the tensor
cores at f32 accuracy as three TF32 products each (3xTF32), so they are
bounded by a third of the TF32 rate.

The kernels' counts follow `chip_smoke.py`'s bounds (`_k1_bound`, the K2
walk and dWh counts, `_k4_timing`, `_k5_timing`): each input byte read once,
each output byte written once, and the least operations the function needs.
They count an operation, whatever implements it: the GRU forward (serving
and training variants), the GRU backward (the walk back through time and
dWh together, from the forward's residuals), the cross-section attention
and its backward.
"""

from __future__ import annotations

F32_PEAK = 67e12       # FLOP/s, float32 on the CUDA cores
TF32_PEAK = 495e12     # FLOP/s, TF32 on the tensor cores
HBM_RATE = 3.35e12     # bytes/s


def least_seconds(n_bytes: float, flops: float = 0.0, tf32_flops: float = 0.0) -> float:
    """The larger of the bytes over HBM's rate and the operations over their
    rate."""
    return max(n_bytes / HBM_RATE, flops / F32_PEAK, tf32_flops / TF32_PEAK)


def gru_least_seconds(n_bytes: float, products: float, elementwise: float) -> float:
    """A GRU function: its products as 3xTF32, the rest at the f32 rate."""
    return least_seconds(n_bytes, elementwise, 3.0 * products)


# ---- the operations (one call each) -----------------------------------------


def gru_fwd(rows: int, t: int, h: int, residuals: bool) -> float:
    """The recurrence over xi (rows, T, 3H): the h . Wh products and ~10
    elementwise steps per (row, step, unit); the training variant also
    writes h before each step and g = h . Wh + b."""
    n_bytes = 4.0 * (rows * t * 3 * h + 3 * h * h + 3 * h + rows * h)
    if residuals:
        n_bytes += 4.0 * rows * t * 4 * h
    return gru_least_seconds(n_bytes, 2.0 * rows * t * h * 3 * h, 10.0 * rows * t * h)


def gru_bwd(rows: int, t: int, h: int) -> float:
    """The walk back through time and dWh, from the residuals: reads xi, g,
    h and dh and Wh, writes dxi, dWh and db; products dg . Wh^T over T - 1
    steps and h^T . dg over T; ~30 elementwise steps per (row, step, unit)
    and the bias sum."""
    n_bytes = 4.0 * (rows * t * (3 * h + 3 * h + h + 3 * h) + rows * h
                     + 2 * 3 * h * h + 3 * h)
    products = 2.0 * rows * (t - 1) * h * 3 * h + 2.0 * rows * t * h * 3 * h
    return gru_least_seconds(n_bytes, products, 30.0 * rows * t * h + rows * t * 3 * h)


def attention_fwd(days: int, n: int, k: int, h: int, valid_rows: float, keep: bool) -> float:
    """K heads over `days` cross-sections of n rows (valid_rows of them
    valid in all), the key and value products folded: per valid row and
    head the score and the a^T L sum (4H) and six scalar steps; per (day,
    head) the context's (H,) . (H, H) product and bias; per head u = Wk q.
    Bytes: the latent, the weights, the context, the mask and the keep-mask
    when there is one."""
    flops = k * valid_rows * (4.0 * h + 6.0) + (days + 1) * k * (2.0 * h * h + 2.0 * h)
    n_bytes = 4.0 * (days * n * h + k * (2 * h * h + 3 * h) + days * k * h) + days * n
    if keep:
        n_bytes += 4.0 * days * k * n
    return least_seconds(n_bytes, flops)


def attention_bwd(days: int, n: int, k: int, h: int, valid_rows: float) -> float:
    """The attention's VJP with the products folded: per valid row and head
    12H + 10; per (day, head) w = Wv dctx, dWv and the biases (4H^2 + 4H);
    per head u, dq and dWk (5H^2 + 5H). Bytes: the latent read and its
    gradient written, the keep-mask, the weights read and their gradients
    written, dctx, the mask."""
    flops = (k * valid_rows * (12.0 * h + 10.0) + days * k * (4.0 * h * h + 4.0 * h)
             + k * (5.0 * h * h + 5.0 * h))
    n_bytes = (4.0 * (2 * days * n * h + days * k * n + 2 * k * (2 * h * h + 3 * h)
                      + days * k * h) + days * n)
    return least_seconds(n_bytes, flops)


# ---- the model (for mfu) -----------------------------------------------------


def forward_flops_per_window(m: dict, valid_per_day: float, train: bool) -> float:
    """Product FLOPs of one forward per valid (day, stock) window: the
    extractor's projections and recurrence, the decoder, the attention in
    its folded form, and in training the encoder; per-day terms are shared
    over the day's valid windows. Elementwise work is not counted."""
    c, t, h, k, mm = (m["num_features"], m["seq_len"], m["hidden_size"],
                      m["num_factors"], m["num_portfolios"])
    per_row = (2.0 * t * c * c + 2.0 * t * c * 3 * h + 2.0 * t * h * 3 * h   # extractor
               + 2.0 * h * h + 4.0 * h + 2.0 * h * k + 4.0 * k              # decoder
               + 4.0 * h * k)                                               # attention
    per_day = k * (2.0 * h * h + 2.0 * h) + k * (2.0 * h * h + 4.0 * h)     # context, head MLP
    if train:
        per_row += 2.0 * h * mm + 2.0 * mm                                  # portfolios
        per_day += 4.0 * mm * k                                             # posterior heads
    return per_row + per_day / max(valid_per_day, 1.0)


def train_flops_per_window(m: dict, valid_per_day: float) -> float:
    """Forward and backward: three times the forward's products (the
    backward computes the input's and the weights' gradients)."""
    return 3.0 * forward_flops_per_window(m, valid_per_day, train=True)
