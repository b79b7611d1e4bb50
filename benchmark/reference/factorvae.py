"""Plain PyTorch reference of FactorVAE, written from the model's equations.

It imports torch, numpy and the standard library only: nothing of the
program under test. Everything the program derives from the benchmark's
inputs (the look-back windows, the padding of the cross-section, the noise
streams, the learning-rate schedule and Adam's state) is worked out here
again from those inputs.

Equations (x7jeon8gi/FactorVAE `module.py`, as the port states them):

- extractor: LayerNorm(C) -> Linear(C, C) -> LeakyReLU(0.01) -> GRU over T
  (gates [r | z | n], g = h Wh + bh, h' = (1 - z) n + z h) -> last h;
- encoder: portfolio weights softmax over the day's valid stocks of
  Linear(H, M)(latent); portfolio returns y_p = W^T y; mu = Linear(M, K),
  sigma = softplus(Linear(M, K));
- decoder: alpha_mu = Linear(H, 1)(leaky(Linear(H, H))),
  alpha_sigma = softplus(...), beta = Linear(H, K); mu = alpha_mu + beta f_mu,
  sigma = sqrt(alpha_sigma^2 + beta^2 f_sigma^2 + 1e-6), sample mu + eps sigma;
- predictor: per head k, keys = L Wk[k] + bk[k], values = L Wv[k] + bv[k],
  scores q[k] . key / sqrt(H + 1e-6), times the dropout keep-mask in
  training, ReLU, softmax over the valid stocks, context a^T values (a head
  with a non-finite score gives a zero context); mu and sigma from a shared
  head MLP as in the decoder's alpha layer;
- loss per day: masked MSE of the sample against the labels plus kl_weight
  times KL(posterior || prior) summed over K; a batch's loss is the mean
  over its real days.

Every product goes through `_dot`, so that the control can compute the same
reference in a lower precision: TF32 on the card, where the card rounds the
products' inputs itself, or TF32's rounding emulated on the CPU.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

_PRECISION = {"mode": "float32"}


@contextmanager
def precision(mode: str):
    """Compute the reference's products in `mode`: "float32" (TF32 off) or
    "tf32" (the control: the card's TF32 products, or on the CPU each
    product's inputs rounded to TF32's 10-bit mantissa)."""
    if mode not in ("float32", "tf32"):
        raise ValueError(f"precision {mode!r}")
    saved = (_PRECISION["mode"], torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _PRECISION["mode"] = mode
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        (_PRECISION["mode"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest on TF32's 10 explicit mantissa bits; the
    gradient passes through the rounding."""
    bits = t.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (rounded - t).detach()


def _dot(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    if _PRECISION["mode"] == "tf32" and ops[0].device.type == "cpu":
        ops = tuple(round_tf32(o) for o in ops)
    return torch.einsum(eq, *ops)


def _linear(x, w, b):
    return _dot("...i,oi->...o", x, w) + b


def _leaky(x, slope: float = 0.01):
    return torch.where(x >= 0, x, x * slope)


def _softplus(x):
    return torch.where(x > 20.0, x, torch.log1p(torch.exp(torch.clamp(x, max=20.0))))


# ---- parameters --------------------------------------------------------------


def param_specs(m: dict) -> list:
    """(name, shape, init) of every parameter, under the program's state-dict
    names (the names are how both sides are handed the same weights). init
    is "ones", "zeros", "normal" or ("uniform", fan_in): U(+-1/sqrt(fan_in)),
    the scale of torch's Linear and GRU."""
    c, h, k, mm = m["num_features"], m["hidden_size"], m["num_factors"], m["num_portfolios"]

    def dense(name, fan_in, out):
        return [(f"{name}.weight", (out, fan_in), ("uniform", fan_in)),
                (f"{name}.bias", (out,), ("uniform", fan_in))]

    return [
        ("feature_extractor.layer_norm.weight", (c,), "ones"),
        ("feature_extractor.layer_norm.bias", (c,), "zeros"),
        *dense("feature_extractor.proj", c, c),
        *dense("feature_extractor.gru.input_proj", c, 3 * h),
        ("feature_extractor.gru.hidden_kernel", (h, 3 * h), ("uniform", h)),
        ("feature_extractor.gru.hidden_bias", (3 * h,), ("uniform", h)),
        *dense("factor_encoder.portfolio", h, mm),
        *dense("factor_encoder.mu", mm, k),
        *dense("factor_encoder.sigma", mm, k),
        *dense("factor_decoder.alpha_layer.proj", h, h),
        *dense("factor_decoder.alpha_layer.mu", h, 1),
        *dense("factor_decoder.alpha_layer.sigma", h, 1),
        *dense("factor_decoder.beta_layer.beta", h, k),
        ("factor_predictor.query", (k, h), "normal"),
        ("factor_predictor.key_kernel", (k, h, h), ("uniform", h)),
        ("factor_predictor.key_bias", (k, h), ("uniform", h)),
        ("factor_predictor.value_kernel", (k, h, h), ("uniform", h)),
        ("factor_predictor.value_bias", (k, h), ("uniform", h)),
        *dense("factor_predictor.proj", h, h),
        *dense("factor_predictor.mu", h, 1),
        *dense("factor_predictor.sigma", h, 1),
    ]


# ---- data ----------------------------------------------------------------------


def pad_panel(values: torch.Tensor, valid: torch.Tensor, multiple: int):
    """The cross-section padded to a multiple of `multiple` stocks with
    instruments that are never valid: values (I, D, C+1) NaN-filled,
    valid (D, I) False."""
    n = values.shape[0]
    n_max = -(-n // multiple) * multiple
    if n_max == n:
        return values, valid
    pad_v = torch.full((n_max - n,) + tuple(values.shape[1:]), float("nan"),
                       dtype=values.dtype, device=values.device)
    pad_m = torch.zeros((valid.shape[0], n_max - n), dtype=torch.bool, device=valid.device)
    return torch.cat([values, pad_v]), torch.cat([valid, pad_m], dim=1)


def windows(values: torch.Tensor, valid: torch.Tensor, days: torch.Tensor, t_len: int):
    """(x (B, I, T, C), y (B, I), mask (B, I)) of the day batch `days` (B,),
    valid day indices. Position t of day d's window is trading day
    d - T + 1 + t. A position whose stock has no row takes the last earlier
    row inside the window; positions before the window's first row take
    that first row; a stock with no row in the window takes day d itself.
    Missing values read 0; mask says the stock has a row on day d."""
    d_total = values.shape[1]
    days = days.to(torch.int64)
    t = torch.arange(t_len, device=days.device)
    pos = days[:, None] - (t_len - 1) + t                                 # (B, T)
    present = valid[pos.clamp(0, d_total - 1)] & (pos >= 0)[:, :, None]   # (B, T, I)
    at = torch.where(present, t[None, :, None], -1)
    last = torch.cummax(at, dim=1).values                                 # (B, T, I)
    first = torch.where(present, t[None, :, None], t_len).amin(dim=1)     # (B, I)
    src = torch.where(last >= 0, last, first[:, None, :])
    row = torch.where(src < t_len, days[:, None, None] - (t_len - 1) + src,
                      days[:, None, None])                                # (B, T, I)
    inst = torch.arange(values.shape[0], device=values.device)[None, :, None]
    window = values[inst, row.transpose(1, 2)]                            # (B, I, T, C+1)
    x = torch.nan_to_num(window[..., :-1], nan=0.0)
    y = values[:, days, -1].transpose(0, 1)
    mask = valid[days]
    return x, y, mask


# ---- the model -----------------------------------------------------------------


def latent(p: dict, m: dict, x: torch.Tensor) -> torch.Tensor:
    """x (R, T, C) -> (R, H)."""
    pre = "feature_extractor."
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    x = (x - mean) / torch.sqrt(var + 1e-5) * p[pre + "layer_norm.weight"] \
        + p[pre + "layer_norm.bias"]
    x = _leaky(_linear(x, p[pre + "proj.weight"], p[pre + "proj.bias"]),
               m["leaky_relu_slope"])
    xi = _linear(x, p[pre + "gru.input_proj.weight"], p[pre + "gru.input_proj.bias"])
    wh, bh = p[pre + "gru.hidden_kernel"], p[pre + "gru.hidden_bias"]
    h_dim = wh.shape[0]
    h = x.new_zeros(x.shape[0], h_dim)
    for t in range(x.shape[1]):
        g = _dot("rh,hg->rg", h, wh) + bh
        xt = xi[:, t]
        r = torch.sigmoid(xt[:, :h_dim] + g[:, :h_dim])
        z = torch.sigmoid(xt[:, h_dim:2 * h_dim] + g[:, h_dim:2 * h_dim])
        n = torch.tanh(xt[:, 2 * h_dim:] + r * g[:, 2 * h_dim:])
        h = (1.0 - z) * n + z * h
    return h


def _masked_softmax(s: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    s = torch.where(mask, s, -math.inf)
    top = torch.amax(s, dim=dim, keepdim=True)
    top = torch.where(torch.isfinite(top), top, 0.0)
    e = torch.where(mask, torch.exp(s - top), 0.0)
    total = e.sum(dim=dim, keepdim=True)
    return torch.where(total > 0, e / torch.where(total > 0, total, 1.0), 0.0)


def _head(p, pre, slope, x):
    hid = _leaky(_linear(x, p[pre + "proj.weight"], p[pre + "proj.bias"]), slope)
    mu = _linear(hid, p[pre + "mu.weight"], p[pre + "mu.bias"])[..., 0]
    sigma = _softplus(_linear(hid, p[pre + "sigma.weight"], p[pre + "sigma.bias"]))[..., 0]
    return mu, sigma


def prior(p: dict, m: dict, lat: torch.Tensor, mask: torch.Tensor,
          keep: Optional[torch.Tensor]):
    """The predictor: lat (B, N, H), mask (B, N), keep (B, K, N) or None ->
    (mu (B, K), sigma (B, K))."""
    pre = "factor_predictor."
    h_dim = lat.shape[-1]
    keys = _dot("bnh,khj->bknj", lat, p[pre + "key_kernel"]) + p[pre + "key_bias"][None, :, None]
    vals = _dot("bnh,khj->bknj", lat, p[pre + "value_kernel"]) \
        + p[pre + "value_bias"][None, :, None]
    s = _dot("kh,bknh->bkn", p[pre + "query"], keys) / math.sqrt(h_dim + 1e-6)
    if keep is not None:
        s = s * keep
    s = torch.relu(s)
    valid = mask[:, None, :].expand_as(s)
    a = _masked_softmax(s, valid, dim=-1)
    bad = (~torch.isfinite(torch.where(valid, s, 0.0))).any(-1, keepdim=True)
    ctx = _dot("bkn,bknh->bkh", torch.where(bad, 0.0, a), torch.nan_to_num(vals))
    ctx = torch.where(bad, 0.0, ctx)
    return _head(p, pre, m["leaky_relu_slope"], ctx)


def decoder(p: dict, m: dict, lat, f_mu, f_sigma):
    """(mu, sigma) of each stock's return, (B, N) each."""
    pre = "factor_decoder."
    a_mu, a_sigma = _head(p, pre + "alpha_layer.", m["leaky_relu_slope"], lat)
    beta = _linear(lat, p[pre + "beta_layer.beta.weight"], p[pre + "beta_layer.beta.bias"])
    f_sigma = torch.where(f_sigma == 0.0, 1e-6, f_sigma)
    mu = a_mu + _dot("bnk,bk->bn", beta, f_mu)
    sigma = torch.sqrt(a_sigma ** 2 + _dot("bnk,bk->bn", beta ** 2, f_sigma ** 2) + 1e-6)
    return mu, sigma


def day_losses(p: dict, m: dict, x, y, mask, eps, keep) -> torch.Tensor:
    """Per-day training loss (B,): x (B, N, T, C), y and mask (B, N), eps
    (B, N), keep (B, K, N) or None."""
    b, n = mask.shape
    lat = latent(p, m, x.reshape((b * n,) + tuple(x.shape[2:]))).reshape(b, n, -1)
    ok = mask & torch.isfinite(y)
    y = torch.where(ok, y, 0.0)
    pre = "factor_encoder."
    w = _masked_softmax(_linear(lat, p[pre + "portfolio.weight"], p[pre + "portfolio.bias"]),
                        mask[..., None], dim=1)
    y_p = _dot("bnm,bn->bm", w, torch.where(mask, y, 0.0))
    f_mu = _linear(y_p, p[pre + "mu.weight"], p[pre + "mu.bias"])
    f_sigma = _softplus(_linear(y_p, p[pre + "sigma.weight"], p[pre + "sigma.bias"]))
    mu, sigma = decoder(p, m, lat, f_mu, f_sigma)
    sample = mu + eps * sigma
    err = torch.where(ok, (sample - y) ** 2, 0.0)
    count = ok.sum(-1)
    recon = torch.where(count > 0, err.sum(-1) / count.clamp(min=1), 0.0)
    p_mu, p_sigma = prior(p, m, lat, mask, keep)
    p_sigma = torch.where(p_sigma == 0.0, 1e-6, p_sigma)
    kl = (torch.log(p_sigma / f_sigma) + (f_sigma ** 2 + (f_mu - p_mu) ** 2)
          / (2.0 * p_sigma ** 2) - 0.5).sum(-1)
    return recon + m["kl_weight"] * kl


def scores(p: dict, m: dict, x, mask, eps) -> torch.Tensor:
    """Scores (B, N) of the prior's sampled returns, NaN where mask is off."""
    b, n = mask.shape
    lat = latent(p, m, x.reshape((b * n,) + tuple(x.shape[2:]))).reshape(b, n, -1)
    p_mu, p_sigma = prior(p, m, lat, mask, None)
    mu, sigma = decoder(p, m, lat, p_mu, p_sigma)
    return torch.where(mask, mu + eps * sigma, torch.nan)


# ---- noise, schedule, optimizer -------------------------------------------------------


def seed_for(*words: int) -> int:
    """The 63-bit seed of a noise stream derived from integers (the run's
    seed, a stream id, ...) through numpy's SeedSequence."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


TRAIN_NOISE_STREAM = 1


def train_noise(m: dict, seed: int, steps: int, b: int, n: int, device):
    """The (eps (B, N), keep (B, K, N)) of the first `steps` training steps of
    a run seeded `seed`: one generator on `device`, per step eps then the
    keep-mask Bernoulli(1 - p) / (1 - p)."""
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, TRAIN_NOISE_STREAM))
    keep_p = 1.0 - m["dropout_rate"]
    out = []
    for _ in range(steps):
        eps = torch.randn((b, n), generator=gen, device=device, dtype=torch.float32)
        keep = None
        if m["dropout_rate"] > 0.0:
            u = torch.rand((b, m["num_factors"], n), generator=gen, device=device)
            keep = (u < keep_p).to(torch.float32) / keep_p
        out.append((eps, keep))
    return out


def score_noise(seed: int, chunk_index: int, b: int, n: int, device) -> torch.Tensor:
    """eps (B, N) of chunk `chunk_index` of a scoring pass seeded `seed`: the
    pass's generator draws one (B, N) normal block per chunk, in order."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for _ in range(chunk_index):
        torch.randn((b, n), generator=gen, device=device, dtype=torch.float32)
    return torch.randn((b, n), generator=gen, device=device, dtype=torch.float32)


def cosine_lr(lr: float, step: int, total: int) -> float:
    """The learning rate of update `step` (0-based) of a cosine decay to 0
    over `total` updates."""
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(step, total) / total))


def adam_update(p: dict, grads: dict, state: dict, lr: float,
                betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One Adam update of `p` in place; `state` holds m, v and the count."""
    state["t"] = state.get("t", 0) + 1
    t = state["t"]
    for name, g in grads.items():
        m_, v_ = state.setdefault(("m", name), torch.zeros_like(g)), \
            state.setdefault(("v", name), torch.zeros_like(g))
        m_.mul_(betas[0]).add_(g, alpha=1.0 - betas[0])
        v_.mul_(betas[1]).add_(g * g, alpha=1.0 - betas[1])
        m_hat = m_ / (1.0 - betas[0] ** t)
        v_hat = v_ / (1.0 - betas[1] ** t)
        p[name] = p[name] - lr * m_hat / (torch.sqrt(v_hat) + eps)


def train_steps(p0: dict, m: dict, batches: list, noise: list, lrs: list,
                half_batch: bool = False):
    """Follow `len(batches)` training steps from the weights `p0`: each batch
    is (x, y, mask, day_w). Returns (losses [float], first gradient {name:
    tensor}, weights after the last step {name: tensor}). `half_batch` is a
    planted fault: each step keeps the first half of its days and takes the
    mean over them."""
    p = {k: v.detach().clone() for k, v in p0.items()}
    state: dict = {}
    losses, first = [], None
    for (x, y, mask, day_w), (eps, keep), lr in zip(batches, noise, lrs):
        if half_batch:
            day_w = day_w.clone()
            day_w[day_w.shape[0] // 2:] = 0.0
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        per_day = day_losses(leaves, m, x, y, mask & (day_w > 0)[:, None], eps, keep)
        loss = (per_day * day_w).sum() / day_w.sum().clamp(min=1.0)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        p = {k: v.detach() for k, v in leaves.items()}
        adam_update(p, grads, state, lr)
    return losses, first, p
