"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. Hidden sizes
above 64 (up to 256, the kernels' wider instances) are cases of the same
tests, and of `test_gru_wide_cluster_path_matches_plain`,
`test_gru_wide_forward_matches_plain_at_every_tile` (K1's persistent wide
kernel), the `test_gru_wide_walk_*` and `test_gru_wide_dwh_*` tests (the
persistent wide walk and the tensor-core dWh),
`test_attention_takes_5000_rows_at_h256` and the `test_wide_attention_*`
tests (the wide attention kernels' sums at every group size). The file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch, without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: f32 with rtol=1e-5, atol=1e-5. The kernels sum their products
in another order than cuBLAS does for the plain versions. Weight gradients,
which sum over every row (and step), are held on max |a - b| <= 1e-5 *
max(1, max |b|).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from factorvae_tpu_torch.ops.kernels import attention as attention_module
from factorvae_tpu_torch.ops.kernels.attention import (
    GROUPS,
    MAX_GROUP_ROWS,
    attention,
    attention_bwd,
    attention_bwd_plain,
    attention_fwd,
    attention_fwd_plain,
    launch_group,
)
from factorvae_tpu_torch.ops.kernels import gru as gru_module
from factorvae_tpu_torch.ops.kernels.gru import (
    gru,
    gru_bwd,
    gru_bwd_plain,
    gru_dwh,
    gru_dwh_plain,
    gru_fwd,
    gru_fwd_plain,
    gru_fwd_residuals,
    gru_walk_plain,
    launch_shape,
)

TOL = dict(rtol=1e-5, atol=1e-5)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _to(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _wh_scale(h):
    """The scale of a test's Wh: 0.3 up to H = 64, the model's own 1/sqrt(H)
    above. At 0.3 a wider recurrence is chaotic and its gradients explode:
    at H = 256 the plain version in f32 drifts from f64 by 2.3e-4 (h) and
    3.9e-2 (dxi, which reaches 444) on the CPU, beyond any f32 tolerance;
    at 1/sqrt(H) by 2.3e-7 and 4.4e-7 (scripts/torch_gru_drift.py)."""
    return 0.3 if h <= 64 else h ** -0.5


def _close(got, want):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


def _close_sum(got, want):
    """A gradient summed over many rows: max |a - b| <= 1e-5 * max(1, max |b|)."""
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("n,t,h", [(9728, 20, 64), (1001, 20, 60), (37, 6, 8),
                                   (33, 5, 37), (300, 20, 33), (37, 6, 65), (9728, 20, 128),
                                   (333, 7, 200), (9728, 20, 256)])
def test_gru_kernel_matches_plain(dev, n, t, h):
    rng = np.random.default_rng(n + h)
    xi, wh, bh = _to(dev, (rng.normal(size=(n, t, 3 * h)) * 0.5).astype(np.float32),
                     (rng.normal(size=(h, 3 * h)) * _wh_scale(h)).astype(np.float32),
                     (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32))
    before = gru_fwd.launches
    got = gru_fwd(xi, wh, bh)
    assert gru_fwd.launches == before + 1
    _close(got, gru_fwd_plain(xi, wh, bh))


def test_gru_kernel_refuses_what_it_cannot_run(dev):
    with pytest.raises(ValueError, match="exceeds"):
        gru_fwd(torch.zeros(2, 3, 771, device=dev), torch.zeros(257, 771, device=dev),
                torch.zeros(771, device=dev))
    with pytest.raises(TypeError):
        gru_fwd(torch.zeros(2, 3, 6, device=dev, dtype=torch.float64),
                torch.zeros(2, 6, device=dev, dtype=torch.float64),
                torch.zeros(6, device=dev, dtype=torch.float64))


def test_attention_kernel_refuses_what_it_cannot_run(dev):
    def call(b, n, k, h):
        return attention_fwd(torch.zeros(b, n, h, device=dev),
                             torch.ones(b, n, dtype=torch.bool, device=dev),
                             torch.zeros(k, h, device=dev), torch.zeros(k, h, h, device=dev),
                             torch.zeros(k, h, device=dev), torch.zeros(k, h, h, device=dev),
                             torch.zeros(k, h, device=dev))

    with pytest.raises(ValueError, match="exceeds"):
        call(1, 4, 2, 257)
    before = attention_fwd.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        call(1, 40000, 1, 8)     # row list and scores exceed one block's shared
                                 # memory even with the rows left in device memory
    assert attention_fwd.launches == before
    call(1, 4, 2, 8)             # the refusal leaves no error behind for the next launch
    assert attention_fwd.launches == before + 1


def _with_inf_days(rng, latent, mask, q, wk):
    """latent and mask with two more days: row 2 of the first holds +inf in
    one column, row 2 of the second -inf. The columns are those where the
    folded score L . (Wk q) is -inf on some head (Wk q < 0 at the +inf
    column, > 0 at the -inf one), while the score as written, (L . Wk) . q,
    sums infinities of both signs and is NaN: the guard zeroes the head."""
    _, n, h = latent.shape
    extra = rng.normal(size=(2, n, h)).astype(np.float32)
    extra_mask = rng.random((2, n)) > 0.2
    u = np.einsum("khj,kj->kh", wk, q)
    extra[0, 2, u.min(axis=0).argmin()] = np.inf
    extra[1, 2, u.max(axis=0).argmax()] = -np.inf
    extra_mask[:, 2] = True
    return np.concatenate([latent, extra]), np.concatenate([mask, extra_mask])


@pytest.mark.parametrize("b,n,k,h", [(32, 304, 96, 64), (3, 10, 4, 8),
                                     (2, 800, 60, 60), (3, 70, 6, 37)])
@pytest.mark.parametrize("with_keep", [False, True], ids=["serving", "keep_mask"])
def test_attention_kernel_matches_plain(dev, b, n, k, h, with_keep):
    rng = np.random.default_rng(b * n + h)
    latent = rng.normal(size=(b, n, h)).astype(np.float32)
    mask = rng.random((b, n)) > 0.2
    mask[0] = False                                   # an all-padding day
    latent[1, 3, 0] = np.nan                          # the guard zeroes day 1
    mask[1, 3] = True
    weights = [rng.normal(size=(k, h)).astype(np.float32)]
    for shape in ((k, h, h), (k, h), (k, h, h), (k, h)):
        weights.append((rng.normal(size=shape) / np.sqrt(h)).astype(np.float32))
    latent, mask = _with_inf_days(rng, latent, mask, weights[0], weights[1])
    args = _to(dev, latent, mask, *weights)
    keep = None
    if with_keep:
        keep = _to(dev, ((rng.random((b + 2, k, n)) > 0.1) / 0.9).astype(np.float32))[0]
    before = attention_fwd.launches
    got = attention_fwd(*args, keep=keep)
    assert attention_fwd.launches == before + 1
    _close(got, attention_fwd_plain(*args, keep=keep))
    for day in (0, 1, b, b + 1):                      # empty, NaN, +inf, -inf
        assert bool((got[day] == 0).all())
    assert bool(torch.isfinite(got).all())


def test_predict_panel_on_the_card_matches_the_cpu(dev):
    from factorvae_tpu_torch import config
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.eval.predict import predict_panel
    from factorvae_tpu_torch.models.factorvae import load_model

    cfg = config.Config(model=config.ModelConfig(
        num_features=12, hidden_size=8, num_factors=4, num_portfolios=10, seq_len=6))
    panel = synthetic_panel_dense(40, 13, 12, seed=1)
    scores = {}
    for d in ("cpu", dev):
        ds = PanelDataset(panel, seq_len=6, device=d)
        scores[str(d)] = predict_panel(load_model(cfg, device=d), cfg, ds,
                                       ds.split_days(None, None), stochastic=False)
    np.testing.assert_allclose(scores["cuda"], scores["cpu"], **TOL)


@pytest.mark.parametrize("n,t,h", [(304, 20, 64), (2432, 20, 64), (304, 60, 60),
                                   (72, 60, 8), (333, 7, 37), (5, 3, 4), (333, 7, 96),
                                   (304, 20, 256)])
def test_gru_bwd_kernel_matches_plain_and_repeats_bitwise(dev, n, t, h):
    rng = np.random.default_rng(n * t + h)
    xi, wh, bh, dh = _to(dev, (rng.normal(size=(n, t, 3 * h)) * 0.5).astype(np.float32),
                         (rng.normal(size=(h, 3 * h)) * _wh_scale(h)).astype(np.float32),
                         (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32),
                         rng.normal(size=(n, h)).astype(np.float32))
    before = gru_bwd.launches
    got = gru_bwd(xi, wh, bh, dh)
    assert gru_bwd.launches == before + 1
    want = gru_bwd_plain(xi, wh, bh, dh)
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close_sum(g, w)
    again = gru_bwd(xi, wh, bh, dh)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_gru_function_runs_k1_then_k2(dev):
    """With a gradient to take, the Function launches K1's residual variant
    and walks from its residuals: no serving-variant launch, one walk, one
    dWh kernel."""
    rng = np.random.default_rng(0)
    xi, wh, bh = (a.requires_grad_() for a in _to(
        dev, (rng.normal(size=(40, 6, 24)) * 0.5).astype(np.float32),
        (rng.normal(size=(8, 24)) * 0.3).astype(np.float32),
        (rng.normal(size=(24,)) * 0.1).astype(np.float32)))
    dh = torch.randn(40, 8, device=dev)
    counters = (gru_fwd, gru_fwd_residuals, gru_bwd, gru_dwh)
    before = [c.launches for c in counters]
    grads = torch.autograd.grad(gru(xi, wh, bh), (xi, wh, bh), dh)
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 1, 1, 1]
    for g, w in zip(grads, gru_bwd_plain(xi.detach(), wh.detach(), bh.detach(), dh)):
        _close_sum(g, w)


def test_backward_kernels_refuse_what_they_cannot_run(dev):
    with pytest.raises(ValueError, match="exceeds"):
        gru_bwd(torch.zeros(2, 3, 771, device=dev), torch.zeros(257, 771, device=dev),
                torch.zeros(771, device=dev), torch.zeros(2, 257, device=dev))
    with pytest.raises(ValueError, match="exceeds"):
        attention_bwd(torch.zeros(1, 4, 257, device=dev),
                      torch.ones(1, 4, dtype=torch.bool, device=dev),
                      torch.zeros(2, 257, device=dev), torch.zeros(2, 257, 257, device=dev),
                      torch.zeros(2, 257, device=dev), torch.zeros(2, 257, 257, device=dev),
                      torch.zeros(2, 257, device=dev), torch.zeros(1, 2, 257, device=dev))


@pytest.mark.parametrize("b,n,k,h", [(1, 304, 96, 64), (8, 304, 96, 64), (3, 10, 4, 8),
                                     (2, 800, 60, 60), (3, 70, 6, 37)])
@pytest.mark.parametrize("with_keep", [False, True], ids=["no_keep", "keep_mask"])
def test_attention_bwd_kernel_matches_plain_and_repeats_bitwise(dev, b, n, k, h, with_keep):
    rng = np.random.default_rng(b * n + h + 1)
    latent = rng.normal(size=(b, n, h)).astype(np.float32)
    mask = rng.random((b, n)) > 0.2
    if b > 1:
        mask[0] = False                               # an all-padding day
        latent[1, 3, 0] = np.nan                      # the guard zeroes day 1
        mask[1, 3] = True
    weights = [rng.normal(size=(k, h)).astype(np.float32)]
    for shape in ((k, h, h), (k, h), (k, h, h), (k, h)):
        weights.append((rng.normal(size=shape) / np.sqrt(h)).astype(np.float32))
    days = b
    if b > 1:                                         # +inf and -inf days b, b + 1
        latent, mask = _with_inf_days(rng, latent, mask, weights[0], weights[1])
        days = b + 2
    args = _to(dev, latent, mask, *weights,
               (rng.normal(size=(days, k, h)) * 0.1).astype(np.float32))
    keep = None
    if with_keep:
        keep = _to(dev, ((rng.random((days, k, n)) > 0.1) / 0.9).astype(np.float32))[0]
    before = attention_bwd.launches
    got = attention_bwd(*args, keep=keep)
    assert attention_bwd.launches == before + 1
    want = attention_bwd_plain(*args, keep=keep)
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close_sum(g, w)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    if b > 1:                                         # empty, NaN, +inf, -inf
        assert all(bool((got[0][day] == 0).all()) for day in (0, 1, b, b + 1))
    again = attention_bwd(*args, keep=keep)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


def test_attention_function_runs_k4_then_k5(dev):
    rng = np.random.default_rng(1)
    b, n, k, h = 2, 30, 5, 8
    latent, *weights = (a.requires_grad_() for a in _to(
        dev, rng.normal(size=(b, n, h)).astype(np.float32),
        rng.normal(size=(k, h)).astype(np.float32),
        (rng.normal(size=(k, h, h)) / 3).astype(np.float32),
        (rng.normal(size=(k, h)) / 3).astype(np.float32),
        (rng.normal(size=(k, h, h)) / 3).astype(np.float32),
        (rng.normal(size=(k, h)) / 3).astype(np.float32)))
    mask = torch.from_numpy(rng.random((b, n)) > 0.2).to(dev)
    dctx = torch.randn(b, k, h, device=dev)
    f0, b0 = attention_fwd.launches, attention_bwd.launches
    grads = torch.autograd.grad(attention(latent, mask, *weights), (latent, *weights), dctx)
    assert (attention_fwd.launches, attention_bwd.launches) == (f0 + 1, b0 + 1)
    want = attention_bwd_plain(latent.detach(), mask, *(w.detach() for w in weights), dctx)
    for g, w in zip(grads, want):
        _close_sum(g, w)


def test_trainer_on_the_card_tracks_the_cpu(dev, tmp_path):
    """Two epochs of a small deterministic run (dropout 0, NLL loss) from the
    same weights: per-epoch losses on the card within rtol 1e-4 of the CPU's."""
    import dataclasses

    from factorvae_tpu_torch import config
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.train.trainer import Trainer

    panel = synthetic_panel_dense(40, 13, 12, seed=1)
    dates = [str(d) for d in panel.dates]
    cfg = config.Config(
        model=config.ModelConfig(num_features=12, hidden_size=8, num_factors=4,
                                 num_portfolios=10, seq_len=6, dropout_rate=0.0,
                                 recon_loss="nll"),
        data=config.DataConfig(seq_len=6, start_time=dates[0], fit_end_time=dates[27],
                               val_start_time=dates[28], val_end_time=dates[39]),
        train=config.TrainConfig(num_epochs=2, days_per_step=4, lr=1e-3, seed=5,
                                 checkpoint_every=0))
    hist = {}
    for d in ("cpu", dev):
        c = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, save_dir=str(tmp_path / str(d))))
        _, out = Trainer(c, PanelDataset(panel, seq_len=6, device=d), device=d).fit()
        hist[str(d)] = [(r["train_loss"], r["val_loss"]) for r in out["history"]]
    np.testing.assert_allclose(hist["cuda"], hist["cpu"], rtol=1e-4)


# the last four take the kernels' H <= 128 and H <= 256 instances (K3's
# walk at T = 60 too)
GRU_SHAPES = [(304, 20, 64), (2432, 20, 64), (304, 60, 60), (333, 7, 37),
              (304, 20, 128), (304, 60, 128), (304, 20, 256), (2432, 20, 256)]
GRU_IDS = ["one_day", "eight_days", "T60_H60", "ragged_H37",
           "day_H128", "T60_H128", "day_H256", "eight_days_H256"]


def _gru_inputs(dev, n, t, h, seed):
    rng = np.random.default_rng(seed)
    return _to(dev, (rng.normal(size=(n, t, 3 * h)) * 0.5).astype(np.float32),
               (rng.normal(size=(h, 3 * h)) * _wh_scale(h)).astype(np.float32),
               (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32),
               rng.normal(size=(n, h)).astype(np.float32))


@pytest.mark.parametrize("n,t,h", GRU_SHAPES, ids=GRU_IDS)
def test_gru_residual_variant_matches_plain_and_repeats_bitwise(dev, n, t, h):
    xi, wh, bh, _ = _gru_inputs(dev, n, t, h, 11)
    before = gru_fwd_residuals.launches
    got = gru_fwd_residuals(xi, wh, bh)
    assert gru_fwd_residuals.launches == before + 1
    for g, w in zip(got, gru_fwd_plain(xi, wh, bh, keep_residuals=True)):
        _close(g, w)
    again = gru_fwd_residuals(xi, wh, bh)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[0], gru_fwd(xi, wh, bh))     # the serving variant's h


@pytest.mark.parametrize("n,t,h", GRU_SHAPES, ids=GRU_IDS)
def test_gru_walk_from_residuals_matches_plain_and_repeats_bitwise(dev, n, t, h):
    xi, wh, bh, dh = _gru_inputs(dev, n, t, h, 12)
    _, hseq, gseq = gru_fwd_residuals(xi, wh, bh)
    before = gru_bwd.launches
    got = gru_bwd(xi, wh, bh, dh, residuals=(hseq, gseq))
    assert gru_bwd.launches == before + 1
    want = gru_bwd_plain(xi, wh, bh, dh, residuals=(hseq, gseq))
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close_sum(g, w)
    again = gru_bwd(xi, wh, bh, dh, residuals=(hseq, gseq))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("n,t,h", GRU_SHAPES, ids=GRU_IDS)
def test_gru_dwh_kernel_matches_plain_and_repeats_bitwise(dev, n, t, h):
    xi, wh, bh, dh = _gru_inputs(dev, n, t, h, 13)
    _, hseq, gseq = gru_fwd_plain(xi, wh, bh, keep_residuals=True)
    dxi, dgn = gru_walk_plain(xi, wh, hseq, gseq, dh)
    before = gru_dwh.launches
    got = gru_dwh(hseq, dxi, dgn)
    assert gru_dwh.launches == before + 1
    for g, w in zip(got, gru_dwh_plain(hseq, dxi, dgn)):
        _close_sum(g, w)
    again = gru_dwh(hseq, dxi, dgn)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("shape", [(16, 1), (8, 1), (8, 2), (16, 4), (8, 4)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("n,t,h", [(304, 20, 64), (333, 7, 37)], ids=["one_day", "ragged_H37"])
def test_gru_cluster_path_matches_plain(dev, n, t, h, shape):
    """Every tile and cluster shape the kernels take computes the plain
    function, forward (both variants) and walk, and repeats bitwise."""
    xi, wh, bh, dh = _gru_inputs(dev, n, t, h, 14)
    fwd = gru_module._fwd_launch("gru_fwd", xi, wh, bh, False, shape)[0]
    _close(fwd, gru_fwd_plain(xi, wh, bh))
    assert torch.equal(fwd, gru_module._fwd_launch("gru_fwd", xi, wh, bh, False, shape)[0])
    res = gru_module._fwd_launch("gru_fwd_residuals", xi, wh, bh, True, shape)[:3]
    for g, w in zip(res, gru_fwd_plain(xi, wh, bh, keep_residuals=True)):
        _close(g, w)
    assert torch.equal(res[0], fwd)
    hseq, gseq = res[1:]
    got = gru_module._walk_launch(xi, wh, hseq, gseq, dh, shape)
    for g, w in zip(got, gru_walk_plain(xi, wh, hseq, gseq, dh)):
        _close(g, w)
    again = gru_module._walk_launch(xi, wh, hseq, gseq, dh, shape)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _k1_shape(h, shape):
    """K1's launch shape beside the walk's `shape`: the same, but that above
    H = 64 K1 has no 24-row tile (FWD_ROWS) and takes 16 rows there; a
    row's h depends on neither its tile nor its cluster."""
    rows, c = shape
    if h <= gru_module.MAX_UNITS or rows in gru_module.FWD_ROWS:
        return shape
    return (min(gru_module.FWD_ROWS), c)


@pytest.mark.parametrize("h,shape", [pytest.param(h, s, id=f"H{h}-{s[0]}x{s[1]}")
                                     for h in (65, 96, 128, 200, 256)
                                     for s in gru_module.walk_shapes(h)])
def test_gru_wide_cluster_path_matches_plain(dev, h, shape):
    """Above H = 64, every tile and cluster shape the wide walk takes
    (`walk_shapes`) computes the plain function, forward (both variants, at
    `_k1_shape`), the walk and dWh, and repeats bitwise."""
    xi, wh, bh, dh = _gru_inputs(dev, 333, 7, h, h + shape[1])
    k1 = _k1_shape(h, shape)
    fwd = gru_module._fwd_launch("gru_fwd", xi, wh, bh, False, k1)[0]
    _close(fwd, gru_fwd_plain(xi, wh, bh))
    res = gru_module._fwd_launch("gru_fwd_residuals", xi, wh, bh, True, k1)[:3]
    for g, w in zip(res, gru_fwd_plain(xi, wh, bh, keep_residuals=True)):
        _close(g, w)
    assert torch.equal(res[0], fwd)
    hseq, gseq = res[1:]
    got = gru_module._walk_launch(xi, wh, hseq, gseq, dh, shape)
    for g, w in zip(got, gru_walk_plain(xi, wh, hseq, gseq, dh)):
        _close(g, w)
    again = gru_module._walk_launch(xi, wh, hseq, gseq, dh, shape)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    dw = gru_dwh(hseq, *got)
    for g, w in zip(dw, gru_dwh_plain(hseq, *got)):
        _close_sum(g, w)


def test_gru_smem_bytes_is_the_libraries_layout(dev):
    """`gru.smem_bytes`, the copy of the recurrence kernels' shared memory
    layouts that the shared rule reads up to H = 64, equals the libraries'
    own at every hidden size, tile and cluster there; `gru.walk_smem_bytes`,
    the walk's copy, equals `gru_walk_smem_bytes` at every shape the walk
    takes up to H = 256 (the wide walk's layout above 64)."""
    from factorvae_tpu_torch.ops.kernels import MAX_HIDDEN

    fwd, bwd = gru_module._lib("gru_fwd"), gru_module._lib("gru_bwd")
    for h in range(1, gru_module.MAX_UNITS + 1):
        for c in (c for c in gru_module.CLUSTERS if c <= h):
            for rows in gru_module.TILE_ROWS:
                want = max(fwd.gru_fwd_smem_bytes(h, rows, c),
                           bwd.gru_walk_smem_bytes(h, rows, c))
                assert gru_module.smem_bytes(h, rows, c) == want, (h, rows, c)
    for h in range(gru_module.MAX_UNITS + 1, MAX_HIDDEN + 1):
        for c in (c for c in gru_module.CLUSTERS if 2 <= c <= h):
            for rows in gru_module.WALK_ROWS:
                assert gru_module.walk_smem_bytes(h, rows, c) == bwd.gru_walk_smem_bytes(
                    h, rows, c), (h, rows, c)


def test_gru_walk_layout_and_clusters_are_the_librarys(dev):
    """Above H = 64 the walk's rule weighs the card's own count of resident
    clusters (`gru_walk_clusters`, at most `walk_resident`'s), `_walk_shape`
    is `walk_launch_shape` given that count, the library refuses every
    shape outside `walk_shapes` (0 clusters) and takes every one inside it,
    and `fwd_clusters` gives its count of persistent clusters."""
    bwd = gru_module._lib("gru_bwd")
    index = torch.cuda.current_device()
    sms, smem = gru_module._card(index)

    def resident(h, rows, c):
        return bwd.gru_walk_clusters(1 << 20, h, rows, c, 1)

    for h in (65, 96, 128, 200, 256):
        shapes = gru_module.walk_shapes(h, smem)
        for c in gru_module.CLUSTERS:
            for rows in (8, 16, 24, 32, 64):
                taken = resident(h, rows, c)
                assert (taken > 0) == ((rows, c) in shapes), (h, rows, c)
                if taken:
                    assert taken <= gru_module.walk_resident(h, rows, c, sms, smem)
                    assert gru_module._walk_resident(index, h, rows, c) == taken
        for n in (1, 304, 2432, 9728):
            for lanes in (1, 2, 3, 40):
                xi = torch.empty(1, device=dev).expand(lanes, n, 1, 3 * h)
                rows, c = gru_module._walk_shape(xi)
                assert (rows, c) in shapes
                assert (rows, c) == gru_module.walk_launch_shape(
                    n, h, sms, lanes, smem, lambda r, c, h=h: resident(h, r, c))
                assert bwd.gru_walk_clusters(n, h, rows, c, lanes) == gru_module.fwd_clusters(
                    -(-n // rows), lanes, resident(h, rows, c))
    assert bwd.gru_walk_clusters(304, 64, 16, 4, 1) == 0     # up to 64: no wide walk


WIDE_WALK_H = (65, 96, 128, 200, 256)


@pytest.mark.parametrize("t", [1, 20, 60])
@pytest.mark.parametrize("h", WIDE_WALK_H)
def test_gru_wide_walk_matches_plain_at_every_tile(dev, h, t):
    """Above H = 64 the walk is the persistent wide kernel. Launched at every
    shape it takes (`walk_shapes`: each tile of WALK_ROWS at each cluster,
    the units split unevenly at H = 65 and 200), it computes the plain
    walk; at the rule's cluster every tile is bitwise the rule's pick (a
    row's result depends on neither its tile nor the clusters that ran it),
    and the wrapper's launch repeats bitwise."""
    xi, wh, bh, dh = _gru_inputs(dev, 333, t, h, h + t)
    _, hseq, gseq = gru_fwd_residuals(xi, wh, bh)
    want = gru_walk_plain(xi, wh, hseq, gseq, dh)
    picked = gru_module._walk_shape(xi)
    before = gru_bwd.launches
    got = gru_bwd(xi, wh, bh, dh, residuals=(hseq, gseq))
    assert gru_bwd.launches == before + 1
    ref = gru_module._walk_launch(xi, wh, hseq, gseq, dh, picked)
    assert torch.equal(got[0], ref[0])
    assert all(torch.equal(a, b) for a, b in zip(
        gru_bwd(xi, wh, bh, dh, residuals=(hseq, gseq)), got))
    for shape in gru_module.walk_shapes(h):
        walk = gru_module._walk_launch(xi, wh, hseq, gseq, dh, shape)
        for g, w in zip(walk, want):
            _close(g, w)
        if shape[1] == picked[1]:
            assert all(torch.equal(a, b) for a, b in zip(walk, ref)), shape


@pytest.mark.parametrize("n", [5, 304])
@pytest.mark.parametrize("h", [96, 256])
def test_gru_wide_walk_lanes_are_each_lane_alone(dev, h, n):
    """Three lanes in one launch of the wide walk at the rule's shape for
    three lanes: the lane-axis plain values, and each lane bitwise its
    one-lane launch at the rule's shape for one lane; dWh of the three
    lanes likewise."""
    from factorvae_tpu_torch.ops.kernels import per_lane

    rng = np.random.default_rng(n + h + 1)
    xi, wh, bh, dh = _to(dev, (rng.normal(size=(3, n, 20, 3 * h)) * 0.5).astype(np.float32),
                         (rng.normal(size=(3, h, 3 * h)) * _wh_scale(h)).astype(np.float32),
                         (rng.normal(size=(3, 3 * h)) * 0.1).astype(np.float32),
                         rng.normal(size=(3, n, h)).astype(np.float32))
    _, hseq, gseq = gru_fwd_residuals(xi, wh, bh)
    three = gru_module._walk_launch(xi, wh, hseq, gseq, dh, gru_module._walk_shape(xi))
    for g, w in zip(three, per_lane(gru_walk_plain, xi, wh, hseq, gseq, dh)):
        _close(g, w)
    dw3 = gru_dwh(hseq, *three)
    for s in range(3):
        one = gru_module._walk_launch(xi[s], wh[s], hseq[s], gseq[s], dh[s],
                                      gru_module._walk_shape(xi[s]))
        assert all(torch.equal(a, b[s]) for a, b in zip(one, three)), s
        assert all(torch.equal(a, b[s]) for a, b in zip(gru_dwh(hseq[s], *one), dw3)), s


@pytest.mark.parametrize("h", [128, 256])
def test_gru_wide_walk_carries_nan_as_plain(dev, h):
    """A NaN made on the device (0 * inf, 0x7fffffff) in one element of Wh,
    of dh or of a residual (g, h_prev) comes out of the wide walk where it
    comes out of the plain version, every other value within the tolerance;
    a NaN in hseq reaches dWh's row where the plain dWh has it."""
    xi, wh, bh, dh = _gru_inputs(dev, 304, 8, h, h + 3)
    _, hseq, gseq = gru_fwd_residuals(xi, wh, bh)
    nan = torch.zeros((), device=dev) * torch.full((), float("inf"), device=dev)
    assert int(nan.view(torch.int32)) == 0x7FFFFFFF
    for where in ("wh", "dh", "gseq", "hseq"):
        a = {"wh": wh.clone(), "dh": dh.clone(), "gseq": gseq.clone(), "hseq": hseq.clone()}
        index = {"wh": (3, 5), "dh": (7, 2), "gseq": (9, 4, 2 * h + 1), "hseq": (11, 5, 6)}
        a[where][index[where]] = nan
        shape = gru_module._walk_shape(xi)
        got = gru_module._walk_launch(xi, a["wh"], a["hseq"], a["gseq"], a["dh"], shape)
        want = gru_walk_plain(xi, a["wh"], a["hseq"], a["gseq"], a["dh"])
        for g, w in zip(got, want):
            assert torch.equal(g.isnan(), w.isnan()), where
            assert bool(w.isnan().any()), where
            _close(g.nan_to_num(), w.nan_to_num())
    bad = hseq.clone()
    bad[11, 5, 6] = nan
    dxi, dgn = gru_walk_plain(xi, wh, hseq, gseq, dh)
    got, want = gru_dwh(bad, dxi, dgn), gru_dwh_plain(bad, dxi, dgn)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
    assert got[0][6].isnan().all() and not got[0][:6].isnan().any()


@pytest.mark.parametrize("n,t,h", [(333, 7, 65), (304, 20, 96), (37, 5, 200), (304, 60, 256),
                                   (2432, 20, 128)],
                         ids=["ragged_H65", "day_H96", "short_H200", "T60_H256",
                              "eight_days_H128"])
def test_gru_wide_dwh_matches_plain_and_repeats_bitwise(dev, n, t, h):
    """dWh and db above H = 64 on the tensor cores: the plain values (N*T
    rows not a multiple of the 32 staged a pass, H not a multiple of its 64
    x 192 tile), bitwise on a repeat, and two lanes each bitwise its
    one-lane launch."""
    rng = np.random.default_rng(n + t + h)
    hseq, dxi, dgn = _to(dev, rng.normal(size=(2, n, t, h)).astype(np.float32),
                         (rng.normal(size=(2, n, t, 3 * h)) * 0.1).astype(np.float32),
                         (rng.normal(size=(2, n, t, h)) * 0.1).astype(np.float32))
    before = gru_dwh.launches
    got = gru_dwh(hseq[0], dxi[0], dgn[0])
    assert gru_dwh.launches == before + 1
    for g, w in zip(got, gru_dwh_plain(hseq[0], dxi[0], dgn[0])):
        _close_sum(g, w)
    assert all(torch.equal(a, b) for a, b in zip(gru_dwh(hseq[0], dxi[0], dgn[0]), got))
    two = gru_dwh(hseq, dxi, dgn)
    assert all(torch.equal(a[0], b) for a, b in zip(two, got))
    one = gru_dwh(hseq[1], dxi[1], dgn[1])
    assert all(torch.equal(a[1], b) for a, b in zip(two, one))


def test_gru_fwd_layout_and_clusters_are_the_librarys(dev):
    """The forward's own rule reads `gru.fwd_smem_bytes`, a copy of K1's
    layout: it equals the library's `gru_fwd_smem_bytes` at every hidden
    size, cluster and tile K1 takes (FWD_ROWS above H = 64). Above H = 64
    the rule weighs the card's own count of resident clusters
    (`gru_fwd_clusters`, at most `fwd_resident`'s), and `fwd_clusters`
    gives the library's count of persistent clusters for its shapes."""
    from factorvae_tpu_torch.ops.kernels import MAX_HIDDEN

    fwd = gru_module._lib("gru_fwd")
    for h in range(1, MAX_HIDDEN + 1):
        for c in (c for c in gru_module.CLUSTERS if c <= h):
            for rows in (8, 16) if h <= 64 else gru_module.FWD_ROWS:
                assert gru_module.fwd_smem_bytes(h, rows, c) == fwd.gru_fwd_smem_bytes(
                    h, rows, c), (h, rows, c)
    index = torch.cuda.current_device()
    sms, smem = gru_module._card(index)

    def resident(h, rows, c):
        return fwd.gru_fwd_clusters(1 << 20, h, rows, c, 1)

    for h in (65, 128, 256):
        for n in (1, 304, 9728):
            for lanes in (1, 2, 3, 40):
                xi = torch.empty(1, device=dev).expand(lanes, n, 1, 3 * h)
                rows, c = gru_module._fwd_shape(xi)
                assert (rows, c) == gru_module.fwd_launch_shape(
                    n, h, sms, lanes, smem, lambda r, c, h=h: resident(h, r, c))
                for r in gru_module.FWD_ROWS:
                    assert 1 <= gru_module._resident(index, h, r, c) == resident(h, r, c)
                    assert resident(h, r, c) <= gru_module.fwd_resident(h, r, c, sms, smem)
                got = fwd.gru_fwd_clusters(n, h, rows, c, lanes)
                assert got == gru_module.fwd_clusters(-(-n // rows), lanes,
                                                      resident(h, rows, c))


@pytest.mark.parametrize("h", [128, 256])
def test_gru_wide_forward_carries_nan_as_plain(dev, h):
    """A NaN made on the device (0 * inf: 0x7fffffff, whose payload would
    carry into the sign bit of a rounded TF32 split) reaches K1's product
    as it reaches the plain version's. In one element of Wh: every unit of
    every row's last h is NaN in both variants, as in the plain version.
    In part of one row's xi at one step: both variants' h, hseq and gseq
    are NaN where the plain version's are (that row's units at that step,
    all of its g and h from the next), every other row finite and within
    the tolerance. (With h = 0 the kernels skip step 0's product, where the
    plain version's 0 . NaN is NaN, so Wh's case is held at the last h.)"""
    xi, wh, bh, _ = _gru_inputs(dev, 304, 8, h, h)
    nan = torch.zeros((), device=dev) * torch.full((), float("inf"), device=dev)
    assert int(nan.view(torch.int32)) == 0x7FFFFFFF
    bad_wh = wh.clone()
    bad_wh[3, 5] = nan
    assert bool(gru_fwd_plain(xi, bad_wh, bh).isnan().all())
    assert bool(gru_fwd(xi, bad_wh, bh).isnan().all())
    assert bool(gru_fwd_residuals(xi, bad_wh, bh)[0].isnan().all())
    bad_xi = xi.clone()
    bad_xi[2, 4, : h // 2] = nan
    want = gru_fwd_plain(bad_xi, wh, bh, keep_residuals=True)
    got = gru_fwd_residuals(bad_xi, wh, bh)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        _close(g, w)
    assert bool(want[2][2, 5].isnan().all())
    served = gru_fwd(bad_xi, wh, bh)
    assert torch.equal(served.isnan(), want[0].isnan())
    assert torch.equal(served.nan_to_num(), got[0].nan_to_num())
    assert want[0].isnan().any(dim=1).nonzero().flatten().tolist() == [2]


@pytest.mark.parametrize("n", [1, 5, 304, 9728])
@pytest.mark.parametrize("h", [65, 96, 128, 192, 256])
def test_gru_wide_forward_matches_plain_at_every_tile(dev, h, n):
    """Above H = 64 K1 is the persistent wide kernel. Through the wrappers
    (the forward's own rule) both variants compute the plain function, their
    h bitwise equal and bitwise on a repeat; launched with every row tile
    at the rule's cluster, h is bitwise the wrappers' (a row's result does
    not depend on its tile or on the cluster that ran it)."""
    xi, wh, bh, _ = _gru_inputs(dev, n, 20, h, h + n)
    before = gru_fwd.launches, gru_fwd_residuals.launches
    got = gru_fwd(xi, wh, bh)
    res = gru_fwd_residuals(xi, wh, bh)
    assert (gru_fwd.launches, gru_fwd_residuals.launches) == (before[0] + 1, before[1] + 1)
    _close(got, gru_fwd_plain(xi, wh, bh))
    for g, w in zip(res, gru_fwd_plain(xi, wh, bh, keep_residuals=True)):
        _close(g, w)
    assert torch.equal(res[0], got)
    assert torch.equal(gru_fwd(xi, wh, bh), got)
    rows, cluster = gru_module._fwd_shape(xi)
    assert rows in gru_module.FWD_ROWS
    for tile in gru_module.FWD_ROWS:
        assert torch.equal(
            gru_module._fwd_launch("gru_fwd", xi, wh, bh, False, (tile, cluster))[0], got), tile


@pytest.mark.parametrize("n", [5, 304])
@pytest.mark.parametrize("h", [96, 256])
def test_gru_wide_forward_lanes_are_each_lane_alone(dev, h, n):
    """Three lanes in one launch of the wide forward, each variant at the
    rule's shape for three lanes: the lane-axis plain values, and each lane
    bitwise the one-lane launch at the rule's shape for one lane (another
    tile at one day: a row's result does not depend on it)."""
    from factorvae_tpu_torch.ops.kernels import per_lane

    rng = np.random.default_rng(n + h)
    xi, wh, bh = _to(dev, (rng.normal(size=(3, n, 20, 3 * h)) * 0.5).astype(np.float32),
                     (rng.normal(size=(3, h, 3 * h)) * _wh_scale(h)).astype(np.float32),
                     (rng.normal(size=(3, 3 * h)) * 0.1).astype(np.float32))
    h3 = gru_fwd(xi, wh, bh)
    r3 = gru_fwd_residuals(xi, wh, bh)
    _close(h3, per_lane(gru_fwd_plain, xi, wh, bh))
    assert torch.equal(r3[0], h3)
    for s in range(3):
        one = gru_fwd_residuals(xi[s], wh[s], bh[s])
        assert all(torch.equal(a, b[s]) for a, b in zip(one, r3)), s
        assert torch.equal(gru_fwd(xi[s], wh[s], bh[s]), h3[s]), s


F64_DRIFT_MULTIPLE = 4


def test_gru_wide_chaotic_recurrence_tracks_f64_as_plain_f32_does(dev):
    """At H = 256 with Wh at 0.3, the scale of the cases up to H = 64, the
    recurrence is chaotic and float32 itself drifts from float64 past the
    tolerances above (scripts/torch_gru_drift.py). There the kernels' h,
    dxi, dWh and db, each against the plain version in float64, stay within
    F64_DRIFT_MULTIPLE times the plain version's own float32 error (h and
    dxi absolute, dWh and db over max(1, max |f64|))."""
    n, t, h = 304, 20, 256
    rng = np.random.default_rng(11)
    f32 = _to(dev, (rng.normal(size=(n, t, 3 * h)) * 0.5).astype(np.float32),
              (rng.normal(size=(h, 3 * h)) * 0.3).astype(np.float32),
              (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32),
              rng.normal(size=(n, h)).astype(np.float32))
    f64 = [a.double() for a in f32]
    before = gru_fwd.launches, gru_bwd.launches
    kernel = [gru_fwd(*f32[:3]), *gru_bwd(*f32)]
    assert (gru_fwd.launches, gru_bwd.launches) == (before[0] + 1, before[1] + 1)
    plain = [gru_fwd_plain(*f32[:3]), *gru_bwd_plain(*f32)]
    want = [gru_fwd_plain(*f64[:3]), *gru_bwd_plain(*f64)]

    def errors(got):
        return [float((g.double() - w).abs().max()) / (max(1.0, float(w.abs().max()))
                                                        if i > 1 else 1.0)
                for i, (g, w) in enumerate(zip(got, want))]

    k_err, p_err = errors(kernel), errors(plain)
    assert all(k <= F64_DRIFT_MULTIPLE * p + 1e-7 for k, p in zip(k_err, p_err)), (
        k_err, p_err)


def test_gru_rule_fills_the_card_at_one_day(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, cluster = launch_shape(304, 64, sms)
    assert -(-304 // rows) * cluster >= sms
    assert gru_module._shape(torch.empty(304, 1, 192, device=dev)) == (rows, cluster)


def test_training_step_launches_the_residual_variant_and_scoring_does_not(dev):
    from factorvae_tpu_torch import config
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.eval.predict import predict_panel
    from factorvae_tpu_torch.train.loop import train_step
    from factorvae_tpu_torch.train.trainer import Trainer

    panel = synthetic_panel_dense(40, 13, 12, seed=1)
    dates = [str(d) for d in panel.dates]
    cfg = config.Config(
        model=config.ModelConfig(num_features=12, hidden_size=8, num_factors=4,
                                 num_portfolios=10, seq_len=6),
        data=config.DataConfig(seq_len=6, start_time=dates[0], fit_end_time=dates[27],
                               val_start_time=dates[28], val_end_time=dates[39]),
        train=config.TrainConfig(num_epochs=1, days_per_step=1, checkpoint_every=0))
    ds = PanelDataset(panel, seq_len=6, device=dev)
    trainer = Trainer(cfg, ds, device=dev)
    state = trainer.init_state()
    counters = (gru_fwd, gru_fwd_residuals, gru_bwd, gru_dwh)

    before = [c.launches for c in counters]
    train_step(state, ds, trainer._order(trainer.train_days, True, 0)[0], guard=True)
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 1, 1, 1]

    before = [c.launches for c in counters]
    predict_panel(state.model, cfg, ds, ds.split_days(dates[30], dates[31]),
                  stochastic=False)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 0, 0, 0]


def _attention_case(dev, b, n, k, h, seed, poison):
    """Inputs of one attention case with a keep-mask and a cotangent; with
    `poison` (b >= 5), day 0 all padding, day 1 a NaN row and days 3 and 4
    +inf / -inf rows built as in `_with_inf_days`. Returns (args, keep,
    dctx, the days that must take the exact path)."""
    rng = np.random.default_rng(seed)
    latent = rng.normal(size=(b, n, h)).astype(np.float32)
    mask = rng.random((b, n)) > 0.2
    weights = [rng.normal(size=(k, h)).astype(np.float32)]
    for shape in ((k, h, h), (k, h), (k, h, h), (k, h)):
        weights.append((rng.normal(size=shape) / np.sqrt(h)).astype(np.float32))
    flagged = []
    if poison:
        mask[0] = False
        latent[1, 3, 0] = np.nan
        mask[1, 3] = True
        inf_lat, inf_mask = _with_inf_days(rng, latent[3:5], mask[3:5], weights[0],
                                           weights[1])
        latent[3:5], mask[3:5] = inf_lat[2:], inf_mask[2:]
        flagged = [1, 3, 4]
    keep = ((rng.random((b, k, n)) > 0.1) / 0.9).astype(np.float32)
    dctx = (rng.normal(size=(b, k, h)) * 0.1).astype(np.float32)
    args = _to(dev, latent, mask, *weights)
    keep_t, dctx_t = _to(dev, keep, dctx)
    return args, keep_t, dctx_t, flagged


# the wide ones take the H <= 128 and H <= 256 instances, whose exact path
# streams Wk and Wv through shared memory
ATT_SHAPES = [(1, 304, 96, 64), (6, 304, 96, 64), (5, 70, 6, 37), (1, 3000, 8, 64),
              *((6, 70, 6, h) for h in (65, 96, 128, 200, 256)),
              (1, 304, 96, 128), (1, 304, 96, 256)]
ATT_IDS = ["one_day", "six_days_poisoned", "H37_poisoned", "N3000_rows_unstaged",
           *(f"H{h}_poisoned" for h in (65, 96, 128, 200, 256)), "one_day_H128",
           "one_day_H256"]


@pytest.mark.parametrize("b,n,k,h,group", [
    pytest.param(*shape, g, id=f"{name}-G{g}") for shape, name in zip(ATT_SHAPES, ATT_IDS)
    for g in GROUPS if g * shape[1] <= MAX_GROUP_ROWS])
def test_attention_group_path_matches_plain(dev, b, n, k, h, group):
    """Every heads-per-CTA size the rule can pick computes the plain
    function, forward and backward, with and without the keep-mask; the
    backward repeats bitwise; exactly the poisoned days take the exact
    path, and they and the empty day get zero."""
    args, keep, dctx, flagged = _attention_case(dev, b, n, k, h, b * n + h + group, b >= 5)
    for kp in (None, keep):
        got, days, _ = attention_module._fwd_launch(*args, kp, group, exact=True)
        _close(got, attention_fwd_plain(*args, keep=kp))
        assert [d for d in range(b) if days[d]] == flagged
        grads, days, _ = attention_module._bwd_launch(*args, dctx, kp, group, exact=True)
        want = attention_bwd_plain(*args, dctx, keep=kp)
        _close(grads[0], want[0])
        for g, w in zip(grads[1:], want[1:]):
            _close_sum(g, w)
        assert [d for d in range(b) if days[d]] == flagged
        again, _, _ = attention_module._bwd_launch(*args, dctx, kp, group)
        assert all(torch.equal(x, y) for x, y in zip(grads, again))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        for d in ([0] + flagged if flagged else []):
            assert bool((got[d] == 0).all()) and bool((grads[0][d] == 0).all())


@pytest.mark.parametrize("poison", [False, True], ids=["fold", "exact"])
def test_attention_takes_5000_rows_at_h256(dev, poison):
    """5,000 valid rows a day at H = 256 through the wrappers, forward and
    backward: on the fold path, and with a NaN day and +inf / -inf days on
    the exact path (the day of padding beside them)."""
    b = 5 if poison else 1
    args, keep, dctx, flagged = _attention_case(dev, b, 5200, 4, 256, 17, poison)
    args[1][:, :5000] = True
    if poison:
        args[1][0] = False
    before = attention_fwd.launches, attention_bwd.launches
    got = attention_fwd(*args, keep=keep)
    _close(got, attention_fwd_plain(*args, keep=keep))
    grads = attention_bwd(*args, dctx, keep=keep)
    want = attention_bwd_plain(*args, dctx, keep=keep)
    _close(grads[0], want[0])
    for g, w in zip(grads[1:], want[1:]):
        _close_sum(g, w)
    assert (attention_fwd.launches, attention_bwd.launches) == (before[0] + 1,
                                                                before[1] + 1)
    _, days, _ = attention_module._fwd_launch(*args, keep, 1, exact=True)
    assert [d for d in range(b) if days[d]] == flagged


def test_attention_rule_fills_the_card(dev):
    """At one flagship day the rule takes one head per CTA, the widest grid
    the heads give (96 CTAs); at 8 days and at a 32-day serving chunk it
    groups heads, and its grid still has a CTA for every head of a day (96
    on a card of 132 SMs), or for every SM on a card with fewer."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert launch_group(1, 96, 304, sms) == 1
    for b in (8, 32):
        g = launch_group(b, 96, 304, sms)
        assert g > 1 and b * -(-96 // g) >= min(96, sms)
    latent = torch.empty(32, 304, 64, device=dev)
    assert attention_module._group(latent, 96) == launch_group(32, 96, 304, sms)


@pytest.mark.parametrize("b,n,k,h", [(1, 304, 96, 256), (8, 304, 96, 128), (3, 304, 12, 200),
                                     (2, 70, 6, 96), (2, 70, 6, 65)],
                         ids=["one_day_H256", "8_days_H128", "H200", "H96", "H65"])
def test_wide_attention_is_bitwise_across_group_sizes(dev, b, n, k, h):
    """Above H = 64 no sum depends on the heads per cluster: K4's context and
    K5's six gradients are bitwise equal at every group size of GROUPS the
    layout takes, with and without the keep-mask, and a repeated launch of
    each gives the same bits; the values are the plain version's."""
    args, keep, dctx, _ = _attention_case(dev, b, n, k, h, b + n + k + h, False)
    sizes = [g for g in GROUPS if g * n <= MAX_GROUP_ROWS]
    for kp in (None, keep):
        ctx = [attention_module._fwd_launch(*args, kp, g)[0] for g in sizes]
        grads = [attention_module._bwd_launch(*args, dctx, kp, g)[0] for g in sizes]
        _close(ctx[0], attention_fwd_plain(*args, keep=kp))
        want = attention_bwd_plain(*args, dctx, keep=kp)
        _close(grads[0][0], want[0])
        for got, w in zip(grads[0][1:], want[1:]):
            _close_sum(got, w)
        again = attention_module._fwd_launch(*args, kp, sizes[0])[0]
        assert all(torch.equal(c, ctx[0]) for c in ctx[1:] + [again])
        assert all(torch.equal(x, y) for g in grads[1:] for x, y in zip(g, grads[0]))


def test_wide_attention_rule_gives_more_ctas_than_heads(dev):
    """At one flagship day the wide rule's grid has more CTAs than the 96
    heads (clusters of `wide_cluster(h)` CTAs), and `_group` is the rule
    on the card's SM count."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for h in (128, 256):
        g = attention_module.wide_launch_group(1, 96, 304, h, sms)
        assert -(-96 // g) * attention_module.wide_cluster(h) > 96
        latent = torch.empty(1, 304, h, device=dev)
        assert attention_module._group(latent, 96) == g


# ---------------------------------------------------------------------------
# the precision ladder on the card


def test_max_hidden_is_every_librarys_kmaxh(dev):
    from factorvae_tpu_torch.ops.kernels import MAX_HIDDEN

    for mod, name in ((gru_module, "gru_fwd"), (gru_module, "gru_bwd"),
                      (attention_module, "attention_fwd"),
                      (attention_module, "attention_bwd")):
        assert getattr(mod._lib(name), f"{name}_max_hidden")() == MAX_HIDDEN, name


def test_bf16_inputs_run_the_kernels_upcast(dev):
    """A bf16 input reaches the kernel as its f32 upcast: bitwise the f32
    call on the upcast values, and f32 out."""
    rng = np.random.default_rng(5)
    xi, wh, bh = _to(dev, rng.normal(size=(304, 20, 192)).astype(np.float32) * 0.5,
                     (rng.normal(size=(64, 192)) / 8).astype(np.float32),
                     (rng.normal(size=192) / 8).astype(np.float32))
    lo = [t.to(torch.bfloat16) for t in (xi, wh, bh)]
    got = gru_fwd(*lo)
    assert got.dtype == torch.float32
    assert torch.equal(got, gru_fwd(*[t.float() for t in lo]))
    args, keep, _, _ = _attention_case(dev, 2, 304, 96, 64, seed=6, poison=False)
    lat, mask, *w = args
    w16 = [t.to(torch.bfloat16) for t in w]
    assert torch.equal(attention_fwd(lat, mask, *w16, keep),
                       attention_fwd(lat, mask, *[t.float() for t in w16], keep))


def test_mixed_step_on_the_card(dev):
    """One mixed step on the card: the kernels launch, the masters stay f32
    and the kernels' weight gradients reach them unrounded."""
    from factorvae_tpu_torch import config
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.train.loop import train_step
    from factorvae_tpu_torch.train.trainer import Trainer

    panel = synthetic_panel_dense(40, 13, 12, seed=1)
    dates = [str(d) for d in panel.dates]
    cfg = config.Config(
        model=config.ModelConfig(num_features=12, hidden_size=8, num_factors=4,
                                 num_portfolios=10, seq_len=6, compute_dtype="bfloat16"),
        data=config.DataConfig(seq_len=6, start_time=dates[0], fit_end_time=dates[27],
                               val_start_time=dates[28], val_end_time=dates[39]),
        train=config.TrainConfig(num_epochs=1, checkpoint_every=0))
    ds = PanelDataset(panel, seq_len=6, device=dev)
    trainer = Trainer(cfg, ds, device=dev)
    state = trainer.init_state()
    counters = (gru_fwd_residuals, gru_bwd, attention_fwd, attention_bwd)
    before = [c.launches for c in counters]
    aux = train_step(state, ds, trainer._order(trainer.train_days, True, 0)[0], guard=True,
                     compute_dtype=torch.bfloat16, loss_scale_cfg=trainer.loss_scale_cfg)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 1]
    assert float(aux["skipped"]) == 0.0 and aux["loss_scale"] == 32768.0
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    g = state.model.feature_extractor.gru.hidden_kernel.grad
    assert not torch.equal(g, g.to(torch.bfloat16).float())


def test_entry_points_refuse_a_hidden_size_above_the_kernels(dev):
    from factorvae_tpu_torch import config
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.models.factorvae import FactorVAE
    from factorvae_tpu_torch.serve.registry import ModelRegistry, RegistryError
    from factorvae_tpu_torch.train.trainer import Trainer

    cfg = config.Config(model=config.ModelConfig(num_features=12, hidden_size=257,
                                                 num_factors=4, num_portfolios=10,
                                                 seq_len=6),
                        data=config.DataConfig(seq_len=6))
    ds = PanelDataset(synthetic_panel_dense(20, 13, 12, seed=1), seq_len=6, device=dev)
    with pytest.raises(ValueError, match="Limits"):
        Trainer(cfg, ds, device=dev)
    with pytest.raises(RegistryError, match="Limits"):
        ModelRegistry(device=dev).admit(FactorVAE(cfg.model), cfg)


@pytest.mark.parametrize("n,t,h,shape", [(304, 20, 64, (8, 1)), (37, 30, 8, (16, 2)),
                                         (40, 6, 12, (8, 4)), (304, 9, 96, (16, 4)),
                                         (304, 9, 256, (32, 8))],
                         ids=["one_day", "T30_cluster2", "ragged_cluster4", "H96_cluster4",
                              "H256_cluster8"])
def test_gru_lane_axis_is_each_lane_alone(dev, n, t, h, shape):
    """Three lanes of three weight sets in one launch of each GRU kernel:
    the lane-axis plain version's values, and each lane bitwise the
    one-lane launch of the same launch shape (K1's at `_k1_shape`)."""
    from factorvae_tpu_torch.ops.kernels import per_lane

    rng = np.random.default_rng(n * t + h)
    xi, wh, bh, dh = _to(dev, (rng.normal(size=(3, n, t, 3 * h)) * 0.5).astype(np.float32),
                         (rng.normal(size=(3, h, 3 * h)) * _wh_scale(h)).astype(np.float32),
                         (rng.normal(size=(3, 3 * h)) * 0.1).astype(np.float32),
                         rng.normal(size=(3, n, h)).astype(np.float32))
    h3, hseq, gseq, _ = gru_module._fwd_launch("gru_fwd", xi, wh, bh, True, _k1_shape(h, shape))
    _close(h3, per_lane(gru_fwd_plain, xi, wh, bh))
    dxi, dgn = gru_module._walk_launch(xi, wh, hseq, gseq, dh, shape)
    dwh, db = gru_dwh(hseq, dxi, dgn)
    want = per_lane(lambda *a: gru_bwd_plain(*a[:4], residuals=a[4:]), xi, wh, bh, dh,
                    hseq, gseq)
    _close(dxi, want[0])
    for s in range(3):
        _close_sum(dwh[s], want[1][s])
        one = gru_module._fwd_launch("gru_fwd", xi[s], wh[s], bh[s], True,
                                     _k1_shape(h, shape))
        assert all(torch.equal(a, b[s]) for a, b in zip(one[:3], (h3, hseq, gseq)))
        walk = gru_module._walk_launch(xi[s], wh[s], hseq[s], gseq[s], dh[s], shape)
        assert torch.equal(walk[0], dxi[s]) and torch.equal(walk[1], dgn[s])
        one_dwh = gru_dwh(hseq[s], dxi[s], dgn[s])
        assert torch.equal(one_dwh[0], dwh[s]) and torch.equal(one_dwh[1], db[s])


@pytest.mark.parametrize("b,n,k,h,group", [(1, 304, 96, 64, 4), (2, 10, 6, 8, 2),
                                           (3, 33, 5, 37, 1), (2, 70, 6, 256, 2)],
                         ids=["one_day_G4", "small_G2", "ragged_H37", "H256_G2"])
def test_attention_lane_axis_is_each_lane_alone(dev, b, n, k, h, group):
    """Three lanes with their own days and weights in one launch of K4 and
    of K5: the lane-axis plain version's values, each lane bitwise the
    one-lane launch of the same heads per CTA, and a NaN latent row in lane
    1 taking the exact path there alone and changing no bit elsewhere."""
    from factorvae_tpu_torch.ops.kernels import per_lane

    rng = np.random.default_rng(b * n + k + h)
    lat = rng.normal(size=(3, b, n, h)).astype(np.float32)
    mask = rng.random((3, b, n)) > 0.2
    q = rng.normal(size=(3, k, h)).astype(np.float32)
    ws = [(rng.normal(size=(3, k, h, h)) / np.sqrt(h)).astype(np.float32),
          (rng.normal(size=(3, k, h)) * 0.1).astype(np.float32),
          (rng.normal(size=(3, k, h, h)) / np.sqrt(h)).astype(np.float32),
          (rng.normal(size=(3, k, h)) * 0.1).astype(np.float32)]
    keep = ((rng.random((3, b, k, n)) > 0.2) / 0.8).astype(np.float32)
    dctx = rng.normal(size=(3, b, k, h)).astype(np.float32)
    lat, mask, q, wk, bk, wv, bv, keep, dctx = _to(dev, lat, mask, q, *ws, keep, dctx)
    weights = (q, wk, bk, wv, bv)
    ctx, _, _ = attention_module._fwd_launch(lat, mask, *weights, keep, group)
    grads, _, _ = attention_module._bwd_launch(lat, mask, *weights, dctx, keep, group)
    _close(ctx, per_lane(attention_fwd_plain, lat, mask, *weights, keep))
    want = per_lane(attention_bwd_plain, lat, mask, *weights, dctx, keep)
    _close(grads[0], want[0])
    for s in range(3):
        for g, w in zip(grads[1:], want[1:]):
            _close_sum(g[s], w[s])
        lane = (lat[s], mask[s], *(w[s] for w in weights))
        one = attention_module._fwd_launch(*lane, keep[s], group)[0]
        one_g = attention_module._bwd_launch(*lane, dctx[s], keep[s], group)[0]
        assert torch.equal(one, ctx[s]) and all(torch.equal(a, g[s])
                                                for a, g in zip(one_g, grads))
    lat_p, mask_p = lat.clone(), mask.clone()
    lat_p[1, 0, 3, 0] = float("nan")
    mask_p[1, 0, 3] = True
    ctx_p, days, _ = attention_module._fwd_launch(lat_p, mask_p, *weights, keep, group,
                                                  exact=True)
    grads_p, days_b, _ = attention_module._bwd_launch(lat_p, mask_p, *weights, dctx, keep,
                                                      group, exact=True)
    assert days.nonzero().tolist() == days_b.nonzero().tolist() == [[1, 0]]
    for s in (0, 2):
        assert torch.equal(ctx_p[s], ctx[s])
        assert all(torch.equal(a[s], g[s]) for a, g in zip(grads_p, grads))
    assert all(bool(torch.isfinite(a).all()) for a in (ctx_p, *grads_p))


# ---- the stream residency's copies: pinned staging, a side stream, events ---

# ~100 ms of device spin on an H100 (torch.cuda._sleep counts clock cycles):
# far longer than the host needs to gather a small chunk, so a copy or a
# kernel still queued behind it is certainly in flight when the next chunk
# is produced
_SPIN_CYCLES = 200_000_000
_CHUNK_FLOATS = 1 << 20


def _chunk_stream(n, cls=None):
    from factorvae_tpu_torch.data.stream import ChunkStream

    def make_chunk(i, alloc):
        a = alloc("values", (_CHUNK_FLOATS,), np.float32)
        a[...] = float(i)
        return (a,)

    return (cls or ChunkStream)(make_chunk, n, "cuda")


def _slow_copies(base):
    class SlowCopies(base):
        """Every copy queued behind a spin on the side stream."""

        def _copy(self, buf, sources):
            with torch.cuda.stream(self._copy_stream):
                torch.cuda._sleep(_SPIN_CYCLES)
            return super()._copy(buf, sources)

    return SlowCopies


def _consume(stream, spin=False):
    """Each chunk's first value, read on the consumer's stream (after a spin
    when `spin`) before the chunk is released."""
    got = []
    for (t,) in stream:
        if spin:
            torch.cuda._sleep(_SPIN_CYCLES)
        got.append(t[:1].clone())
    torch.cuda.synchronize()
    return [float(g) for g in got]


class TestChunkStreamOnCard:
    def test_staging_buffer_waits_for_the_copy_that_reads_it(self, dev):
        """The copies lag ~100 ms each: the worker finds a staging buffer
        still being read and waits, and every chunk arrives intact. Without
        the wait (the control) it overwrites bytes the DMA has not read."""
        from factorvae_tpu_torch.data.stream import ChunkStream

        stream = _chunk_stream(6, _slow_copies(ChunkStream))
        assert _consume(stream) == [float(i) for i in range(6)]
        assert stream.staging_waits >= 1 and stream.copy_seconds > 0
        assert stream.stats()["h2d_gb_per_s"] > 0

        class Unguarded(_slow_copies(ChunkStream)):
            def _settle(self, buf):
                self._copied[buf] = None

        assert _consume(_chunk_stream(6, Unguarded)) != [float(i) for i in range(6)]

    def test_record_stream_keeps_a_chunk_until_its_kernels_ran(self, dev, monkeypatch):
        """The consumer's kernels lag ~100 ms behind its loop: each chunk's
        memory must not go to a later chunk's copy before they ran. Each
        guard holds alone: `record_stream` without the freed slot's event,
        the event without `record_stream`. Without both (the control) a
        later copy overwrites a chunk still being read."""
        from factorvae_tpu_torch.data.stream import ChunkStream

        want = [float(i) for i in range(6)]
        assert _consume(_chunk_stream(6), spin=True) == want
        with monkeypatch.context() as m:
            m.setattr(ChunkStream, "_mark_freed", lambda self: None)
            assert _consume(_chunk_stream(6), spin=True) == want
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "record_stream", lambda self, s: None)
            assert _consume(_chunk_stream(6), spin=True) == want
            m.setattr(ChunkStream, "_mark_freed", lambda self: None)
            assert _consume(_chunk_stream(6), spin=True) != want

    def test_a_consumer_holding_two_chunks_gets_an_error(self, dev):
        """A third chunk can never get a slot while the consumer keeps two:
        the stream raises instead of waiting for ever."""
        with pytest.raises(RuntimeError, match=r"still holds chunks \[0, 1\]"):
            list(_chunk_stream(4))

    def test_at_most_two_chunks_on_the_device(self, dev):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        _consume(_chunk_stream(8), spin=True)
        peak = torch.cuda.max_memory_allocated() - before
        chunk = 4 * _CHUNK_FLOATS
        assert 2 * chunk <= peak < 3 * chunk


# ---- the registered ops and the AOT artifact -----------------------------------------


def test_registered_ops_launch_the_kernels(dev):
    """`factorvae_tpu_torch::gru_fwd` and `::attention_fwd` on CUDA tensors
    are the wrappers: one launch each, bitwise the wrappers' outputs."""
    rng = np.random.default_rng(11)
    xi, w_h, b_h = _to(dev, rng.normal(size=(304, 20, 192)).astype(np.float32),
                       (rng.normal(size=(64, 192)) * 0.1).astype(np.float32),
                       (rng.normal(size=(192,)) * 0.1).astype(np.float32))
    k1 = gru_fwd.launches
    got = torch.ops.factorvae_tpu_torch.gru_fwd(xi, w_h, b_h)
    assert gru_fwd.launches == k1 + 1
    assert torch.equal(got, gru_fwd(xi, w_h, b_h))
    latent, q, wk, bk, wv, bv = _to(
        dev, rng.normal(size=(1, 304, 64)).astype(np.float32),
        rng.normal(size=(96, 64)).astype(np.float32),
        (rng.normal(size=(96, 64, 64)) * 0.1).astype(np.float32),
        (rng.normal(size=(96, 64)) * 0.1).astype(np.float32),
        (rng.normal(size=(96, 64, 64)) * 0.1).astype(np.float32),
        (rng.normal(size=(96, 64)) * 0.1).astype(np.float32))
    mask = torch.ones((1, 304), dtype=torch.bool, device=dev)
    mask[0, 300:] = False
    k4 = attention_fwd.launches
    ctx = torch.ops.factorvae_tpu_torch.attention_fwd(latent, mask, q, wk, bk, wv, bv)
    assert attention_fwd.launches == k4 + 1
    assert torch.equal(ctx, attention_fwd(latent, mask, q, wk, bk, wv, bv))


def test_cpu_exported_artifact_on_the_card_matches_the_cpu(dev):
    """An artifact exported on the CPU, moved to the card at load, launches
    K1 and K4 once per call and scores within the tolerance of the same
    artifact on the CPU."""
    from factorvae_tpu_torch.config import Config, ModelConfig
    from factorvae_tpu_torch.eval.export_aot import export_prediction, load_exported
    from factorvae_tpu_torch.models.factorvae import load_model

    cfg = Config(model=ModelConfig(num_features=16, hidden_size=32, num_factors=8,
                                   num_portfolios=16, seq_len=10))
    blob = export_prediction(load_model(cfg, device="cpu"), cfg, 64, platform="cuda")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1, 64, 10, 16)).astype(np.float32))
    mask = torch.from_numpy(rng.random((1, 64)) < 0.9)
    want = load_exported(blob, device="cpu").call(x, mask)
    art = load_exported(blob)
    assert art.device.type == "cuda"
    k1, k4 = gru_fwd.launches, attention_fwd.launches
    got = art.call(x.to(dev), mask.to(dev))
    assert (gru_fwd.launches - k1, attention_fwd.launches - k4) == (1, 1)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)


def test_a_capture_names_every_kernel_by_its_cuda_function(dev, tmp_path):
    """One training step's kernels (K1's residual variant, the walk, dWh,
    K4, K5) and K1's serving variant under `utils/profiling.trace`: the
    Kineto trace's kernel rows counted by CUDA function equal the launch
    counters' rise, and the host rows name each launch (`launch_range`)."""
    import re

    from factorvae_tpu_torch.utils.profiling import trace
    from factorvae_tpu_torch.utils.trace_summary import summarize_trace

    rng = np.random.default_rng(11)
    n, t, h, k = 64, 8, 32, 8
    xi, w_h, b_h = _to(dev, rng.normal(size=(n, t, 3 * h)).astype(np.float32),
                       (rng.normal(size=(h, 3 * h)) * 0.1).astype(np.float32),
                       (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32))
    args, keep, dctx, _ = _attention_case(dev, 2, n, k, h, 3, poison=False)
    counters = (gru_fwd, gru_fwd_residuals, gru_bwd, gru_dwh, attention_fwd, attention_bwd)
    gru_fwd(xi, w_h, b_h)                                   # built and loaded before
    before = [c.launches for c in counters]
    with trace(str(tmp_path)):
        gru_fwd(xi, w_h, b_h)
        _, hseq, gseq = gru_fwd_residuals(xi, w_h, b_h)
        gru_bwd(xi, w_h, b_h, torch.ones((n, h), device=dev), residuals=(hseq, gseq))
        attention_fwd(*args, keep=keep)
        attention_bwd(*args, dctx, keep=keep)
    rise = {c.__name__: c.launches - b for c, b in zip(counters, before)}
    assert rise == {"gru_fwd": 1, "gru_fwd_residuals": 1, "gru_bwd": 1, "gru_dwh": 1,
                    "attention_fwd": 1, "attention_bwd": 1}
    s = summarize_trace(str(tmp_path), top=10000)
    by = [(name, count) for name, _, count in s["by_name"]]

    def count(pattern):
        return sum(c for name, c in by if re.search(pattern, name))

    assert count(r"gru_fwd_kernel<[^,>]+,\s*false") == 1
    assert count(r"gru_fwd_kernel<[^,>]+,\s*true") == 1
    assert count(r"gru_walk_kernel") == count(r"gru_dwh_kernel") == 1
    assert count(r"attention_fwd_kernel") == count(r"attention_bwd_head_kernel") == 1
    host = {name for name, _, _ in s["host_by_name"]}
    assert {"gru_fwd", "gru_fwd_residuals", "gru_bwd", "gru_dwh", "attention_fwd",
            "attention_bwd"} <= host
    # above H = 64: the wide walk and the tensor-core dWh
    hw = 96
    xw, ww, bw = _to(dev, rng.normal(size=(n, t, 3 * hw)).astype(np.float32),
                     (rng.normal(size=(hw, 3 * hw)) * hw ** -0.5).astype(np.float32),
                     (rng.normal(size=(3 * hw,)) * 0.1).astype(np.float32))
    _, hseq, gseq = gru_fwd_residuals(xw, ww, bw)
    wide_dir = tmp_path / "wide"
    with trace(str(wide_dir)):
        gru_fwd(xw, ww, bw)           # a capture's first launch may go unrecorded
        gru_bwd(xw, ww, bw, torch.ones((n, hw), device=dev), residuals=(hseq, gseq))
    by = [(name, count) for name, _, count in summarize_trace(str(wide_dir), top=10000)[
        "by_name"]]
    assert count(r"gru_walk_wide_kernel") == count(r"gru_dwh_wide_kernel") == 1
    assert count(r"gru_walk_kernel") == count(r"gru_dwh_kernel") == 0


_BUILD_INTO = """
import json, sys
from factorvae_tpu_torch import _build, plan
assert plan.setup_compilation_cache(sys.argv[1]) == sys.argv[1]
for name in _build.KERNELS:
    _build.load(name)
print(json.dumps({"counts": _build.compile_event_counts(), "dir": str(_build.BUILD_DIR)}))
"""


def test_compile_cache_builds_into_dir_and_a_second_process_compiles_nothing(dev,
                                                                               tmp_path):
    """`--compile_cache DIR`'s mechanism: a fresh process builds every
    library into DIR; a second fresh process given DIR loads them all as
    compile_cached and compiles none."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = str(tmp_path / "cc")
    runs = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", _BUILD_INTO, cache], cwd=repo,
                           capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr
        runs.append(json.loads(r.stdout.splitlines()[-1]))
    from factorvae_tpu_torch import _build

    n = len(_build.KERNELS)
    assert runs[0] == {"counts": {"compile": n, "compile_cached": 0}, "dir": cache}
    assert runs[1] == {"counts": {"compile": 0, "compile_cached": n}, "dir": cache}
    assert len([f for f in os.listdir(cache) if f.endswith(".so")]) == n
