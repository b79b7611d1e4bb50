"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch, without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: f32 with rtol=1e-5, atol=1e-5. The kernels sum their products
in another order than cuBLAS does for the plain versions.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from factorvae_tpu_torch.ops.kernels.attention import attention_fwd, attention_fwd_plain
from factorvae_tpu_torch.ops.kernels.gru import gru_fwd, gru_fwd_plain

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


def _close(got, want):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.parametrize("n,t,h", [(9728, 20, 64), (1001, 20, 60), (37, 6, 8),
                                   (33, 5, 37), (300, 20, 33)])
def test_gru_kernel_matches_plain(dev, n, t, h):
    rng = np.random.default_rng(n + h)
    xi, wh, bh = _to(dev, (rng.normal(size=(n, t, 3 * h)) * 0.5).astype(np.float32),
                     (rng.normal(size=(h, 3 * h)) * 0.3).astype(np.float32),
                     (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32))
    before = gru_fwd.launches
    got = gru_fwd(xi, wh, bh)
    assert gru_fwd.launches == before + 1
    _close(got, gru_fwd_plain(xi, wh, bh))


def test_gru_kernel_refuses_what_it_cannot_run(dev):
    with pytest.raises(ValueError, match="exceeds"):
        gru_fwd(torch.zeros(2, 3, 195, device=dev), torch.zeros(65, 195, device=dev),
                torch.zeros(195, device=dev))
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
        call(1, 4, 2, 65)
    before = attention_fwd.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        call(1, 40000, 1, 8)     # scores and row list exceed one block's shared memory
    assert attention_fwd.launches == before
    call(1, 4, 2, 8)             # the refusal leaves no error behind for the next launch
    assert attention_fwd.launches == before + 1


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
    args = _to(dev, latent, mask, *weights)
    keep = None
    if with_keep:
        keep = _to(dev, ((rng.random((b, k, n)) > 0.1) / 0.9).astype(np.float32))[0]
    before = attention_fwd.launches
    got = attention_fwd(*args, keep=keep)
    assert attention_fwd.launches == before + 1
    _close(got, attention_fwd_plain(*args, keep=keep))
    assert bool((got[0] == 0).all()) and bool((got[1] == 0).all())
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
