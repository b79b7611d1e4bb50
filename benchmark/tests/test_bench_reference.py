"""The plain reference against the port at a tiny size on the CPU: the
windows, one training step and one scoring chunk, from the same weights and
noise."""

import numpy as np
import pytest
import torch

from benchmark.harness.panel import make_panel
from benchmark.harness.weights import make_weights
from benchmark.reference import factorvae as ref
from benchmark.tests.conftest import TINY


@pytest.fixture
def setup():
    from factorvae_tpu_torch.config import ModelConfig
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.panel import Panel
    from factorvae_tpu_torch.models.factorvae import model_from_params

    panel = make_panel(TINY, seed=5, device="cpu")
    ds = PanelDataset(Panel(values=panel["values"].numpy(), valid=panel["valid"].numpy(),
                            dates=panel["dates"], instruments=panel["instruments"]),
                      seq_len=TINY["model"]["seq_len"], pad_multiple=8, device="cpu")
    weights = make_weights(ref.param_specs(TINY["model"]), seed=5, device="cpu")
    model = model_from_params(ModelConfig(**TINY["model"]), weights)
    values, valid = ref.pad_panel(panel["values"], panel["valid"], 8)
    return ds, model, weights, values, valid


def test_param_specs_are_the_program_parameters():
    from factorvae_tpu_torch.config import ModelConfig
    from factorvae_tpu_torch.models.factorvae import FactorVAE

    model = FactorVAE(ModelConfig(**TINY["model"]))
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert have == {n: tuple(s) for n, s, _ in ref.param_specs(TINY["model"])}


def test_windows_are_the_program_windows(setup):
    ds, _, _, values, valid = setup
    days = torch.arange(ds.values.shape[1])
    x, y, mask = ds.gather(days)
    rx, ry, rmask = ref.windows(values, valid, days, TINY["model"]["seq_len"])
    assert ds.n_max == values.shape[0] == 32
    assert torch.equal(mask, rmask)
    assert torch.equal(x, rx)
    assert torch.equal(torch.nan_to_num(y, nan=-9.0), torch.nan_to_num(ry, nan=-9.0))
    # the fill does work: some windows take rows of other days
    assert not valid.all() and (rx == 0).any()


def test_one_training_step(setup):
    from factorvae_tpu_torch.train.loop import weighted_day_loss

    ds, model, weights, values, valid = setup
    m = TINY["model"]
    days = torch.tensor([10, 20, 30, 40])
    (eps, keep), = ref.train_noise(m, 9, 1, 4, ds.n_max, "cpu")
    model.train()
    loss, _ = weighted_day_loss(model, ds, days, train=True, eps=eps, keep=keep)
    grads = dict(zip([n for n, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))
    x, y, mask = ref.windows(values, valid, days, m["seq_len"])
    leaves = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    rloss = ref.day_losses(leaves, m, x, y, mask, eps, keep).mean()
    rgrads = dict(zip(leaves, torch.autograd.grad(rloss, list(leaves.values()))))
    loss, rloss = float(loss.detach()), float(rloss.detach())
    assert abs(loss - rloss) <= 1e-5 * abs(rloss)
    for name, g in rgrads.items():
        assert float((grads[name] - g).abs().max()) <= 1e-4 * max(float(g.abs().max()), 1e-6), name


def test_one_scoring_chunk(setup):
    from factorvae_tpu_torch.config import Config, ModelConfig
    from factorvae_tpu_torch.eval.predict import predict_panel

    ds, model, weights, values, valid = setup
    m = TINY["model"]
    days = np.arange(16, 24)
    got = predict_panel(model.eval(), Config(model=ModelConfig(**m)), ds, days, seed=77,
                        chunk=8)
    x, _, mask = ref.windows(values, valid, torch.as_tensor(days), m["seq_len"])
    want = ref.scores(weights, m, x, mask, ref.score_noise(77, 0, 8, ds.n_max, "cpu"))
    want = want.numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.abs(got[ok] - want[ok]).max() <= 1e-5 * np.abs(want[ok]).max()


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12, -3.0])
    got = ref.round_tf32(x)
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -10, -3.0]
