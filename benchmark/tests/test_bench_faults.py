"""A whole run of each traffic kind on the CPU at a tiny size, past the
harness's look for a card: sound, it is correct; with the timed path broken
underneath, or with the control (the reference in TF32) in the program's
place, `correct` comes out false. The control at a size a test run holds on
the card is marked `cuda`."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import runner


def _run(cell: str, seed: int = 21, trace: bool = False) -> tuple:
    result, checks = runner.run_cell(cell, seed, 0.2, trace, time.perf_counter(), device="cpu")
    return result, checks


@pytest.mark.parametrize("trace", [False, True])
def test_sound_runs_are_correct(tiny, trace):
    for cell, rate in (("tiny.train", "mfu.train"), ("tiny.backfill", "mfu.score")):
        result, checks = _run(cell, trace=trace)
        assert result["correct"], checks
        assert result["attempted"] > 0 and result["failed"] == 0
        assert (rate in result["metrics"]) == trace


def test_a_step_that_leaves_the_state_unchanged(tiny, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    result, checks = _run("tiny.train")
    assert not result["correct"]
    assert checks["change_gap"][0] == pytest.approx(1.0)


def test_half_of_each_batch_left_out(tiny, monkeypatch):
    from factorvae_tpu_torch.train import loop

    whole = loop.weighted_day_loss

    def half(model, dataset, days, **kw):
        days = days.clone()
        days[days.shape[0] // 2:] = -1
        return whole(model, dataset, days, **kw)

    monkeypatch.setattr(loop, "weighted_day_loss", half)
    result, checks = _run("tiny.train")
    assert not result["correct"], checks


def test_an_answer_altered_where_it_is_produced(tiny, monkeypatch):
    from factorvae_tpu_torch.models.factorvae import FactorVAE

    sound = FactorVAE.day_batched_prediction

    def swapped(self, x, mask, **kw):
        out = sound(self, x, mask, **kw)
        i, j = torch.nonzero(mask[0]).flatten()[:2].tolist()
        out[0, i], out[0, j] = out[0, j].clone(), out[0, i].clone()
        return out

    monkeypatch.setattr(FactorVAE, "day_batched_prediction", swapped)
    result, checks = _run("tiny.backfill")
    assert not result["correct"], checks


def test_half_of_each_chunk_left_unscored(tiny, monkeypatch):
    from factorvae_tpu_torch.models.factorvae import FactorVAE

    sound = FactorVAE.day_batched_prediction

    def half(self, x, mask, **kw):
        out = sound(self, x, mask, **kw)
        out[out.shape[0] // 2:] = float("nan")
        return out

    monkeypatch.setattr(FactorVAE, "day_batched_prediction", half)
    result, checks = _run("tiny.backfill")
    assert not result["correct"] and checks["missing_answers"][0] > 0


def _control(cell: str, seed: int, device) -> tuple:
    """The control's numbers (the reference in TF32 in the program's place,
    against the reference in float32) and the cell's limits."""
    from benchmark.calibrate import readings
    from benchmark.harness import cells

    return readings(cell, seed, control=True, device=device)["control"], \
        cells.cell(cell)["limits"]


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.backfill"])
def test_the_control_fails_on_the_cpu(tiny, cell):
    got, limits = _control(cell, 4, "cpu")
    assert any(got[k] > limits[k] for k in limits), (got, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["csi800-k60", "alpha360-k60"])
@pytest.mark.parametrize("traffic", ["train", "backfill"])
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_the_control_fails_on_the_card(card, config, traffic, seed, monkeypatch):
    """The control at a configuration's own shapes but a quarter of its
    span's years, on the card's own TF32, held to that cell's limits."""
    from benchmark.harness import cells

    full = cells.config(config)
    short = dict(full, data=dict(full["data"], start_time="2016-01-01"))
    name = f"{config}.{traffic}"
    spec = {"workloads": [{"name": name, "config": config, "traffic": traffic, "chips": 1}]}
    monkeypatch.setattr(cells, "spec", lambda root=None: spec)
    monkeypatch.setattr(cells, "config", lambda name: short)
    got, limits = _control(name, seed, "cuda")
    assert any(got[k] > limits[k] for k in limits), (got, limits)
    assert all(np.isfinite(v) for k, v in got.items() if not k.startswith("_"))
