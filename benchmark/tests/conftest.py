"""Fixtures of the benchmark's own tests: a tiny configuration and traffic
run on the CPU through the program's plain versions, and the card's
fixture for the tests marked `cuda`."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "name": "tiny", "reference": "factorvae",
    "model": {"num_features": 6, "hidden_size": 8, "num_factors": 4, "num_portfolios": 8,
              "seq_len": 5, "gru_layers": 1, "dropout_rate": 0.1, "leaky_relu_slope": 0.01,
              "recon_loss": "mse", "kl_weight": 1.0, "stochastic_inference": True,
              "compute_dtype": "float32"},
    "data": {"start_time": "2020-01-01", "fit_end_time": "2020-03-31",
             "val_start_time": "2020-04-01", "val_end_time": "2020-04-30",
             "end_time": "2020-05-31", "pad_multiple": 8},
    "universe": {"stocks_per_day": 20, "instruments": 27, "rebalance_days": 30,
                 "missing_share": 0.05, "label_scale": 0.02},
}
TRAFFIC = {
    "train": {"kind": "train", "days_per_step": 4, "num_epochs": 30, "lr": 1e-4,
              "check_steps": 3},
    "backfill": {"kind": "backfill", "chunk_days": 8, "warm_chunks": 1},
}
#: the limits each kind's tiny cell is held to: those of the csi800-k60 cells
LIMITS_OF = {"tiny.train": "csi800-k60.train", "tiny.backfill": "csi800-k60.backfill"}


def tiny_spec(cells) -> dict:
    """A BENCHMARK.json of two tiny cells, one of each traffic kind, with
    every per-layer metric whose name ends in its kind's suffix."""
    per_layer = []
    for path in sorted((cells.BENCH / "metrics").glob("*.py")):
        name = path.name[:-3]
        cell = "tiny.train" if name.endswith(".train") else "tiny.backfill"
        per_layer.append({"name": name, "unit": "s" if "_s." in name else "%",
                          "workloads": [cell]})
    return {
        "workloads": [{"name": "tiny.train", "config": "tiny", "traffic": "train", "chips": 1},
                      {"name": "tiny.backfill", "config": "tiny", "traffic": "backfill",
                       "chips": 1}],
        "end_to_end": [{"name": "train_windows_per_s", "unit": "windows/s",
                        "workloads": ["tiny.train"]},
                       {"name": "score_windows_per_s", "unit": "windows/s",
                        "workloads": ["tiny.backfill"]},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": per_layer,
    }


def install_tiny(cells, setattr_=setattr) -> None:
    """Point the harness at the tiny configuration, traffic and cells."""
    spec = tiny_spec(cells)
    real_cell = cells.cell
    setattr_(cells, "spec", lambda root=None: spec)
    setattr_(cells, "config", lambda name: TINY)
    setattr_(cells, "traffic", lambda name: TRAFFIC[name])
    setattr_(cells, "cell", lambda name: real_cell(LIMITS_OF.get(name, name)))


@pytest.fixture
def tiny(monkeypatch):
    """The harness reading the tiny configuration, traffic and cells."""
    from benchmark.harness import cells

    install_tiny(cells, monkeypatch.setattr)
    return cells


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
