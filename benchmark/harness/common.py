"""What both traffic kinds share: the program's configuration, its dataset
built from the benchmark's panel, the weights, the program's launch
counters, and the numbers the check compares."""

from __future__ import annotations

import gc
import importlib
import math
import statistics

import numpy as np
import torch

from benchmark.harness import cells
from benchmark.harness.panel import make_panel, split_days
from benchmark.harness.weights import make_weights


def program_config(config: dict, train: dict):
    """The program's `Config` for a configuration file and training knobs."""
    from factorvae_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig

    m, d = config["model"], config["data"]
    return Config(
        model=ModelConfig(**m),
        data=DataConfig(seq_len=m["seq_len"], pad_multiple=d["pad_multiple"],
                        **{k: d[k] for k in ("start_time", "fit_end_time", "val_start_time",
                                             "val_end_time", "end_time")}),
        train=TrainConfig(**train))


class Inputs:
    """The run's panel and weights. The panel is made on the device, handed
    to the program as its host `Panel`, and made again for the reference
    after the window; the weights likewise."""

    def __init__(self, config: dict, seed: int, device):
        self.config, self.seed, self.device = config, seed, device
        self.m = config["model"]
        self.reference = cells.reference(config["reference"])
        panel = make_panel(config, seed, device)
        self.dates, self.instruments = panel["dates"], panel["instruments"]
        self.valid_np = panel["valid"].cpu().numpy()
        self.values_np = panel["values"].cpu().numpy()
        del panel
        d = config["data"]
        self.train_days = split_days(self.dates, torch.from_numpy(self.valid_np),
                                     d["start_time"], d["fit_end_time"])
        self.val_days = split_days(self.dates, torch.from_numpy(self.valid_np),
                                   d["val_start_time"], d["val_end_time"])
        self.valid_per_day = {
            "train": float(self.valid_np[self.train_days].sum(1).mean()),
            "val": float(self.valid_np[self.val_days].sum(1).mean()),
            "all": float(self.valid_np.sum(1).mean())}

    def dataset(self):
        """The program's dataset of the panel, resident on the device."""
        from factorvae_tpu_torch.data.loader import PanelDataset
        from factorvae_tpu_torch.data.panel import Panel

        panel = Panel(values=self.values_np, valid=self.valid_np, dates=self.dates,
                      instruments=self.instruments)
        ds = PanelDataset(panel, seq_len=self.m["seq_len"],
                          pad_multiple=self.config["data"]["pad_multiple"],
                          device=self.device, residency="hbm")
        self.values_np = None       # the program holds its copy
        return ds

    def weights(self) -> dict:
        return make_weights(self.reference.param_specs(self.m), self.seed, self.device)

    def reference_panel(self):
        """(values, valid) on the device, padded as the reference pads."""
        panel = make_panel(self.config, self.seed, self.device)
        return self.reference.pad_panel(panel["values"], panel["valid"],
                                        self.config["data"]["pad_multiple"])


def read_counters(spec: dict) -> dict:
    """{name: value} of counters given as {name: "module:attr.path"}."""
    out = {}
    for name, where in spec.items():
        mod, path = where.split(":")
        obj = importlib.import_module(mod)
        for part in path.split("."):
            obj = getattr(obj, part)
        out[name] = int(obj)
    return out


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def worst_leaf_gap(prog: dict, ref: dict, leaves) -> float:
    """Over `leaves`, the largest |prog[l] - ref[l]| (two norms of a leaf)
    against the larger of ref[l] and the median of ref over `leaves`."""
    leaves = list(leaves)
    if not leaves:
        return 0.0
    med = statistics.median(ref[name] for name in leaves)
    return max(abs(prog[name] - ref[name]) / max(ref[name], med, 1e-30) for name in leaves)


def score_gaps(prog: np.ndarray, ref: np.ndarray) -> dict:
    """Over the stocks the reference scores: the widest gap between the
    program's scores and the reference's, against the reference's RMS
    score, where both score; and the count of answers that only one side
    gives (a limit of 0)."""
    want, have = np.isfinite(ref), np.isfinite(prog)
    both = want & have
    gap = 0.0
    if both.any():
        diff = np.abs(prog[both].astype(np.float64) - ref[both].astype(np.float64))
        rms = math.sqrt(float(np.mean(ref[want].astype(np.float64) ** 2)))
        gap = float(diff.max() / max(rms, 1e-30))
    return {"score_gap": gap, "missing_answers": int((want != have).sum())}
