"""Device-resident day-batch dataset (`factorvae_tpu/data/loader.py`).

The whole panel is padded to `n_max` stocks and moved to the device once;
a batch is a tensor of day indices, and the window gather runs on the
device (`windows.gather_days`). This is the JAX package's "hbm" residency;
the host-streaming residency is not ported yet. `epoch_order` visits days in
the JAX package's order, so both packages train on the same sequence.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.data.windows import compute_fill_maps, gather_days


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class PanelDataset:
    """Panel + split bookkeeping with the panel resident on `device`.

    The cross-section is padded to `n_max` (a multiple of `pad_multiple`);
    padded instruments are never valid."""

    def __init__(self, panel: Panel, seq_len: int = 20,
                 max_stocks: Optional[int] = None, pad_multiple: int = 8,
                 device="cuda"):
        self.panel = panel
        self.seq_len = seq_len
        self.device = torch.device(device)
        n_inst = panel.num_instruments
        n_max = max_stocks or _round_up(n_inst, pad_multiple)
        if n_max < n_inst:
            raise ValueError(f"max_stocks={n_max} < {n_inst} instruments")
        self.n_max = n_max
        self.n_real = n_inst

        d = panel.num_days
        values = np.full((n_max, d, panel.values.shape[-1]), np.nan, np.float32)
        values[:n_inst] = panel.values
        valid = np.zeros((d, n_max), bool)
        valid[:, :n_inst] = panel.valid
        last_valid, next_valid = compute_fill_maps(valid)
        self.values = torch.from_numpy(values).to(self.device)
        self.last_valid = torch.from_numpy(last_valid.astype(np.int64)).to(self.device)
        self.next_valid = torch.from_numpy(next_valid.astype(np.int64)).to(self.device)
        self.valid = valid
        self.dates = panel.dates
        self.instruments = panel.instruments

    def split_days(self, start: Optional[str], end: Optional[str]) -> np.ndarray:
        """Indices of the days in [start, end] that have any valid row."""
        lo, hi = self.panel.locate(start, end)
        days = np.arange(lo, hi, dtype=np.int32)
        return days[self.valid[days].any(axis=1)]

    def epoch_order(self, days: np.ndarray, shuffle: bool, seed: int, epoch: int,
                    pad_to: int = 0) -> np.ndarray:
        """Day order for one epoch: shuffled with numpy's
        `default_rng((seed, epoch))`, as the JAX package shuffles, then padded
        with -1 (a day of weight 0) to a multiple of `pad_to`."""
        order = np.array(days)
        if shuffle:
            np.random.default_rng((seed, epoch)).shuffle(order)
        if pad_to:
            rem = (-len(order)) % pad_to
            if rem:
                order = np.concatenate([order, np.full(rem, -1, order.dtype)])
        return order

    def gather(self, days: torch.Tensor):
        """(x, y, mask) for a batch of valid day indices on the device."""
        return gather_days(self.values, self.last_valid, self.next_valid,
                           days, self.seq_len)

    def day_labels(self, days: np.ndarray) -> np.ndarray:
        """(len(days), n_max) labels in day-major order."""
        idx = torch.as_tensor(np.asarray(days, np.int64), device=self.device)
        return self.values[:, idx, -1].transpose(0, 1).cpu().numpy()
