"""Day-batch dataset with a residency (`factorvae_tpu/data/loader.py`).

The cross-section is padded to `n_max` stocks; `residency` picks where the
padded (n_max, D, C+1) panel lives:

- "hbm": on `device`, moved there once. A batch is a tensor of day
  indices, and the window gather runs on the device (`windows.gather_days`).
- "stream": in host memory (`values_np`, `last_valid_np`, `next_valid_np`);
  no device panel is built. Epochs and scoring passes take the days in
  chunks, each a relocatable mini-panel copied to `device` one chunk ahead
  (`data/stream.py`), so device memory holds two chunks however long the
  history is. The results are bitwise the "hbm" residency's.

`epoch_order` visits days in the JAX package's order, so both packages
train on the same sequence. `extend_days` appends trading days in place.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.data.windows import compute_fill_maps, gather_days, gather_days_host

RESIDENCIES = ("hbm", "stream")
_DEVICE_PANEL = ("values", "last_valid", "next_valid")
_HOST_PANEL = ("values_np", "last_valid_np", "next_valid_np")


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class PanelDataset:
    """Panel + split bookkeeping, the panel resident per `residency`.

    The cross-section is padded to `n_max` (a multiple of `pad_multiple`);
    padded instruments are never valid. `device` is where batches are
    computed under either residency."""

    def __init__(self, panel: Panel, seq_len: int = 20,
                 max_stocks: Optional[int] = None, pad_multiple: int = 8,
                 device="cuda", residency: str = "hbm"):
        if residency not in RESIDENCIES:
            raise ValueError(f"residency must be one of {RESIDENCIES}; got {residency!r}")
        self.seq_len = seq_len
        self.device = torch.device(device)
        self.residency = residency
        n_inst = panel.num_instruments
        n_max = max_stocks or _round_up(n_inst, pad_multiple)
        if n_max < n_inst:
            raise ValueError(f"max_stocks={n_max} < {n_inst} instruments")
        self.n_max = n_max
        self.n_real = n_inst
        self._place(panel)

    def _place(self, panel: Panel) -> None:
        """Pad `panel` to n_max, compute its fill maps and put it where the
        residency says."""
        d = panel.num_days
        values = np.full((self.n_max, d, panel.values.shape[-1]), np.nan, np.float32)
        values[:self.n_real] = panel.values
        valid = np.zeros((d, self.n_max), bool)
        valid[:, :self.n_real] = panel.valid
        last_valid, next_valid = compute_fill_maps(valid)
        if self.residency == "hbm":
            self.values = torch.from_numpy(values).to(self.device)
            self.last_valid = torch.from_numpy(last_valid.astype(np.int64)).to(self.device)
            self.next_valid = torch.from_numpy(next_valid.astype(np.int64)).to(self.device)
        else:
            self.values_np = values
            self.last_valid_np = last_valid
            self.next_valid_np = next_valid
        self.panel = panel
        self.valid = valid
        self.dates = panel.dates
        self.instruments = panel.instruments

    def __getattr__(self, name):
        # called only for attributes that were never set
        if name in _DEVICE_PANEL:
            raise AttributeError(
                f"PanelDataset.{name}: no device-resident panel under residency='stream'; "
                "this consumer needs residency='hbm' or the chunked stream path "
                "(data/stream.py)")
        if name in _HOST_PANEL:
            raise AttributeError(
                f"PanelDataset.{name}: the host panel is kept only under "
                "residency='stream'")
        raise AttributeError(name)

    @property
    def dead_compute_frac(self) -> float:
        """Fraction of cross-section rows that are permanent padding."""
        return 1.0 - self.n_real / self.n_max

    @property
    def panel_nbytes(self) -> int:
        """Bytes of the padded (n_max, D, C+1) panel: what the "hbm"
        residency keeps on the device and the "stream" one does not."""
        arr = self.values_np if self.residency == "stream" else self.values
        return int(arr.nbytes)

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
        """(x, y, mask) for a batch of valid day indices on the device
        ("hbm" only; a stream chunk's `MiniPanel` has the same method)."""
        return gather_days(self.values, self.last_valid, self.next_valid,
                           days, self.seq_len)

    def gather_batch_host(self, days: np.ndarray):
        """(x, y, mask, day_w) numpy for days with -1 padding, gathered from
        the host panel ("stream" only); bitwise the device gather."""
        return gather_days_host(self.values_np, self.last_valid_np, self.next_valid_np,
                                np.asarray(days, np.int32), self.seq_len)

    def day_batch(self, day: int):
        """(x (I, T, C), y (I,), mask (I,)) of one day on the device, under
        either residency."""
        if self.residency == "stream":
            x, y, mask, _ = self.gather_batch_host(np.asarray([day]))
            return tuple(torch.from_numpy(a[0]).to(self.device) for a in (x, y, mask))
        x, y, mask = self.gather(torch.tensor([int(day)], device=self.device))
        return x[0], y[0], mask[0]

    def day_labels(self, days: np.ndarray) -> np.ndarray:
        """(len(days), n_max) labels in day-major order."""
        days = np.asarray(days, np.int64)
        if self.residency == "stream":
            return self.values_np[:, days, -1].T.copy()
        idx = torch.as_tensor(days, device=self.device)
        return self.values[:, idx, -1].transpose(0, 1).cpu().numpy()

    def extend_days(self, piece: Panel) -> bool:
        """Append trading days in place; True when days were added, False
        when every incoming day is already present (the idempotent no-op of
        a resumed append). Days that overlap the history otherwise are an
        error.

        `piece` is aligned to this dataset's instruments
        (`append.align_to_instruments`: a missing one is invalid, an unknown
        one refused). The fill maps are recomputed over the whole valid
        matrix, since a bfill may now reach the new days, so the result is
        the dataset a fresh build on the grown panel gives. Under "hbm" the
        grown panel goes to the device once; under "stream" nothing moves.
        A caller that shares the dataset with a serving thread serializes
        through `ScoringDaemon.extend_dataset`."""
        from factorvae_tpu_torch.data.append import align_to_instruments

        piece = align_to_instruments(piece, self.instruments)
        if piece.num_days == 0:
            return False
        if piece.dates[0] <= self.dates[-1]:
            if piece.dates[-1] <= self.dates[-1] and np.isin(piece.dates, self.dates).all():
                return False
            raise ValueError(
                f"extend_days: incoming days start at {piece.dates[0]} but the dataset "
                f"already ends at {self.dates[-1]}; appends must be strictly newer (or "
                "fully present, for an idempotent resume)")
        self._place(Panel(
            values=np.concatenate([self.panel.values, piece.values], axis=1),
            valid=np.concatenate([self.panel.valid, piece.valid], axis=0),
            dates=np.concatenate([self.dates, piece.dates]),
            instruments=self.panel.instruments))
        return True
