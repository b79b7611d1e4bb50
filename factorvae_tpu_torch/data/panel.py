"""Dense panel of a stock universe (`factorvae_tpu/data/panel.py`).

    values: (I, D, C+1) float32, NaN where an (instrument, day) row is
            absent; the last column is the label
    valid:  (D, I) bool, the row exists on that trading day
    dates:  (D,) numpy datetime64[D]
    instruments: (I,) str

`build_panel`'s scatter is the native pass where it builds
(`native.scatter_panel`), numpy otherwise, bitwise the same; of two rows
with one (datetime, instrument) the later one in index order stays.

pandas is imported only by `load_frame`, `build_panel` and `panel_to_frame`,
which read and write the reference's pickle schema; the scoring path never
needs it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from factorvae_tpu_torch import native


def to_day(d) -> np.datetime64:
    return np.datetime64(str(d)[:10], "D")


@dataclasses.dataclass
class Panel:
    values: np.ndarray        # (I, D, C+1) float32
    valid: np.ndarray         # (D, I) bool
    dates: np.ndarray         # (D,) datetime64[D]
    instruments: np.ndarray   # (I,) str

    @property
    def num_days(self) -> int:
        return len(self.dates)

    @property
    def num_instruments(self) -> int:
        return len(self.instruments)

    @property
    def num_features(self) -> int:
        return self.values.shape[-1] - 1

    def date_slice(self, start: Optional[str], end: Optional[str]) -> "Panel":
        """The panel restricted to the trading days in [start, end], both
        inclusive, as pandas' `slice_locs`: a bound between trading days
        takes the days inside it, one outside the calendar clips to it."""
        lo, hi = self.locate(start, end)
        return Panel(values=self.values[:, lo:hi], valid=self.valid[lo:hi],
                     dates=self.dates[lo:hi], instruments=self.instruments)

    def locate(self, start: Optional[str], end: Optional[str]) -> tuple:
        """Day-index range [lo, hi) of the dates in [start, end] (both
        inclusive; None leaves that side open)."""
        lo = 0 if start is None else int(np.searchsorted(self.dates, to_day(start), "left"))
        hi = (len(self.dates) if end is None
              else int(np.searchsorted(self.dates, to_day(end), "right")))
        return lo, max(lo, hi)


def load_frame(path: str, select_feature: Optional[Sequence[str]] = None,
               max_columns: int = 159):
    """Read a reference-schema pickle: keep the first 159 columns and name
    the last one 'LABEL0'."""
    import pandas as pd

    df = pd.read_pickle(path)
    if isinstance(df.columns, pd.MultiIndex):
        df.columns = [c[-1] for c in df.columns]
    df = df.iloc[:, :max_columns]
    df = df.rename(columns={df.columns[-1]: "LABEL0"})
    if select_feature is not None:
        df = df[list(select_feature) + ["LABEL0"]]
    return df


def _scatter_numpy(data, rows, cols, d_total, n_inst):
    """`native.scatter_panel`'s numpy version."""
    values = np.full((n_inst, d_total, data.shape[1]), np.nan, np.float32)
    key = cols * d_total + rows
    seen = np.zeros(n_inst * d_total, bool)
    seen[key] = True
    if int(seen.sum()) < len(key):
        # a repeated (datetime, instrument): numpy leaves the winner
        # unspecified; keep the later row, as the native pass does
        last = len(key) - 1 - np.unique(key[::-1], return_index=True)[1]
        values[cols[last], rows[last]] = data[last]
    else:
        values[cols, rows] = data
    return values


def build_panel(df) -> Panel:
    """Densify a MultiIndex (datetime, instrument) frame to a Panel."""
    if list(df.index.names) != ["datetime", "instrument"]:
        raise ValueError(f"expected (datetime, instrument) index, got {df.index.names}")
    df = df.sort_index()
    dates = df.index.get_level_values(0).unique().sort_values()
    instruments = df.index.get_level_values(1).unique().sort_values()
    d, i = len(dates), len(instruments)
    rows = dates.get_indexer(df.index.get_level_values(0)).astype(np.int64)
    cols = instruments.get_indexer(df.index.get_level_values(1)).astype(np.int64)
    data = df.to_numpy(dtype=np.float32)
    valid = np.zeros((d, i), bool)
    valid[rows, cols] = True
    values = native.scatter_panel(data, rows, cols, d, i, fallback=_scatter_numpy)
    return Panel(values=values, valid=valid,
                 dates=np.asarray(dates.values, dtype="datetime64[D]"),
                 instruments=np.asarray(instruments))


def panel_to_frame(panel: Panel):
    """The inverse of `build_panel`: a (datetime, instrument)-indexed frame
    of the rows that exist, day-major, the label last."""
    import pandas as pd

    i, d, c = panel.values.shape
    idx = pd.MultiIndex.from_product(
        [pd.DatetimeIndex(panel.dates.astype("datetime64[ns]")), panel.instruments],
        names=["datetime", "instrument"])
    flat = np.swapaxes(panel.values, 0, 1).reshape(d * i, c)
    keep = panel.valid.reshape(-1)
    return pd.DataFrame(flat[keep], index=idx[keep])
