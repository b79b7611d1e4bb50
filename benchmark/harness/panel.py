"""The traffic's data: a stock universe's daily panel, made from the seed on
the device.

The calendar is the business days (Monday to Friday) from the
configuration's `start_time` to its `end_time`. The universe keeps
`stocks_per_day` members: each member holds a slot, and at every
rebalance (every `rebalance_days` days) some slots pass to instruments
that were not members before, `instruments - stocks_per_day` changes in
all, spread evenly over the rebalances; the slots that change are drawn
from the seed. So every instrument is a member over one stretch of days. A
member's day is missing (a suspension) with probability `missing_share`.
Features are N(0, 1) and labels N(0, label_scale^2), NaN where the row is
missing. Every seed gives a panel of the same sizes; only the draws and
which slots change differ.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.seeds import stream_seed

PANEL_STREAM = 11


def calendar(start: str, end: str) -> np.ndarray:
    """Business days in [start, end], datetime64[D]."""
    first = np.busday_offset(np.datetime64(start, "D"), 0, roll="forward")
    last = np.busday_offset(np.datetime64(end, "D"), 0, roll="backward")
    return np.busday_offset(first, np.arange(np.busday_count(first, last) + 1))


def membership(universe: dict, n_days: int, gen: torch.Generator, device) -> torch.Tensor:
    """(D, I) bool: instrument i is a member on day d."""
    u, n_inst = universe["stocks_per_day"], universe["instruments"]
    every = universe["rebalance_days"]
    rebalances = list(range(every, n_days, every))
    changes = n_inst - u
    if changes and not rebalances:
        raise ValueError("instruments > stocks_per_day needs at least one rebalance")
    owner = torch.arange(u, device=device)
    member = torch.zeros((n_days, n_inst), dtype=torch.bool, device=device)
    start, nxt = 0, u
    for k, day in enumerate(rebalances + [n_days]):
        member[start:day, owner] = True
        if day == n_days:
            break
        take = changes // len(rebalances) + (1 if k < changes % len(rebalances) else 0)
        pick = torch.randperm(u, generator=gen, device=device)[:take]
        owner[pick] = torch.arange(nxt, nxt + take, device=device)
        nxt += take
        start = day
    return member


def make_panel(config: dict, seed: int, device) -> dict:
    """{"values" (I, D, C+1) float32 on `device`, NaN where a row is missing,
    the label last; "valid" (D, I) bool; "dates" (D,) datetime64[D];
    "instruments" (I,) str} for the configuration's universe and span."""
    universe, m = config["universe"], config["model"]
    dates = calendar(config["data"]["start_time"], config["data"]["end_time"])
    n_days, n_inst, c = len(dates), universe["instruments"], m["num_features"]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, PANEL_STREAM))
    member = membership(universe, n_days, gen, device)
    present = torch.rand((n_days, n_inst), generator=gen, device=device) \
        >= universe["missing_share"]
    valid = member & present
    values = torch.randn((n_inst, n_days, c + 1), generator=gen, device=device)
    values[..., -1] *= universe["label_scale"]
    values.masked_fill_(~valid.t()[..., None], float("nan"))
    instruments = np.array([f"S{600000 + i}" for i in range(n_inst)])
    return {"values": values, "valid": valid, "dates": dates, "instruments": instruments}


def split_days(dates: np.ndarray, valid: torch.Tensor, start: str, end: str) -> np.ndarray:
    """Indices of the days in [start, end] on which some stock has a row."""
    lo = int(np.searchsorted(dates, np.datetime64(start, "D"), "left"))
    hi = int(np.searchsorted(dates, np.datetime64(end, "D"), "right"))
    days = np.arange(lo, hi)
    any_row = valid[lo:hi].any(dim=1).cpu().numpy()
    return days[any_row]
