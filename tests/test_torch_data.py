"""The port's panel, fill maps, window gather and dataset against the JAX
package. All of it is integer selection, so the comparison is bitwise."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.data.synthetic import synthetic_panel_dense as jsynthetic_dense
from factorvae_tpu.data.windows import compute_fill_maps as jcompute_fill_maps
from factorvae_tpu.data.windows import gather_day as jgather_day
from factorvae_tpu.data.windows import gather_days_host
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
from factorvae_tpu_torch.data.windows import compute_fill_maps, gather_day, gather_days

T = 5


def port_panel(jp) -> Panel:
    return Panel(values=jp.values, valid=jp.valid,
                 dates=jp.dates.values.astype("datetime64[D]"),
                 instruments=np.asarray(jp.instruments))


@pytest.fixture(scope="module")
def panels():
    jp = synthetic_panel(num_days=24, num_instruments=11, num_features=6,
                         missing_prob=0.3, seed=4)
    return jp, port_panel(jp)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


class TestFillMaps:
    @pytest.mark.parametrize("p_valid", [0.0, 0.3, 0.8, 1.0])
    def test_fill_maps_equal_jax(self, rng, p_valid):
        valid = rng.random((17, 9)) < p_valid
        for got, want in zip(compute_fill_maps(valid), jcompute_fill_maps(valid)):
            _eq(got, want)


class TestGather:
    def test_gather_day_equals_jax_bitwise(self, panels):
        jp, tp = panels
        jds = JPanelDataset(jp, seq_len=T)
        tds = PanelDataset(tp, seq_len=T, device="cpu")
        assert tds.n_max == jds.n_max == 16
        for day in range(tp.num_days):
            want = jgather_day(jds.values, jds.last_valid, jds.next_valid, day, T)
            got = gather_day(tds.values, tds.last_valid, tds.next_valid, day, T)
            for g, w in zip(got, want):
                _eq(g.numpy(), w)

    def test_batched_gather_equals_host_gather(self, panels):
        jp, tp = panels
        tds = PanelDataset(tp, seq_len=T, device="cpu")
        lv, nv = compute_fill_maps(tds.valid)
        values = tds.values.numpy()
        days = np.array([0, 3, 23, 9, 9, 1], np.int32)
        x, y, mask, _ = gather_days_host(values, lv, nv, days, T)
        got = tds.gather(torch.from_numpy(days.astype(np.int64)))
        for g, w in zip(got, (x, y, mask)):
            _eq(g.numpy(), w)
        assert gather_days(tds.values, tds.last_valid, tds.next_valid,
                           torch.tensor([2]), T)[0].shape == (1, 16, T, 6)


class TestPanelAndDataset:
    def test_synthetic_dense_equals_jax(self):
        jp = jsynthetic_dense(num_days=9, num_instruments=5, num_features=4, seed=3)
        tp = synthetic_panel_dense(num_days=9, num_instruments=5, num_features=4, seed=3)
        _eq(tp.values, jp.values)
        _eq(tp.valid, jp.valid)
        _eq(tp.dates, jp.dates.values.astype("datetime64[D]"))
        assert list(tp.instruments) == list(jp.instruments)

    @pytest.mark.parametrize("start,end", [(None, None), ("2020-01-07", "2020-01-20"),
                                           ("2020-01-04", None), (None, "2020-01-01"),
                                           ("2021-01-01", None)])
    def test_split_days_and_labels_equal_jax(self, panels, start, end):
        jp, tp = panels
        jds = JPanelDataset(jp, seq_len=T)
        tds = PanelDataset(tp, seq_len=T, device="cpu")
        days = tds.split_days(start, end)
        _eq(days, jds.split_days(start, end))
        _eq(tds.day_labels(days), jds.day_labels(days))
        assert tp.locate(start, end) == tuple(jp.locate(start, end))

    def test_padding_and_values(self, panels):
        _, tp = panels
        tds = PanelDataset(tp, seq_len=T, max_stocks=24, device="cpu")
        assert tds.n_max == 24 and tds.n_real == 11
        assert not tds.valid[:, 11:].any()
        assert torch.isnan(tds.values[11:]).all()
        with pytest.raises(ValueError):
            PanelDataset(tp, seq_len=T, max_stocks=8, device="cpu")
        assert tuple(tds.values.shape) == (24, 24, 7)
