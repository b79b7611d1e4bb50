"""The port's evaluation modules against the JAX package: the Rank-IC
statistics (`ops/stats`, `eval/metrics`), the score CSV, the backtest and
its report figure.

The statistics run in float32 in both packages over the same numbers but
sum in their own order, so they are held at rtol 1e-6 with NaN in the same
places, and atol 1e-7 (about one float32 ulp at 1): a correlation near 0
comes out of cancelling sums, whose rounding is relative to their terms
(read: 2.6e-8 apart on an IC of 0.0205). The backtest is the same numpy and pandas code on the same frame,
so its numbers must be equal.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.eval import backtest as jbacktest
from factorvae_tpu.eval import metrics as jmetrics
from factorvae_tpu.eval.predict import export_scores as jexport_scores
from factorvae_tpu.ops import stats as jstats
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.eval import backtest, metrics
from factorvae_tpu_torch.eval.plots import report_graph
from factorvae_tpu_torch.eval.predict import export_scores, score_frame, score_table
from factorvae_tpu_torch.ops import stats

RTOL, ATOL = 1e-6, 1e-7


def _stat_panel(seed=0, d=7, n=12):
    """(x, y, mask) with the hard cases: ties, masked entries, a constant
    day, a day with one valid entry, a day with none."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(d, n)).astype(np.float32)
    y = rng.normal(size=(d, n)).astype(np.float32)
    mask = rng.random((d, n)) > 0.25
    x[1, :6] = 0.5                       # ties in x
    y[2] = np.round(y[2])                # ties in y
    x[3] = 1.25                          # a constant day
    mask[4] = False
    mask[4, 3] = True                    # one valid entry
    mask[5] = False                      # none
    return x, y, mask


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


class TestStats:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_rank_pearson_spearman_match_jax(self, seed):
        x, y, mask = _stat_panel(seed)
        tx, ty, tm = map(torch.from_numpy, (x, y, mask))
        jx, jy, jm = map(jnp.asarray, (x, y, mask))
        _close(stats.masked_rank(tx, tm), jstats.masked_rank(jx, jm))
        _close(stats.masked_pearson(tx, ty, tm), jstats.masked_pearson(jx, jy, jm))
        ic = stats.rank_ic_series(tx, ty, tm)
        _close(ic, jstats.rank_ic_series(jx, jy, jm))
        assert np.isnan(ic.numpy()[3:6]).all() and np.isfinite(ic.numpy()[[0, 1, 2, 6]]).all()
        day_mask = np.ones(len(ic), bool)
        day_mask[0] = False
        for got, want in zip(stats.rank_ic_summary(ic, torch.from_numpy(day_mask)),
                             jstats.rank_ic_summary(jnp.asarray(ic.numpy()),
                                                    jnp.asarray(day_mask))):
            _close(got, want)

    def test_summary_of_no_defined_day_is_nan(self):
        ic = torch.tensor([float("nan"), float("nan")])
        mean, ir = stats.rank_ic_summary(ic, torch.ones(2, dtype=torch.bool))
        assert np.isnan(float(mean)) and np.isnan(float(ir))
        mean, ir = stats.rank_ic_summary(torch.tensor([0.2, 0.2]),
                                         torch.ones(2, dtype=torch.bool))
        assert float(mean) == pytest.approx(0.2) and np.isnan(float(ir))   # zero std


def _score_frame_with_gaps(seed=3, d=9, n=14):
    rng = np.random.default_rng(seed)
    dates = pd.bdate_range("2020-01-01", periods=d)
    inst = [f"SZ{k:06d}" for k in range(n)]
    idx = pd.MultiIndex.from_product([dates, inst], names=["datetime", "instrument"])
    df = pd.DataFrame({"score": rng.normal(size=d * n).astype(np.float32),
                       "LABEL0": (0.02 * rng.normal(size=d * n)).astype(np.float32)},
                      index=idx)
    df = df.iloc[rng.random(len(df)) > 0.15]          # absent rows
    df.loc[df.index[3], "score"] = np.nan
    df.loc[df.index[7], "LABEL0"] = np.nan
    df.loc[(dates[2], slice(None)), "score"] = 0.125  # a constant day
    return df


class TestMetrics:
    def test_rank_ic_frame_and_daily_series_match_jax(self):
        df = _score_frame_with_gaps().dropna()
        _close(metrics.daily_rank_ic(df).to_numpy(), jmetrics.daily_rank_ic(df).to_numpy())
        got, want = metrics.RankIC(df), jmetrics.RankIC(df, "LABEL0", "score")
        assert list(got.columns) == list(want.columns) == ["RankIC", "RankIC_IR"]
        _close(got.to_numpy(), want.to_numpy())
        empty = df.iloc[:0]
        assert metrics.RankIC(empty).isna().all().all()

    def test_panel_functions_match_jax_and_the_frame(self):
        x, y, mask = _stat_panel(5)
        x[0, 2] = np.nan
        y[6, 1] = np.inf
        _close(metrics.panel_rank_ic(x, y, mask), jmetrics.panel_rank_ic(x, y, mask))
        # the pandas-free summary the CLI logs equals RankIC of the frame
        d, n = x.shape
        idx = pd.MultiIndex.from_product([pd.bdate_range("2021-03-01", periods=d),
                                          [f"S{k}" for k in range(n)]],
                                         names=["datetime", "instrument"])
        frame = pd.DataFrame({"score": x.reshape(-1), "LABEL0": y.reshape(-1)},
                             index=idx)[mask.reshape(-1)]
        frame = frame.replace([np.inf, -np.inf], np.nan).dropna()
        want = jmetrics.RankIC(frame, "LABEL0", "score")
        got = metrics.rank_ic_of_panel(x, y, mask)
        _close([got["RankIC"], got["RankIC_IR"]], want.to_numpy()[0])

    def test_labeled_holdout_days_match_jax(self):
        jp = synthetic_panel(num_days=20, num_instruments=9, num_features=4,
                             missing_prob=0.4, seed=2)
        tp = Panel(values=jp.values, valid=jp.valid,
                   dates=jp.dates.values.astype("datetime64[D]"),
                   instruments=np.asarray(jp.instruments))
        jds, tds = JPanelDataset(jp, seq_len=3), PanelDataset(tp, seq_len=3, device="cpu")
        for n, min_labels in ((1, 3), (4, 6), (30, 9)):
            assert (metrics.labeled_holdout_days(tds, n, min_labels)
                    == jmetrics.labeled_holdout_days(jds, n, min_labels))


class TestScoreCsv:
    def test_export_parses_back_as_the_jax_csv(self, tmp_path):
        """Same header, same rows in the same order, float32-equal values
        (NaN in the same places), under the same name."""
        jp = synthetic_panel(num_days=12, num_instruments=7, num_features=4,
                             missing_prob=0.3, seed=6)
        tp = Panel(values=jp.values, valid=jp.valid,
                   dates=jp.dates.values.astype("datetime64[D]"),
                   instruments=np.asarray(jp.instruments))
        tds = PanelDataset(tp, seq_len=3, device="cpu")
        days = tds.split_days(None, None)
        scores = np.random.default_rng(0).normal(size=(len(days), tds.n_max)).astype(np.float32)
        scores[2, 1] = np.nan
        table = score_table(tds, days, scores, with_labels=True)
        jcfg = jconfig.Config(model=jconfig.ModelConfig(num_features=4), train=jconfig.TrainConfig(
            run_name="csv"))
        tcfg = tconfig.Config.from_dict(jcfg.to_dict())
        got = export_scores(table, tcfg, str(tmp_path / "port"))
        want = jexport_scores(score_frame(table), jcfg, str(tmp_path / "jax"))
        assert got.split("/")[-1] == want.split("/")[-1] == jcfg.score_name() + ".csv"
        a, b = pd.read_csv(got), pd.read_csv(want)
        assert list(a.columns) == list(b.columns) == ["datetime", "instrument", "score",
                                                      "LABEL0"]
        assert a[["datetime", "instrument"]].equals(b[["datetime", "instrument"]])
        for col in ("score", "LABEL0"):
            assert np.array_equal(a[col].to_numpy(np.float32), b[col].to_numpy(np.float32),
                                  equal_nan=True)
        assert len(a) == int(tds.valid[days].sum()) and a["score"].isna().sum() == 1


def _backtest_frame(seed=11, d=30, n=40):
    rng = np.random.default_rng(seed)
    dates = pd.bdate_range("2019-01-01", periods=d)
    inst = [f"SH{600000 + k}" for k in range(n)]
    idx = pd.MultiIndex.from_product([dates, inst], names=["datetime", "instrument"])
    df = pd.DataFrame({"score": rng.normal(size=d * n),
                       "LABEL0": 0.03 * rng.normal(size=d * n)}, index=idx)
    df = df.iloc[rng.random(len(df)) > 0.1].copy()
    df.loc[df.index[5:9], "score"] = np.nan
    df.loc[df.index[40:44], "LABEL0"] = 0.12           # limit-up moves
    df.loc[(dates[4], slice(None)), "score"] = np.nan   # an all-NaN score day
    return df


class TestBacktest:
    @pytest.mark.parametrize("topk,n_drop", [(10, 3), (5, 5)])
    def test_screener_and_account_equal_jax(self, topk, n_drop):
        df = _backtest_frame()
        bench = pd.Series(0.001, index=df.index.get_level_values(0).unique())
        got = backtest.topk_dropout_backtest(df.dropna(), topk=topk, n_drop=n_drop,
                                             benchmark=bench)
        want = jbacktest.topk_dropout_backtest(df.dropna(), topk=topk, n_drop=n_drop,
                                               benchmark=bench)
        assert got.summary() == want.summary()
        assert got.daily_return.equals(want.daily_return)
        acct = backtest.simulate_topk_account(df, topk=topk, n_drop=n_drop, benchmark=bench)
        jacct = jbacktest.simulate_topk_account(df, topk=topk, n_drop=n_drop, benchmark=bench)
        assert acct.report.equals(jacct.report)
        assert acct.summary() == jacct.summary()
        assert acct.analysis_frame().equals(jacct.analysis_frame())

    def test_risk_analysis_equals_jax(self):
        r = pd.Series(np.random.default_rng(1).normal(size=50) * 0.01)
        r.iloc[7] = np.nan
        for series in (r, r.iloc[:0], pd.Series([0.01, 0.01])):
            got, want = backtest.risk_analysis(series), jbacktest.risk_analysis(series)
            assert json.dumps(got) == json.dumps(want)

    def test_main_on_a_score_csv_equals_jax(self, tmp_path, capsys):
        path = tmp_path / "scores.csv"
        _backtest_frame().reset_index().to_csv(path, index=False)
        argv = [str(path), "--topk", "8", "--n_drop", "2"]
        assert backtest.main(argv) == 0
        got = capsys.readouterr().out
        assert jbacktest.main(argv) == 0
        assert got == capsys.readouterr().out

    def test_report_graph_writes_a_png(self, tmp_path):
        acct = backtest.simulate_topk_account(_backtest_frame(), topk=8, n_drop=2)
        out = report_graph(acct.report, str(tmp_path / "bt.png"), title="t")
        with open(out, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
