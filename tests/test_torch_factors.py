"""The port's factor decomposition, score-file comparison, reference-schema
synthetic data, `Panel.date_slice` and the ETL gate against the JAX
package.

Shapes: C 8, T 5, H 8, K 4, M 8 on a 30-day synthetic panel of 12 stocks.
`decompose` runs from the same Flax weights (`params.flax_to_torch`) on
both sides, the JAX one with Pallas in interpret mode and on its XLA path:
`factors` and `exposures` at rtol 1e-5 / atol 1e-6 under the "mse" and
"nll" reconstructions (no noise reaches them), `loss` under "nll", where
no noise enters it either; the frames' shapes, indices, column names and
dtypes exactly. `compare_scores` reads the same CSVs and labels as the
JAX function and must give its dict; `synthetic_frame` is the JAX frame
exactly.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import synthetic_frame as jsynthetic_frame
from factorvae_tpu.data import synthetic_panel as jsynthetic_panel
from factorvae_tpu.data.panel import build_panel as jbuild_panel
from factorvae_tpu.eval.compare import compare_scores as jcompare_scores
from factorvae_tpu.eval.compare import labels_from_panel as jlabels_from_panel
from factorvae_tpu.eval.compare import load_scores as jload_scores
from factorvae_tpu.eval.factors import decompose as jdecompose
from factorvae_tpu.models.factorvae import load_model as jload_model
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data import etl
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.data.synthetic import synthetic_frame, synthetic_panel
from factorvae_tpu_torch.eval import compare
from factorvae_tpu_torch.eval.factors import decompose
from factorvae_tpu_torch.models.factorvae import FactorVAE
from factorvae_tpu_torch.params import flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, T, H, K, M = 8, 5, 8, 4, 8
D, N = 30, 12
TOL = dict(rtol=1e-5, atol=1e-6)


def _port_panel(jp) -> Panel:
    return Panel(values=jp.values, valid=jp.valid,
                 dates=jp.dates.values.astype("datetime64[D]"),
                 instruments=np.asarray(jp.instruments))


@pytest.fixture(scope="module")
def panels():
    jp = jsynthetic_panel(num_days=D, num_instruments=N, num_features=C,
                          missing_prob=0.2, seed=5)
    return jp, _port_panel(jp)


# ---------------------------------------------------------------------------
# the data pieces


class TestDateSlice:
    @pytest.mark.parametrize("start,end", [
        (None, None),
        ("2020-01-06", "2020-01-20"),          # both on trading days
        ("2019-06-01", "2020-01-08"),          # start before the first day
        ("2020-01-29", "2021-01-01"),          # end after the last day
        ("2020-01-04", "2020-01-12"),          # both between trading days (weekends)
        ("2020-01-10", None), (None, "2020-01-10"),
        ("2021-01-01", "2021-02-01"),          # wholly after: empty
        ("2020-01-20", "2020-01-10"),          # reversed: empty
    ])
    def test_matches_the_jax_panel(self, panels, start, end):
        jp, tp = panels
        want, got = jp.date_slice(start, end), tp.date_slice(start, end)
        assert np.array_equal(got.dates, want.dates.values.astype("datetime64[D]"))
        assert np.array_equal(got.values, want.values, equal_nan=True)
        assert np.array_equal(got.valid, want.valid)
        assert np.array_equal(got.instruments, want.instruments)


class TestSyntheticFrame:
    @pytest.mark.parametrize("kw", [
        dict(), dict(num_days=9, num_instruments=5, num_features=4, seed=3),
        dict(num_days=7, num_instruments=4, num_features=3, missing_prob=0.5, signal=0.9,
             seed=11, label_scale=0.02)], ids=["default", "small", "sparse_scaled"])
    def test_frame_and_panel_equal_the_jax_ones(self, kw):
        want = jsynthetic_frame(**kw)
        got = synthetic_frame(**kw)
        pd.testing.assert_frame_equal(got, want)          # exact
        jp, tp = jbuild_panel(want), synthetic_panel(**kw)
        assert np.array_equal(tp.values, jp.values, equal_nan=True)
        assert np.array_equal(tp.valid, jp.valid)
        assert np.array_equal(tp.dates, jp.dates.values.astype("datetime64[D]"))
        assert np.array_equal(tp.instruments, np.asarray(jp.instruments))


class TestETLGate:
    def test_build_dataset_without_qlib_raises_the_recipe(self):
        if importlib.util.find_spec("qlib") is not None:
            pytest.skip("qlib installed in this environment")
        with pytest.raises(ImportError) as ei:
            etl.build_dataset("/nonexistent/nope.pkl")
        assert "qlib" in str(ei.value)
        assert "python -m factorvae_tpu_torch.data.etl" in str(ei.value)
        assert "factorvae_tpu.data" not in str(ei.value)

    def test_cli_returns_2_without_qlib(self, capsys):
        if importlib.util.find_spec("qlib") is not None:
            pytest.skip("qlib installed in this environment")
        assert etl.main(["--out", "/nonexistent/nope.pkl"]) == 2
        assert "pip install pyqlib" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# score-file parity


@pytest.fixture(scope="module")
def score_files(tmp_path_factory):
    """Two score CSVs (reference schema) and a labels pickle: the second
    file's scores are the first's plus noise, one day and some stocks
    missing, a NaN score."""
    root = tmp_path_factory.mktemp("scores")
    frame = jsynthetic_frame(num_days=12, num_instruments=10, num_features=4,
                             missing_prob=0.1, seed=7)
    frame.to_pickle(root / "labels.pkl")
    rng = np.random.default_rng(0)
    ref = frame[["LABEL0"]].rename(columns={"LABEL0": "score"})
    ref["score"] = ref["score"] + rng.normal(scale=1.0, size=len(ref))
    ours = ref.copy()
    ours["score"] = ours["score"] + rng.normal(scale=0.3, size=len(ours))
    ours = ours.drop(ours.index.get_level_values(0).unique()[3], level=0).iloc[2:]
    ours.iloc[5, 0] = np.nan
    for name, df in (("ref", ref), ("ours", ours)):
        df.reset_index().to_csv(root / f"{name}.csv", index=False)
    return {k: str(root / f"{k}.{ext}") for k, ext in
            (("labels", "pkl"), ("ref", "csv"), ("ours", "csv"))}


class TestCompare:
    @pytest.mark.parametrize("tolerance", [0.002, 0.5])
    def test_compare_scores_equals_the_jax_function(self, score_files, tolerance):
        want = jcompare_scores(jload_scores(score_files["ref"]),
                               jload_scores(score_files["ours"]),
                               jlabels_from_panel(score_files["labels"]), tolerance)
        got = compare.compare_scores(compare.load_scores(score_files["ref"]),
                                     compare.load_scores(score_files["ours"]),
                                     compare.labels_from_panel(score_files["labels"]),
                                     tolerance)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k], (k, got[k], want[k])
        assert got["within_tolerance"] == want["within_tolerance"]
        assert got["reference_days"] == 12 and got["ours_days"] == 11

    def test_cli_exit_codes(self, score_files):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

        def run(*extra):
            return subprocess.run(
                [sys.executable, "-m", "factorvae_tpu_torch.eval.compare",
                 score_files["ref"], score_files["ours"], "--labels",
                 score_files["labels"], *extra],
                cwd=REPO, env=env, capture_output=True, text=True, timeout=120)

        far = run()                                   # default tolerance 0.002
        assert far.returncode == 1 and '"within_tolerance": false' in far.stdout
        near = run("--tolerance", "0.5")
        assert near.returncode == 0 and '"within_tolerance": true' in near.stdout
        same = subprocess.run(
            [sys.executable, "-m", "factorvae_tpu_torch.eval.compare", score_files["ref"],
             score_files["ref"], "--labels", score_files["labels"]],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert same.returncode == 0 and '"delta_rank_ic": 0.0' in same.stdout


# ---------------------------------------------------------------------------
# decompose


def _rig(recon_loss, pallas):
    jcfg = jconfig.Config(
        model=jconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                  num_portfolios=M, seq_len=T, recon_loss=recon_loss,
                                  use_pallas_gru=pallas, use_pallas_attention=pallas),
        data=jconfig.DataConfig(seq_len=T))
    _, params = jload_model(jcfg, n_max=8)
    tcfg = tconfig.Config(model=tconfig.ModelConfig(
        num_features=C, hidden_size=H, num_factors=K, num_portfolios=M, seq_len=T,
        recon_loss=recon_loss), data=tconfig.DataConfig(seq_len=T))
    model = FactorVAE(tcfg.model)
    model.load_state_dict(flax_to_torch(params))
    return jcfg, params, tcfg, model.eval()


def _assert_frames(got, want, compare_values=True):
    assert got.shape == want.shape
    assert list(got.columns) == list(want.columns)
    assert list(got.index.names) == list(want.index.names)
    assert got.index.equals(want.index)
    assert list(got.dtypes) == list(want.dtypes)
    if compare_values:
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), **TOL)


class TestDecompose:
    @pytest.mark.parametrize("recon_loss,pallas", [("nll", True), ("nll", False),
                                                   ("mse", False)],
                             ids=["nll_pallas", "nll_xla", "mse_xla"])
    def test_matches_the_jax_decompose(self, panels, recon_loss, pallas):
        """A range that crosses an 8-day chunk, with a padded last chunk."""
        jp, tp = panels
        jcfg, params, tcfg, model = _rig(recon_loss, pallas)
        start, end = str(tp.dates[3]), str(tp.dates[25])
        want = jdecompose(params, jcfg, JPanelDataset(jp, seq_len=T), start=start, end=end,
                          chunk=8)
        got = decompose(model, tcfg, PanelDataset(tp, seq_len=T, device="cpu"),
                        start=start, end=end, chunk=8)
        assert got.keys() == want.keys()
        _assert_frames(got["factors"], want["factors"])
        _assert_frames(got["exposures"], want["exposures"])
        # the loss takes the decoder's sample under "mse": noise of each framework
        _assert_frames(got["loss"], want["loss"], compare_values=recon_loss == "nll")
        assert len(got["loss"]) == 23 and len(got["factors"]) == 23 * K

    def test_one_copy_per_chunk_and_residency(self, panels, monkeypatch):
        """Each chunk's outputs reach the host in one `.cpu()`; the stream
        residency gives the hbm frames bitwise; `params` replace the
        model's weights; the sampled reconstruction is seeded."""
        _, tp = panels
        _, _, tcfg, model = _rig("mse", False)
        hbm = PanelDataset(tp, seq_len=T, device="cpu")
        copies = []
        cpu = torch.Tensor.cpu

        def counted(self, *a, **kw):
            copies.append(tuple(self.shape))
            return cpu(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, "cpu", counted)
        a = decompose(model, tcfg, hbm, chunk=8, seed=4)
        monkeypatch.setattr(torch.Tensor, "cpu", cpu)
        n_days = len(hbm.split_days(None, None))
        assert len(copies) == -(-n_days // 8)
        b = decompose(model, tcfg, PanelDataset(tp, seq_len=T, device="cpu",
                                                residency="stream"), chunk=8, seed=4)
        for k in a:
            pd.testing.assert_frame_equal(a[k], b[k])
        c = decompose(FactorVAE(tcfg.model), tcfg, hbm, chunk=8, seed=4,
                      params=dict(model.named_parameters()))
        for k in a:
            pd.testing.assert_frame_equal(a[k], c[k])
        other = decompose(model, tcfg, hbm, chunk=8, seed=5)
        assert not np.array_equal(other["loss"]["recon"], a["loss"]["recon"])
        pd.testing.assert_frame_equal(other["factors"], a["factors"])
        with pytest.raises(ValueError, match="decompose was asked"):
            decompose(model, tcfg, hbm, device="cuda")

    def test_leaves_the_callers_model_mode(self, panels):
        """The decomposition reads no module mode and sets none: a model in
        train mode stays so, and gives the frames of one in eval mode."""
        _, tp = panels
        _, _, tcfg, model = _rig("nll", False)
        hbm = PanelDataset(tp, seq_len=T, device="cpu")
        want = decompose(model, tcfg, hbm, chunk=8)
        model.train()
        got = decompose(model, tcfg, hbm, chunk=8)
        assert model.training and all(m.training for m in model.modules())
        for k in want:
            pd.testing.assert_frame_equal(got[k], want[k])
