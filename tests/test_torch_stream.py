"""The stream residency and the panel append of the port, on the CPU, against
the JAX package and against the port's own "hbm" residency.

Shapes: C 8, T 5, H 8, K 4, M 8 on a 30-day synthetic panel of 12 stocks
(padded to 16) with missing rows; inputs from numpy seeds. Within the port
every stream result is held bitwise against the "hbm" one (parameters,
histories, scores, the CSV): the stream path moves the same numbers through
the same device gather. Against the JAX package: the host twins, the
mini-panel and the chunking bitwise (integer selection); the stream
`Trainer`'s losses at rtol 2e-5 (the Trainer parity bound of
`test_torch_train.py`); stream scores at rtol 1e-5 / atol 1e-6 (the
torch-oracle tolerance); the extended dataset's values and fill maps and
the store's values and validity equal. The JAX store's dates are not the
oracle: under pandas 3 they come back in the wrong unit (ROADMAP Queue 3),
so the port's dates are held against the source panel.

The CPU path of `ChunkStream` is the card's with the copy as the identity;
its pinned copies, events and `record_stream` are tested on the card in
`tests/test_torch_cuda.py::TestChunkStreamOnCard`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.data import append as jappend
from factorvae_tpu.data import stream as jstream
from factorvae_tpu.data import windows as jwindows
from factorvae_tpu.data.panel import Panel as JPanel
from factorvae_tpu.eval.predict import predict_panel as jpredict_panel
from factorvae_tpu.models.factorvae import load_model as jload_model
from factorvae_tpu.train.trainer import Trainer as JTrainer
from factorvae_tpu_torch import chaos
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data import AppendError, PanelStore
from factorvae_tpu_torch.data import stream, windows
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.eval.predict import predict_panel, predict_panel_fleet
from factorvae_tpu_torch.models.factorvae import FactorVAE
from factorvae_tpu_torch.params import flax_to_torch
from factorvae_tpu_torch.serve.daemon import ScoringDaemon
from factorvae_tpu_torch.serve.registry import ModelRegistry
from factorvae_tpu_torch.train.fleet import FleetTrainer
from factorvae_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, T, H, K, M = 8, 5, 8, 4, 8
D, N = 30, 12
LOSS_RTOL = 2e-5
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


def _port_panel(jp) -> Panel:
    return Panel(values=jp.values, valid=jp.valid,
                 dates=jp.dates.values.astype("datetime64[D]"),
                 instruments=np.asarray(jp.instruments))


@pytest.fixture(scope="module")
def panels():
    jp = synthetic_panel(num_days=D, num_instruments=N, num_features=C,
                         missing_prob=0.2, seed=5)
    return jp, _port_panel(jp)


@pytest.fixture(scope="module")
def ds_pair(panels):
    _, tp = panels
    return (PanelDataset(tp, seq_len=T, device="cpu"),
            PanelDataset(tp, seq_len=T, device="cpu", residency="stream"))


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _history(out) -> list:
    return [{k: v for k, v in r.items() if k not in ("seconds", "days_per_sec",
                                                     "seed_days_per_sec")}
            for r in out["history"]]


def _config(tp, save_dir, residency="hbm", days_per_step=1, epochs=2, chunk_days=8,
            **train) -> tconfig.Config:
    d = [str(x) for x in tp.dates]
    kw = dict(num_epochs=epochs, lr=1e-3, seed=3, days_per_step=days_per_step,
              checkpoint_every=0, save_dir=str(save_dir))
    kw.update(train)
    return tconfig.Config(
        model=tconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                  num_portfolios=M, seq_len=T),
        data=tconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[19],
                                val_start_time=d[20], val_end_time=d[29],
                                panel_residency=residency, stream_chunk_days=chunk_days),
        train=tconfig.TrainConfig(**kw))


def _fit_pair(tp, tmp_path, **kw):
    """(hbm, stream) of (trainer, state, out) for the same config."""
    runs = []
    for r in ("hbm", "stream"):
        cfg = _config(tp, tmp_path / r, residency=r, **kw)
        tr = Trainer(cfg, PanelDataset(tp, seq_len=T, device="cpu", residency=r),
                     device="cpu")
        state, out = tr.fit()
        runs.append((tr, state, out))
    return runs


def _same_params(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


# ---------------------------------------------------------------------------
# the host twins and the mini-panel


class TestHostTwins:
    def test_fill_indices_match_jax(self, panels):
        """Valid masks with gaps, early days (window before day 0)."""
        jp, tp = panels
        ds = PanelDataset(tp, seq_len=T, device="cpu", residency="stream")
        for day in range(D):
            got = windows.fill_indices_host(ds.valid, day, T)
            assert _same(got, jwindows.fill_indices_host(ds.valid, day, T))
            fill = windows.window_fill_indices_np(ds.last_valid_np, ds.next_valid_np, day, T)
            assert _same(fill, jwindows.window_fill_indices_np(
                ds.last_valid_np, ds.next_valid_np, day, T))
            # the oracle's resolvable positions take the same rows
            ok = got >= 0
            assert np.array_equal(fill[ok], got[ok])

    def test_gather_days_host_matches_jax_and_the_device_gather(self, ds_pair):
        hbm, st = ds_pair
        days = np.array([0, 3, 17, -1, 29, 2, -1], np.int32)
        got = st.gather_batch_host(days)
        want = jwindows.gather_days_host(st.values_np, st.last_valid_np, st.next_valid_np,
                                         days, T)
        assert all(_same(a, b) for a, b in zip(got, want))
        x, y, mask = hbm.gather(torch.as_tensor(np.maximum(days, 0), dtype=torch.int64))
        real = days >= 0
        assert _same(got[0][real], x.numpy()[real]) and _same(got[1][real], y.numpy()[real])
        assert _same(got[2], mask.numpy() & real[:, None])
        for d in (0, 17):
            assert all(_same(a.numpy(), b.numpy())
                       for a, b in zip(st.day_batch(d), hbm.day_batch(d)))

    def test_chunk_mini_panel_matches_jax(self, ds_pair):
        _, st = ds_pair
        days = np.random.default_rng(1).permutation(D).astype(np.int32)[:9]
        days = np.concatenate([days, [-1, -1]]).astype(np.int32)
        args = (st.values_np, st.last_valid_np, st.next_valid_np, days, T)
        got = windows.chunk_mini_panel(*args)
        want = jwindows.chunk_mini_panel(*args)
        assert all(_same(a, b) for a, b in zip(got, want))
        out = np.empty_like(want[1])
        into = windows.chunk_mini_panel(*args, out=out)
        assert into[1] is out and _same(out, want[1])

    @pytest.mark.parametrize("lanes", [None, 3], ids=["serial", "fleet_of_3"])
    def test_mini_panel_gather_is_the_panel_gather(self, ds_pair, lanes):
        """Every chunk of an epoch order, a short tail included, gathers
        bitwise what the whole panel gathers; a fleet's lanes, stacked along
        the day axis, each their own days."""
        hbm, st = ds_pair
        days = hbm.split_days(None, None)
        orders = np.stack([hbm.epoch_order(days, True, s, 0, pad_to=4).reshape(-1, 4)
                           for s in range(lanes or 1)])
        order = orders if lanes else orders[0]
        seen = 0
        for mini, local in stream.epoch_chunks(st, order, 3):
            assert isinstance(mini, stream.MiniPanel)
            local = local if lanes else local[None]
            for s in range(local.shape[0]):
                for i in range(local.shape[1]):
                    want_days = torch.as_tensor(orders[s, seen + i])
                    got = mini.gather(torch.clamp(local[s, i], min=0))
                    want = hbm.gather(torch.clamp(want_days, min=0))
                    real = (want_days >= 0).numpy()
                    for a, b in zip(got, want):
                        assert _same(a.numpy()[real], b.numpy()[real])
                    assert _same((local[s, i] >= 0).numpy(), real)
            seen += local.shape[1]
        assert seen == orders.shape[1] == 8 and st.last_stream.n_chunks == 3

    def test_chunk_slices_match_jax(self):
        for n, k in ((0, 3), (1, 1), (7, 3), (9, 3), (50, 16)):
            assert stream.chunk_slices(n, k) == jstream.chunk_slices(n, k)
        with pytest.raises(ValueError):
            stream.chunk_slices(5, 0)

    def test_stream_dataset_keeps_no_device_panel(self, ds_pair, panels):
        hbm, st = ds_pair
        for name in ("values", "last_valid", "next_valid"):
            assert not hasattr(st, name)
            with pytest.raises(AttributeError, match="residency='stream'"):
                getattr(st, name)
        with pytest.raises(AttributeError, match="only under residency='stream'"):
            hbm.values_np
        with pytest.raises(ValueError, match="residency"):
            PanelDataset(panels[1], seq_len=T, device="cpu", residency="disk")
        assert st.panel_nbytes == hbm.panel_nbytes == 16 * D * (C + 1) * 4
        assert st.dead_compute_frac == hbm.dead_compute_frac == 0.25
        days = np.array([4, 0, 29])
        assert _same(st.day_labels(days), hbm.day_labels(days))
        assert np.array_equal(st.last_valid_np, st.last_valid_np.astype(np.int32))
        assert _same(st.last_valid_np.astype(np.int64), hbm.last_valid.numpy())


# ---------------------------------------------------------------------------
# ChunkStream


def _marked_stream(n):
    def make_chunk(i, alloc):
        a = alloc("values", (3, 2), np.float32)
        a[...] = i
        b = alloc("order", (i + 1,), np.int64)
        b[...] = i
        return a, b

    return stream.ChunkStream(make_chunk, n, "cpu")


class TestChunkStream:
    def test_order_tail_empty_and_ledger(self):
        s = _marked_stream(5)
        got = [(float(a[0, 0]), len(b)) for a, b in s]
        assert got == [(float(i), i + 1) for i in range(5)]
        st = s.stats()
        assert st["chunks"] == 5 and st["bytes_put"] == 5 * 24 + 8 * 15
        assert st["retries"] == 0 and st["copy_seconds"] == 0 and st["h2d_gb_per_s"] is None
        assert 0.0 <= s.overlap_frac <= 1.0
        assert list(_marked_stream(0)) == []
        a, _ = next(iter(_marked_stream(1)))
        assert a.device.type == "cpu" and not a.is_pinned()

    def test_stream_fail_retries_once_with_the_same_chunks(self):
        want = [float(a[0, 0]) for a, _ in _marked_stream(4)]
        with chaos.active(chaos.ChaosPlan([chaos.Fault("stream_fail", chunk=1)])) as plan:
            s = _marked_stream(4)
            got = [float(a[0, 0]) for a, _ in s]
        assert got == want and s.retries == 1
        assert plan.fired == [{"kind": "stream_fail", "chunk": 1}]

    def test_a_failure_on_every_attempt_raises(self, monkeypatch):
        monkeypatch.setattr(stream.ChunkStream, "RETRY_BACKOFF_S", 0.001)
        plan = chaos.ChaosPlan([chaos.Fault("stream_fail", chunk=2, times=-1)])
        s = _marked_stream(4)
        seen = []
        with chaos.active(plan), pytest.raises(RuntimeError, match="chunk 2"):
            for a, _ in s:
                seen.append(float(a[0, 0]))
        assert seen == [0.0, 1.0] and s.retries == stream.ChunkStream.MAX_RETRIES

    def test_stream_stall_raises_wait_seconds(self):
        with chaos.active(chaos.ChaosPlan([chaos.Fault("stream_stall", chunk=0,
                                                       delay_s=0.05)])):
            s = _marked_stream(3)
            assert [float(a[0, 0]) for a, _ in s] == [0.0, 1.0, 2.0]
        assert s.chunk_wait_seconds[0] - s.chunk_produce_seconds[0] >= 0.05

    def test_a_stall_is_booked_whole_when_the_consumer_is_late(self, monkeypatch):
        """The consumer held up after its submits (as a descheduled thread
        is): chunk 0's wait runs from its submit, so it still holds the
        whole 50 ms stall of the worker's first produce."""
        import concurrent.futures.thread as cft

        submit = cft.ThreadPoolExecutor.submit

        def late(self, *args, **kwargs):
            fut = submit(self, *args, **kwargs)
            time.sleep(0.02)
            return fut

        monkeypatch.setattr(cft.ThreadPoolExecutor, "submit", late)
        with chaos.active(chaos.ChaosPlan([chaos.Fault("stream_stall", chunk=0,
                                                       delay_s=0.05)])):
            s = _marked_stream(3)
            assert [float(a[0, 0]) for a, _ in s] == [0.0, 1.0, 2.0]
        assert s.chunk_wait_seconds[0] - s.chunk_produce_seconds[0] >= 0.05

    def test_a_chunk_stays_held_while_the_consumer_keeps_it(self):
        """A chunk's slot follows its tensors, not the generator: chunk 0 is
        still held after the consumer took chunk 1, until its last tensor
        (or a view of it) goes."""
        s = _marked_stream(3)
        it = iter(s)
        a0, b0 = next(it)
        assert s.held_chunks() == [0]
        a1, b1 = next(it)
        assert s.held_chunks() == [0, 1]
        del a0
        assert s.held_chunks() == [0, 1]
        view = b0[:1]
        del b0
        assert s.held_chunks() == [0, 1]
        del view
        assert s.held_chunks() == [1]
        del a1, b1
        assert [float(a[0, 0]) for a, _ in it] == [2.0]
        assert s.held_chunks() == []

    def test_an_unported_kind_is_still_refused(self):
        with pytest.raises(ValueError, match="unknown chaos fault kind 'kill_everything'"):
            chaos.Fault("kill_everything")


# ---------------------------------------------------------------------------
# the trainer, fleets and scoring: stream against hbm


class TestTrainerStream:
    @pytest.mark.parametrize("days_per_step,dtype", [(1, "float32"), (4, "float32"),
                                                     (1, "bfloat16")],
                             ids=["dps1_f32", "dps4_f32", "dps1_mixed_bf16"])
    def test_stream_equals_hbm_bitwise(self, panels, tmp_path, days_per_step, dtype):
        """With dropout and the sampled loss; chunks of 8 days: 8, 8, 4 steps
        at days_per_step 1, 2, 2, 1 at 4 (short tails)."""
        _, tp = panels
        (tr_h, st_h, out_h), (tr_s, st_s, out_s) = _fit_pair(
            tp, tmp_path, days_per_step=days_per_step, compute_dtype=dtype)
        assert tr_s.stream and not tr_h.stream
        assert tr_s.steps_per_chunk == 8 // days_per_step
        assert _same_params(st_h.model, st_s.model)
        assert _history(out_h) == _history(out_s)
        assert out_h["best_val"] == out_s["best_val"]
        if dtype == "bfloat16":
            assert st_h.loss_scale == st_s.loss_scale and tr_s.mixed
        stats = tr_s.last_stream_stats.stats()
        assert stats["chunks"] == 3 and stats["bytes_put"] > 0 and tr_h.last_stream_stats is None
        m_h = tr_h.evaluate(st_h.model)
        assert m_h == tr_s.evaluate(st_s.model)

    def test_nan_grads_rollback_trail_equals_hbm(self, panels, tmp_path):
        _, tp = panels
        plan = [chaos.Fault("nan_grads", epoch=1), chaos.Fault("nan_grads", epoch=2)]
        runs = []
        for r in ("hbm", "stream"):
            cfg = _config(tp, tmp_path / r, residency=r, epochs=4, checkpoint_every=1,
                          recover_after=2)
            tr = Trainer(cfg, PanelDataset(tp, seq_len=T, device="cpu", residency=r),
                         device="cpu")
            with chaos.active(chaos.ChaosPlan(plan)):
                runs.append(tr.fit())
        (st_h, out_h), (st_s, out_s) = runs
        trail = [r["epoch"] for r in out_s["history"]]
        assert trail == [r["epoch"] for r in out_h["history"]] == [0, 1, 2, 1, 2, 3]
        assert _history(out_h) == _history(out_s) and _same_params(st_h.model, st_s.model)

    def test_resume_equals_the_unbroken_run(self, panels, tmp_path):
        _, tp = panels

        def trainer(name):
            cfg = _config(tp, tmp_path / name, residency="stream", epochs=3,
                          checkpoint_every=1)
            return Trainer(cfg, PanelDataset(tp, seq_len=T, device="cpu", residency="stream"),
                           device="cpu")

        full, full_out = trainer("full").fit()
        trainer("part").fit(num_epochs=2)
        resumed, res_out = trainer("part").fit(resume=True)
        assert [r["epoch"] for r in res_out["history"]] == [2]
        assert _history(res_out) == _history(full_out)[2:]
        assert _same_params(full.model, resumed.model)

    def test_tracks_the_jax_stream_trainer(self, panels, tmp_path):
        """From the same Flax weights, deterministic (dropout 0, the NLL),
        two epochs in chunks of 8 days on both sides."""
        jp, tp = panels
        d = [str(x) for x in tp.dates]
        jcfg = jconfig.Config(
            model=jconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                      num_portfolios=M, seq_len=T, dropout_rate=0.0,
                                      recon_loss="nll"),
            data=jconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[19],
                                    val_start_time=d[20], val_end_time=d[29],
                                    panel_residency="stream", stream_chunk_days=8),
            train=jconfig.TrainConfig(num_epochs=2, lr=1e-3, seed=3, checkpoint_every=0,
                                      recover_after=0, save_dir=str(tmp_path / "jax")))
        jtr = JTrainer(jcfg, JPanelDataset(jp, seq_len=T, residency="stream"))
        jstate = jtr.init_state()
        weights = flax_to_torch(jstate.params)
        _, jout = jtr.fit(state=jstate)
        cfg = tconfig.Config.from_dict(jcfg.to_dict())
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, save_dir=str(tmp_path / "port")))
        tr = Trainer(cfg, PanelDataset(tp, seq_len=T, device="cpu", residency="stream"),
                     device="cpu")
        assert tr.steps_per_chunk == jtr.steps_per_chunk
        state = tr.init_state()
        state.model.load_state_dict(weights)
        _, out = tr.fit(state=state)
        got = [(r["train_loss"], r["val_loss"]) for r in out["history"]]
        want = [(r["train_loss"], r["val_loss"]) for r in jout["history"]]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        assert tr.last_stream_stats.n_chunks == jtr.last_stream_stats.n_chunks == 3


class TestFleetStream:
    @pytest.mark.parametrize("seeds", [[1, 2, 3], [4]], ids=["S3", "S1"])
    def test_fleet_stream_equals_hbm_bitwise(self, panels, tmp_path, seeds):
        _, tp = panels
        runs = []
        for r in ("hbm", "stream"):
            cfg = _config(tp, tmp_path / r, residency=r)
            ft = FleetTrainer(cfg, PanelDataset(tp, seq_len=T, device="cpu", residency=r),
                              seeds=seeds, device="cpu")
            runs.append((ft, *ft.fit()))
        (ft_h, st_h, out_h), (ft_s, st_s, out_s) = runs
        assert all(torch.equal(st_h.params[n], st_s.params[n]) for n in st_h.params)
        assert _history(out_h) == _history(out_s)
        assert _same(out_h["best_val"], out_s["best_val"])
        assert ft_s.last_stream_stats.n_chunks == 3 and ft_h.last_stream_stats is None


@pytest.fixture(scope="module")
def jrig(panels):
    """Flax weights of a JAX model, the port's model with them, both configs."""
    jp, tp = panels
    jcfg = jconfig.Config(model=jconfig.ModelConfig(
        num_features=C, hidden_size=H, num_factors=K, num_portfolios=M, seq_len=T,
        use_pallas_gru=False, use_pallas_attention=False), data=jconfig.DataConfig(seq_len=T))
    _, params = jload_model(jcfg, n_max=8)
    tcfg = tconfig.Config(model=tconfig.ModelConfig(
        num_features=C, hidden_size=H, num_factors=K, num_portfolios=M, seq_len=T),
        data=tconfig.DataConfig(seq_len=T))
    model = FactorVAE(tcfg.model)
    model.load_state_dict(flax_to_torch(params))
    return jcfg, params, tcfg, model.eval()


class TestScoringStream:
    @pytest.mark.parametrize("kw", [dict(stochastic=False), dict(stochastic=True, seed=5),
                                    dict(stochastic=False, int8=True)],
                             ids=["deterministic", "stochastic", "int8"])
    def test_predict_panel_stream_equals_hbm(self, ds_pair, jrig, kw):
        hbm, st = ds_pair
        _, _, tcfg, model = jrig
        days = hbm.split_days(None, None)
        a = predict_panel(model, tcfg, hbm, days, chunk=8, **kw)
        b = predict_panel(model, tcfg, st, days, chunk=8, **kw)
        assert _same(a, b) and st.last_stream.n_chunks == 4
        assert predict_panel(model, tcfg, st, days[:0]).shape == (0, 16)

    def test_predict_panel_fleet_stream_equals_hbm(self, ds_pair, jrig):
        hbm, st = ds_pair
        _, _, tcfg, model = jrig
        params = {n: torch.stack([p.detach(), 1.5 * p.detach()])
                  for n, p in model.named_parameters()}
        days = hbm.split_days(None, None)
        for stochastic in (False, True):
            a = predict_panel_fleet(params, tcfg, hbm, days, stochastic=stochastic, seed=2)
            b = predict_panel_fleet(params, tcfg, st, days, stochastic=stochastic, seed=2)
            assert a.shape == (2, D, 16) and _same(a, b)

    def test_matches_the_jax_stream_predict_panel(self, panels, ds_pair, jrig):
        jp, _ = panels
        _, st = ds_pair
        jcfg, params, tcfg, model = jrig
        days = st.split_days(None, None)
        want = jpredict_panel(params, jcfg, JPanelDataset(jp, seq_len=T, residency="stream"),
                              days, stochastic=False, chunk=8)
        got = predict_panel(model, tcfg, st, days, stochastic=False, chunk=8)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, **SCORE_TOL)


# ---------------------------------------------------------------------------
# the append: extend_days, PanelStore, the daemon


def _split(tp, at, drop_instrument=None):
    """(head, tail) Panels of the days [0, at) and [at, D); the tail without
    `drop_instrument` when given (it must be aligned back in)."""
    head = Panel(values=tp.values[:, :at], valid=tp.valid[:at], dates=tp.dates[:at],
                 instruments=tp.instruments)
    keep = np.arange(len(tp.instruments))
    if drop_instrument is not None:
        keep = keep[keep != drop_instrument]
    tail = Panel(values=tp.values[keep, at:], valid=tp.valid[at:, keep],
                 dates=tp.dates[at:], instruments=tp.instruments[keep])
    return head, tail


def _jpanel(p: Panel) -> JPanel:
    return JPanel(values=p.values, valid=p.valid, dates=pd.DatetimeIndex(p.dates),
                  instruments=np.asarray(p.instruments))


class TestExtendDays:
    @pytest.mark.parametrize("residency", ["hbm", "stream"])
    def test_matches_jax_extend_days_and_a_fresh_dataset(self, panels, residency):
        jp, tp = panels
        head, tail = _split(tp, 24, drop_instrument=5)
        ds = PanelDataset(head, seq_len=T, device="cpu", residency=residency)
        assert ds.extend_days(tail)
        jds = JPanelDataset(_jpanel(head), seq_len=T, residency=residency)
        assert jds.extend_days(_jpanel(tail))
        fresh = PanelDataset(tp, seq_len=T, device="cpu", residency=residency)
        fresh.valid[24:, 5] = False         # the dropped instrument's new days
        if residency == "stream":
            got = (ds.values_np, ds.last_valid_np, ds.next_valid_np)
            want = (jds.values_np, jds.last_valid_np, jds.next_valid_np)
        else:
            got = tuple(t.numpy() for t in (ds.values, ds.last_valid, ds.next_valid))
            want = tuple(np.asarray(a) for a in (jds.values, jds.last_valid, jds.next_valid))
            want = (want[0], want[1].astype(np.int64), want[2].astype(np.int64))
        assert all(_same(a, b) for a, b in zip(got, want))
        assert _same(ds.valid, jds.valid) and _same(ds.valid, fresh.valid)
        assert np.isnan(got[0][5, 24:]).all() and not ds.valid[24:, 5].any()
        assert _same(ds.dates, tp.dates) and len(ds.split_days(None, None)) == D

    def test_no_op_and_overlap_error(self, panels):
        _, tp = panels
        head, tail = _split(tp, 24)
        ds = PanelDataset(head, seq_len=T, device="cpu", residency="stream")
        assert ds.extend_days(tail) and not ds.extend_days(tail)
        assert not ds.extend_days(_split(tp, 27)[1])          # a suffix: present
        with pytest.raises(ValueError, match="strictly newer"):
            PanelDataset(head, seq_len=T, device="cpu").extend_days(_split(tp, 20)[1])
        alien = dataclasses.replace(tail, instruments=np.asarray(
            ["X"] + list(tail.instruments[1:])))
        with pytest.raises(AppendError, match="never seen"):
            ds.extend_days(alien)


_APPEND_CHILD = r"""
import sys
import numpy as np
from factorvae_tpu_torch.data import PanelStore
from factorvae_tpu_torch.data.panel import Panel
z = np.load(sys.argv[2])
PanelStore(sys.argv[1]).append_panel(Panel(values=z["values"], valid=z["valid"],
                                           dates=z["dates"], instruments=z["instruments"]))
print("appended")
"""


class TestPanelStore:
    def test_round_trip_is_exact_and_values_match_the_jax_store(self, panels, tmp_path):
        _, tp = panels
        head, tail = _split(tp, 24)
        store = PanelStore.create(str(tmp_path / "port"), head)
        rec = store.append_panel(tail)
        assert rec["name"] == "slab_00002.npz" and store.generation == 2
        assert (rec["start"], rec["end"]) == (str(tp.dates[24]), str(tp.dates[-1]))
        loaded = PanelStore(str(tmp_path / "port")).load_panel(verify=True)
        assert _same(loaded.values, tp.values) and _same(loaded.valid, tp.valid)
        assert _same(loaded.dates, tp.dates) and loaded.dates.dtype == "datetime64[D]"
        assert list(loaded.instruments) == list(tp.instruments)
        assert store.end_date == tp.dates[-1] and store.num_days == D
        jstore = jappend.PanelStore.create(str(tmp_path / "jax"), _jpanel(head))
        jstore.append_panel(_jpanel(tail))
        jloaded = jstore.load_panel()
        assert _same(loaded.values, jloaded.values) and _same(loaded.valid, jloaded.valid)
        assert _same(store.load_slab(rec).values, tp.values[:, 24:])

    def test_verify_catches_a_flipped_byte(self, panels, tmp_path):
        _, tp = panels
        store = PanelStore.create(str(tmp_path / "s"), _split(tp, 24)[0])
        assert store.verify() is None
        path = os.path.join(str(tmp_path / "s"), "slabs", "slab_00001.npz")
        chaos.ops.corrupt_file(path, rng_seed=3, n_bytes=1)
        assert store.verify() == "sha256 mismatch: slab_00001.npz"
        with pytest.raises(AppendError, match="failed verification"):
            store.load_panel(verify=True)
        with pytest.raises(AppendError, match="failed sha256"):
            store.load_slab(store.slabs[0])

    def test_idempotent_reappend_and_overlap_errors(self, panels, tmp_path):
        _, tp = panels
        head, tail = _split(tp, 24)
        store = PanelStore.create(str(tmp_path / "s"), head)
        rec = store.append_panel(tail)
        assert store.append_panel(tail) == rec and store.generation == 2
        with pytest.raises(AppendError, match="strictly newer"):
            store.append_panel(_split(tp, 27)[1])
        changed = dataclasses.replace(tail, values=tail.values + 1)
        with pytest.raises(AppendError, match="other bytes"):
            store.append_panel(changed)
        with pytest.raises(AppendError, match="already exists"):
            PanelStore.create(str(tmp_path / "s"), head)
        with pytest.raises(AppendError, match="no panel store"):
            PanelStore(str(tmp_path / "none"))

    @pytest.mark.parametrize("step", [0, 1])
    def test_kill_mid_append_then_the_rerun_commits(self, panels, tmp_path, step):
        """A SIGKILL before the slab (step 0) or between the slab and the
        manifest (step 1, an orphan slab): the store still reads as before,
        and the re-run appends."""
        _, tp = panels
        head, tail = _split(tp, 24)
        root = str(tmp_path / "s")
        PanelStore.create(root, head)
        piece = str(tmp_path / "piece.npz")
        np.savez(piece, values=tail.values, valid=tail.valid, dates=tail.dates,
                 instruments=np.asarray(tail.instruments, str))
        env = {k: v for k, v in os.environ.items() if k != chaos.ENV_VAR}
        env["PYTHONPATH"] = REPO
        killed = subprocess.run(
            [sys.executable, "-c", _APPEND_CHILD, root, piece],
            env={**env, chaos.ENV_VAR: json.dumps(
                {"faults": [{"kind": "kill_mid_append", "step": step}]})},
            capture_output=True, text=True, timeout=120)
        assert killed.returncode == -9 and "appended" not in killed.stdout
        orphan = os.path.join(root, "slabs", "slab_00002.npz")
        assert os.path.exists(orphan) == (step == 1)
        assert PanelStore(root).generation == 1 and PanelStore(root).verify() is None
        rerun = subprocess.run([sys.executable, "-c", _APPEND_CHILD, root, piece], env=env,
                               capture_output=True, text=True, timeout=120)
        assert rerun.returncode == 0, rerun.stderr
        loaded = PanelStore(root).load_panel(verify=True)
        assert _same(loaded.values, tp.values) and _same(loaded.dates, tp.dates)

    def test_corrupt_append_slab_aborts_before_the_manifest(self, panels, tmp_path):
        _, tp = panels
        head, tail = _split(tp, 24)
        store = PanelStore.create(str(tmp_path / "s"), head)
        with chaos.active(chaos.ChaosPlan([chaos.Fault("corrupt_append_slab")])):
            with pytest.raises(AppendError, match="failed sha256 validation"):
                store.append_panel(tail)
        assert store.generation == 1 and PanelStore(str(tmp_path / "s")).generation == 1
        assert not os.path.exists(os.path.join(str(tmp_path / "s"), "slabs",
                                               "slab_00002.npz"))
        assert store.append_panel(tail)["name"] == "slab_00002.npz"
        assert store.verify() is None


class TestDaemonExtend:
    @pytest.mark.parametrize("residency", ["hbm", "stream"])
    def test_a_new_day_scores_as_on_a_fresh_dataset(self, panels, jrig, residency):
        _, tp = panels
        _, _, tcfg, model = jrig
        head, tail = _split(tp, 26)
        registry = ModelRegistry(device="cpu")
        registry.admit(model, tcfg, alias="m")
        daemon = ScoringDaemon(registry, PanelDataset(head, seq_len=T, device="cpu",
                                                      residency=residency))
        day = str(tp.dates[28])
        (before,) = daemon.handle_batch([{"id": 1, "model": "m", "day": day}])
        assert not before["ok"] and "not in the serving panel" in before["error"]
        assert daemon.extend_dataset(tail) and not daemon.extend_dataset(tail)
        (resp,) = daemon.handle_batch([{"id": 2, "model": "m", "day": day}])
        fresh = PanelDataset(tp, seq_len=T, device="cpu", residency=residency)
        want = predict_panel(model, tcfg, fresh, np.array([28]), stochastic=False)[0]
        valid = np.nonzero(tp.valid[28])[0]
        assert resp["ok"] and resp["results"][0]["instruments"] == list(
            tp.instruments[valid])
        assert _same(np.asarray(resp["results"][0]["scores"], np.float32), want[valid])
        assert daemon.stats()["panel"]["n_days"] == D


# ---------------------------------------------------------------------------
# the CLI


def test_cli_stream_csv_is_the_hbm_csv(panels, tmp_path):
    from factorvae_tpu_torch import cli
    from factorvae_tpu_torch.data.panel import panel_to_frame

    _, tp = panels
    pkl = str(tmp_path / "panel.pkl")
    panel_to_frame(tp).to_pickle(pkl)
    d = [str(x) for x in tp.dates]
    csvs, epochs = [], []
    for name, extra in (("hbm", []), ("stream", ["--panel_residency", "stream",
                                                 "--stream_chunk_days", "8"])):
        out = tmp_path / name
        argv = ["--dataset", pkl, "--device", "cpu", "--num_latent", str(C),
                "--hidden_size", str(H), "--num_factor", str(K), "--num_portfolio", str(M),
                "--seq_len", str(T), "--start_time", d[0], "--fit_end_time", d[19],
                "--val_start_time", d[20], "--val_end_time", d[25], "--score_start", d[10],
                "--score_end", d[29], "--num_epochs", "2", "--lr", "1e-3", "--seed", "3",
                "--save_dir", str(out / "models"), "--score_dir", str(out / "scores"),
                "--metrics_jsonl", str(out / "run.jsonl"), *extra]
        assert cli.main(argv) == 0
        with open(out / "run.jsonl") as fh:
            events = [json.loads(line) for line in fh]
        (scores,) = [e for e in events if e["event"] == "scores"]
        with open(scores["path"], "rb") as fh:
            csvs.append(fh.read())
        epochs.append([(e["train_loss"], e["val_loss"]) for e in events
                       if e["event"] == "epoch"])
        (layout,) = [e for e in events if e["event"] == "execution_layout"]
        assert layout["panel_residency"] == name
    assert csvs[0] == csvs[1] and len(csvs[0]) > 100 and epochs[0] == epochs[1]
