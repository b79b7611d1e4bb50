"""The port's profiling (`utils/profiling.py`, `utils/trace_summary.py`) on
the CPU: the summary of a hand-written Kineto trace (the format a capture
on the card writes: kernel, memcpy and memset events by category,
`python_function` frames, host ops and annotations) and of a real CPU
capture; the one-capture-per-process rule; a capture started on one thread
recording another thread's ops (the daemon's case); the trainers'
`PROFILE_REQUEST` hook and its `profile_capture` record; the daemon's
`POST /profile` answers; anomaly mode as `debug_nans`. Captures on the
card, where CUPTI adds the kernels, are checked by `chip_smoke.py`; its
launch accounting, which books each kernel record to a wrapper's launch by
correlation id, is held here on hand-written traces.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from factorvae_tpu.data import synthetic_panel
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.serve.daemon import _profile_answer
from factorvae_tpu_torch.train.fleet import FleetTrainer
from factorvae_tpu_torch.train.trainer import Trainer
from factorvae_tpu_torch.utils import profiling, trace_summary
from factorvae_tpu_torch.utils.logging import MetricsLogger

C, T = 6, 5


def _kineto_fixture(path, gz=False):
    """A trace shaped as Kineto writes one on the card: a host process
    (OS pid) and a device process (pid 0) whose streams are tids."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 4242, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": "Spans",
         "tid": "PyTorch Profiler", "ts": 0, "dur": 9000},
        {"ph": "X", "cat": "python_function", "name": "train.py(12): step", "pid": 4242,
         "tid": 4242, "ts": 1, "dur": 5000},
        {"ph": "X", "cat": "user_annotation", "name": "gru_fwd_residuals", "pid": 4242,
         "tid": 4242, "ts": 2, "dur": 40},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 4242, "tid": 4242,
         "ts": 50, "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 4242,
         "tid": 4242, "ts": 55, "dur": 6},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 4242,
         "tid": 4242, "ts": 65, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "gru_fwd_kernel<true>", "pid": 0, "tid": 7,
         "ts": 60, "dur": 50.5},
        {"ph": "X", "cat": "kernel", "name": "gru_fwd_kernel<true>", "pid": 0, "tid": 7,
         "ts": 120, "dur": 49.5},
        {"ph": "X", "cat": "kernel", "name": "ampere_sgemm_64x64_nn", "pid": 0, "tid": 7,
         "ts": 200, "dur": 12},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "pid": 0,
         "tid": 13, "ts": 10, "dur": 8},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)",
         "pid": 0, "tid": 7, "ts": 300, "dur": 3},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "pid": 0,
         "tid": 7, "ts": 310, "dur": 2},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "tid": 7,
         "ts": 320, "dur": 1},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "gru_fwd_residuals", "pid": 0,
         "tid": 7, "ts": 60, "dur": 51},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": 4242, "tid": 4242, "ts": 55, "id": 1},
    ]
    body = json.dumps({"schemaVersion": 1, "traceEvents": ev})
    if gz:
        with gzip.open(path, "wt") as fh:
            fh.write(body)
    else:
        with open(path, "w") as fh:
            fh.write(body)


class TestTraceSummary:
    @pytest.mark.parametrize("gz", [False, True], ids=["json", "gz"])
    def test_a_kineto_trace(self, tmp_path, gz):
        name = "host_1.123.pt.trace.json" + (".gz" if gz else "")
        _kineto_fixture(str(tmp_path / name), gz=gz)
        s = trace_summary.summarize_trace(str(tmp_path))
        assert len(s["files"]) == 1 and s["device_pids"] == {0: "python"}
        assert s["host_pids"] == {4242: "python"} and s["num_lanes"] == 1
        by = {n: (us, c) for n, us, c in s["by_name"]}
        assert by["gru_fwd_kernel<true>"] == (100.0, 2)
        assert by["ampere_sgemm_64x64_nn"] == (12.0, 1) and by["Memset (Device)"] == (1.0, 1)
        assert "gru_fwd_residuals" not in by and "aten::mm" not in by
        assert s["total_us"] == 100 + 12 + 8 + 3 + 2 + 1
        assert s["transfer"] == {"h2d_us": 8.0, "d2h_us": 3.0, "other_us": 2.0, "count": 3}
        host = {n: (us, c) for n, us, c in s["host_by_name"]}
        assert host == {"gru_fwd_residuals": (40.0, 1), "aten::mm": (30.0, 1),
                        "cudaLaunchKernel": (11.0, 2)}
        assert s["host_us"] == 81.0
        everything = trace_summary.summarize_trace(str(tmp_path), device_only=False)
        assert everything["total_us"] == s["total_us"] + s["host_us"]
        assert trace_summary.summarize_trace(str(tmp_path), top=1)["by_name"] == [
            ("gru_fwd_kernel<true>", 100.0, 2)]

    def test_the_cli_on_a_fixture_and_on_nothing(self, tmp_path, capsys):
        _kineto_fixture(str(tmp_path / "a.pt.trace.json"))
        assert trace_summary.main([str(tmp_path), "--top", "3"]) == 0
        out = capsys.readouterr().out
        assert "gru_fwd_kernel<true>" in out and "H2D 0.008 ms" in out
        assert "host time   : 0.081 ms" in out
        empty = tmp_path / "empty"
        empty.mkdir()
        assert trace_summary.main([str(empty)]) == 1
        assert "no .trace.json" in capsys.readouterr().out

    def test_a_real_cpu_capture_takes_every_lane(self, tmp_path):
        with profiling.trace(str(tmp_path / "cap")):
            with profiling.step_annotation("my_step"):
                a = torch.randn(64, 64)
                (a @ a).sum()
        s = trace_summary.summarize_trace(str(tmp_path / "cap"))
        assert len(s["files"]) == 1 and s["files"][0].endswith(".pt.trace.json")
        by = {n: c for n, _, c in s["by_name"]}
        assert by.get("my_step") == 1 and "aten::mm" in by and s["total_us"] > 0
        assert s["host_us"] == 0.0 and s["transfer"]["count"] == 0
        assert not any(n.startswith("PyTorch Profiler") for n in by)


class TestCapture:
    def test_one_capture_per_process(self, tmp_path):
        with pytest.raises(profiling.ProfilerError, match="no profile capture is running"):
            profiling.stop_profile()
        d = profiling.start_profile(str(tmp_path / "a"))
        try:
            with pytest.raises(profiling.ProfilerError, match="already running"):
                profiling.start_profile(str(tmp_path / "b"))
            with pytest.raises(profiling.ProfilerError, match="already running"):
                with profiling.trace(str(tmp_path / "c")):
                    pass
            torch.ones(3).add(1)
        finally:
            out = profiling.stop_profile(top=3)
        assert out["log_dir"] == d and out["files"] == 1 and len(out["top"]) <= 3
        assert out["total_us"] > 0 and all(len(row) == 3 for row in out["top"])
        tmp = profiling.start_profile()                 # a fresh temporary dir
        assert os.path.isdir(tmp) and profiling.stop_profile()["files"] == 1
        shutil.rmtree(tmp)

    def test_a_capture_records_another_threads_ops(self, tmp_path):
        """The daemon starts a capture on an HTTP thread while its ticks run
        on the scheduler's thread, which started before the capture."""
        go, done = threading.Event(), threading.Event()

        def tick():
            go.wait(30)
            with profiling.step_annotation("tick_thread_work"):
                torch.randn(16, 16).sum()
            done.set()

        worker = threading.Thread(target=tick)
        worker.start()
        profiling.start_profile(str(tmp_path / "cap"))
        go.set()
        done.wait(30)
        out = profiling.stop_profile(top=50)
        worker.join(30)
        assert "tick_thread_work" in {row[0] for row in out["top"]}

    def test_poll_consumes_the_request(self, tmp_path):
        assert profiling.poll_profile_request(None) is None
        assert profiling.poll_profile_request(str(tmp_path)) is None
        req = tmp_path / profiling.PROFILE_REQUEST_BASENAME
        req.write_text('{"log_dir": "/x"}')
        assert profiling.poll_profile_request(str(tmp_path)) == {"log_dir": "/x"}
        assert not req.exists()
        req.write_text("garbled{")
        assert profiling.poll_profile_request(str(tmp_path)) == {}

    def test_a_request_while_a_capture_runs_is_an_error_not_a_crash(self, tmp_path):
        (tmp_path / profiling.PROFILE_REQUEST_BASENAME).write_text("")
        with profiling.trace(str(tmp_path / "whole_run")):
            with profiling.maybe_profile_epoch(str(tmp_path), 3) as (prof, detail):
                ran = True
        assert ran and prof is False and "already running" in detail

    def test_daemon_profile_answers(self, tmp_path):
        assert _profile_answer({"action": "bogus"})[0] == 400
        assert _profile_answer([])[0] == 400
        code, body = _profile_answer({"action": "stop"})
        assert code == 409 and not body["ok"]
        code, body = _profile_answer({"action": "start", "log_dir": str(tmp_path / "p")})
        assert code == 200 and body == {"ok": True, "action": "start",
                                        "log_dir": str(tmp_path / "p")}
        assert _profile_answer({"action": "start"})[0] == 409
        torch.ones(2).mul(3)
        code, body = _profile_answer({"action": "stop", "top": 2})
        assert code == 200 and body["files"] == 1 and len(body["top"]) == 2


@pytest.fixture(scope="module")
def tp():
    jp = synthetic_panel(num_days=30, num_instruments=9, num_features=C,
                         missing_prob=0.1, seed=2)
    return Panel(values=jp.values, valid=jp.valid,
                 dates=jp.dates.values.astype("datetime64[D]"),
                 instruments=np.asarray(jp.instruments))


def _cfg(tp, tmp_path, epochs=2):
    d = [str(x) for x in tp.dates]
    return tconfig.Config(
        model=tconfig.ModelConfig(num_features=C, hidden_size=8, num_factors=4,
                                  num_portfolios=6, seq_len=T),
        data=tconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[19],
                                val_start_time=d[20], val_end_time=d[29]),
        train=tconfig.TrainConfig(num_epochs=epochs, lr=1e-3, seed=1, days_per_step=4,
                                  checkpoint_every=0, save_dir=str(tmp_path / "m")))


@pytest.mark.parametrize("fleet", [False, True], ids=["trainer", "fleet"])
def test_profile_request_captures_the_next_epoch(tp, tmp_path, fleet):
    """A PROFILE_REQUEST beside the metrics stream: the next train epoch
    runs under a capture, and its `profile_capture` record carries the
    summary; the other epochs are untouched."""
    path = tmp_path / "run.jsonl"
    logger = MetricsLogger(jsonl_path=str(path), echo=False)
    (tmp_path / profiling.PROFILE_REQUEST_BASENAME).write_text("")
    ds = PanelDataset(tp, seq_len=T, device="cpu")
    if fleet:
        FleetTrainer(_cfg(tp, tmp_path), ds, seeds=(1, 2), device="cpu", logger=logger).fit()
    else:
        Trainer(_cfg(tp, tmp_path), ds, device="cpu", logger=logger).fit()
    logger.finish()
    recs = [json.loads(x) for x in open(path)]
    (cap,) = [r for r in recs if r["event"] == "profile_capture"]
    assert cap["epoch"] == 0 and cap["dir"] == str(tmp_path / "profile_epoch0")
    assert cap["files"] == 1 and cap["total_us"] > 0 and 0 < len(cap["top"]) <= 5
    assert not (tmp_path / profiling.PROFILE_REQUEST_BASENAME).exists()
    if not fleet:       # the serial trainer names its epoch on the profiler's timeline
        s = trace_summary.summarize_trace(cap["dir"], top=200)
        assert "train_epoch_0" in {n for n, _, _ in s["by_name"]}


def test_no_stream_no_poll(tp, tmp_path, monkeypatch):
    """Without a metrics stream the epoch loop never looks for a request."""
    polled = []
    monkeypatch.setattr(profiling, "poll_profile_request",
                        lambda run_dir: polled.append(run_dir))
    Trainer(_cfg(tp, tmp_path, epochs=1), PanelDataset(tp, seq_len=T, device="cpu"),
            device="cpu").fit()
    assert polled in ([], [None])


class TestDebugNans:
    def test_raises_on_a_nan_returned_by_a_backward_function(self):
        class Poison(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * 2

            @staticmethod
            def backward(ctx, g):
                return g * float("nan")

        x = torch.ones(3, requires_grad=True)
        with profiling.debug_nans():
            with pytest.raises(RuntimeError, match="nan"):
                Poison.apply(x).sum().backward()
        assert not torch.is_anomaly_enabled()
        Poison.apply(x).sum().backward()            # off again: no raise
        assert torch.isnan(x.grad).all()

    def test_does_not_raise_on_a_forward_nan_or_a_poison_after_backward(self):
        """The two differences from `jax_debug_nans` (ROADMAP Queue 3)."""
        x = torch.ones(3, requires_grad=True)
        with profiling.debug_nans():
            y = x * float("nan")                      # a NaN forward value
            assert torch.isnan(y).all()
            (x * 2).sum().backward()
            x.grad.mul_(float("nan"))                 # the nan_grads poison
        assert torch.isnan(x.grad).all()

    def test_a_trainer_epoch_runs_under_it(self, tp, tmp_path):
        cfg = _cfg(tp, tmp_path, epochs=1)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, obs_probes=True))
        with profiling.debug_nans():
            _, out = Trainer(cfg, PanelDataset(tp, seq_len=T, device="cpu"),
                             device="cpu").fit()
        assert np.isfinite(out["history"][0]["train_loss"])


def _launch(tid, ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "pid": 1,
            "tid": tid, "ts": ts, "dur": 4, "args": {"correlation": corr}}


def _kernel(name, ts, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": ts,
            "dur": 30, "args": {"correlation": corr}}


def _range(tid, ts, dur=20):
    return {"ph": "X", "cat": "user_annotation", "name": "gru_dwh", "pid": 1, "tid": tid,
            "ts": ts, "dur": dur}


@pytest.mark.parametrize("case", ["device_clock_leads", "device_clock_trails",
                                  "record_dropped", "calls_on_another_thread"])
def test_capture_books_each_kernel_by_its_launch_call(case, tmp_path):
    """chip_smoke.py's launch accounting places a kernel record on the host's
    clock by its launch call's correlation id, not by its own start (the
    device's clock converted, which can lead or trail the host's): a record
    that starts before its range counts for that range, a warm-up range's
    record that starts after the counted range's start does not, and a
    range whose record CUPTI dropped is `lost` and named in `unrecorded`,
    also where the launch calls carry another thread id than the ranges
    (a capture started on another thread, as the daemon's is)."""
    from chip_smoke import _check_counts, _launch_accounting

    dwh, reduce = "void gru_dwh_kernel<true>(float const*)", "void gru_dwh_reduce_kernel()"
    before = {}
    if case == "device_clock_leads":     # the kernel's start precedes its range's
        ev = [_range(3, 100), _launch(3, 105, 7), _kernel(dwh, 98, 7),
              _launch(3, 112, 8), _kernel(reduce, 130, 8)]
        want = {"kernels": 1, "lost": 0, "unrecorded": 0, "before_launch": 1}
    elif case == "device_clock_trails":  # the warm-up's kernel runs after the count starts
        ev = [_range(3, 0), _launch(3, 2, 1), _kernel(dwh, 150, 1),
              _range(3, 100), _launch(3, 105, 2), _kernel(dwh, 190, 2)]
        before = {"gru_dwh": 1}
        want = {"kernels": 1, "lost": 0, "unrecorded": 0, "before_launch": 0}
    else:
        t = 3 if case == "record_dropped" else 9
        ev = [_range(3, 100), _launch(t, 105, 2), _kernel(dwh, 115, 2),
              _range(3, 200), _launch(t, 205, 3)]
        want = {"kernels": 1, "lost": 1, "unrecorded": 1, "before_launch": 0}
    counted = {"gru_dwh": 2 if case in ("record_dropped", "calls_on_another_thread") else 1}
    with open(tmp_path / "cap.pt.trace.json", "w") as fh:
        json.dump({"traceEvents": ev}, fh)
    acct = _launch_accounting(str(tmp_path), counted, before)
    a = acct["gru_dwh"]
    assert (a["kernels"], a["lost"], len(a["unrecorded"]), acct["kernel_before_launch"]) == (
        want["kernels"], want["lost"], want["unrecorded"], want["before_launch"])
    _check_counts(case, acct, counted, before)
