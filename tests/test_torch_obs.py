"""The port's observability on the CPU, against the JAX package: the drift
monitors, the trace plane, the Prometheus exposition, the `Timeline`
records of a daemon tick, and the timeline records of the stream, the
panel store and the daemon's panel extension.

Every comparison with the JAX package is exact: the same numbers from
`rank_correlation` and `score_digest` on ties, NaN, constant and too-short
vectors; the same header parses and `sample_keep` verdicts for 1,000 trace
ids; byte-equal histogram text; the same span names, ids and parents for the
same daemon tick (C 8, T 5, H 8, K 4, M 8 on a 30-day panel of 12 stocks,
Flax weights copied in with `flax_to_torch`).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from factorvae_tpu import config as jconfig
from factorvae_tpu.data import PanelDataset as JPanelDataset
from factorvae_tpu.data import synthetic_panel
from factorvae_tpu.models.factorvae import load_model as jload_model
from factorvae_tpu.obs import drift as jdrift
from factorvae_tpu.obs import metrics as jmetrics
from factorvae_tpu.obs import timeline as jtimeline
from factorvae_tpu.obs import trace as jtrace
from factorvae_tpu.serve.daemon import ScoringDaemon as JScoringDaemon
from factorvae_tpu.serve.registry import ModelRegistry as JModelRegistry
from factorvae_tpu.utils import logging as jlogging
from factorvae_tpu_torch import chaos
from factorvae_tpu_torch import config as tconfig
from factorvae_tpu_torch.data import PanelStore, stream
from factorvae_tpu_torch.data.loader import PanelDataset
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.obs import drift, metrics, trace
from factorvae_tpu_torch.params import flax_to_torch
from factorvae_tpu_torch.serve.daemon import ScoringDaemon
from factorvae_tpu_torch.serve.registry import ModelRegistry
from factorvae_tpu_torch.utils import logging as tlogging

C, T, H, K, M = 8, 5, 8, 4, 8
D, N = 30, 12


# ---------------------------------------------------------------------------
# drift


_VECTORS = {
    "distinct": (np.arange(10.0), np.arange(10.0)[::-1] ** 2),
    "ties": (np.array([1, 1, 2, 2, 3, 3, 3, 4.0]), np.array([2, 1, 1, 3, 3, 5, 4, 4.0])),
    "nan": (np.array([0.3, np.nan, 0.1, 0.7, 0.2, np.inf]),
            np.array([1.0, 2.0, np.nan, 0.5, 0.4, 3.0])),
    "constant": (np.ones(6), np.arange(6.0)),
    "too_short": (np.array([1.0, 2.0, np.nan]), np.array([3.0, 1.0, 2.0])),
    "empty": (np.zeros(0), np.zeros(0)),
    "random": tuple(np.random.default_rng(3).standard_normal((2, 40)).round(1)),
}


@pytest.mark.parametrize("case", sorted(_VECTORS))
def test_rank_correlation_and_digest_equal_jax(case):
    a, b = _VECTORS[case]
    assert drift.rank_correlation(a, b) == jdrift.rank_correlation(a, b)
    assert drift.score_digest(a) == jdrift.score_digest(a)


def test_drift_monitor_walk_equals_jax():
    rng = np.random.default_rng(0)
    names = [f"s{i}" for i in range(12)]
    base = rng.standard_normal(12)
    days = [base, base + 0.01 * rng.standard_normal(12), rng.standard_normal(12),
            base, -base]
    mons = (drift.ScoreDriftMonitor(threshold=0.3), jdrift.ScoreDriftMonitor(threshold=0.3))
    for m in mons:
        m.set_threshold("b", 0.9)
        for day, vals in enumerate(days):
            for model in ("a", "b"):
                m.observe(model, day, names, vals)
        m.observe("a", 1, names, days[3])        # a repeat is free
    assert mons[0].stats() == mons[1].stats()
    assert [mons[0].drifting(k) for k in "ab"] == [mons[1].drifting(k) for k in "ab"]


# ---------------------------------------------------------------------------
# the trace plane


def test_trace_context_and_header_equal_jax():
    ctx = trace.root_ctx("r-000042")
    assert ctx == jtrace.root_ctx("r-000042")
    kid = trace.child(trace.child(ctx, "f0"), "q3")
    assert kid == jtrace.child(jtrace.child(ctx, "f0"), "q3")
    assert trace.span_fields(kid, x=1) == jtrace.span_fields(kid, x=1)
    assert trace.span_fields(None, x=1) == jtrace.span_fields(None, x=1) == {"x": 1}
    for hdr in (trace.format_header(kid), "a;b", " a ; b ", "a;", ";b", "ab", "", None):
        assert trace.parse_header(hdr) == jtrace.parse_header(hdr)
    for req in ({"trace": {"trace_id": "t", "span_id": "s"}}, {"trace": {"trace_id": 1}},
                {"trace": "t;s"}, {}, None, "x"):
        assert trace.wire_ctx(req) == jtrace.wire_ctx(req)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.99, 1.0])
def test_sample_keep_equals_jax_on_1000_ids(rate):
    ids = [f"d-{i:06d}" for i in range(1000)]
    got = [trace.sample_keep(t, rate) for t in ids]
    assert got == [jtrace.sample_keep(t, rate) for t in ids]
    assert all(trace.sample_keep(t, rate, breach=True) for t in ids[:50])


# ---------------------------------------------------------------------------
# the exposition


def test_latency_histogram_text_is_jax_byte_for_byte():
    obs = [0.0004, 0.001, 0.0031, 0.02, 0.02, 0.3, 7.0, 12.5]
    mine, theirs = metrics.LatencyHistogram(), jmetrics.LatencyHistogram()
    for i, s in enumerate(obs):
        tid = f"d-{i:06d}" if i % 3 == 0 else None
        mine.observe(s, trace_id=tid)
        theirs.observe(s, trace_id=tid)
    assert mine.DEFAULT_BUCKETS == theirs.DEFAULT_BUCKETS
    lab = {"model": 'a"b\\c'}
    assert mine.render("x_seconds", lab) == theirs.render("x_seconds", lab)
    assert mine.count == theirs.count == len(obs)
    fam = [("f", "gauge", "help", [metrics.metric_line("f", v) for v in (1, 2.5, None,
                                                                          float("inf"))]),
           ("g", "counter", "none", [])]
    assert metrics.render_families(fam) == jmetrics.render_families(fam)
    for sample in ('a{x="1"} 2', "a 2", "a{} 3"):
        assert (metrics.inject_labels(sample, {"worker_id": "w0"})
                == jmetrics.inject_labels(sample, {"worker_id": "w0"}))


# ---------------------------------------------------------------------------
# a daemon tick on both timelines


@pytest.fixture(scope="module")
def rig():
    jp = synthetic_panel(num_days=D, num_instruments=N, num_features=C,
                         missing_prob=0.2, seed=5)
    tp = Panel(values=jp.values, valid=jp.valid,
               dates=jp.dates.values.astype("datetime64[D]"),
               instruments=np.asarray(jp.instruments))
    models = []
    for seed in (0, 1, 2):
        jcfg = jconfig.Config(
            model=jconfig.ModelConfig(num_features=C, hidden_size=H, num_factors=K,
                                      num_portfolios=M, seq_len=T,
                                      stochastic_inference=False),
            data=jconfig.DataConfig(seq_len=T), train=jconfig.TrainConfig(seed=seed))
        tcfg = tconfig.Config.from_dict(jcfg.to_dict())
        models.append((jcfg, tcfg, jload_model(jcfg, n_max=16)[1]))
    return dict(jds=JPanelDataset(jp, seq_len=T), tds=PanelDataset(tp, seq_len=T, device="cpu"),
                models=models, tp=tp)


def _daemons(rig):
    jreg, treg = JModelRegistry(), ModelRegistry(device="cpu")
    for i, (jcfg, tcfg, params) in enumerate(rig["models"]):
        jreg.register_params(params, jcfg, alias=f"m{i}")
        treg.register_params(flax_to_torch(params), tcfg, alias=f"m{i}")
    return JScoringDaemon(jreg, rig["jds"]), ScoringDaemon(treg, rig["tds"])


_TICK = [{"id": 1, "model": "m0", "day": 20}, {"id": 2, "model": "m1", "day": 20},
         {"id": 3, "model": "m2", "days": [21, 22]},
         {"id": 4, "model": "m0", "day": 20, "trace": {"trace_id": "wf-c00001",
                                                       "span_id": "judge"}},
         {"id": 5, "cmd": "ping"}, {"id": 6, "model": "ghost", "day": 3}]


def _serve_spans(path):
    run = jtimeline.load_run(path)
    keep = ("name", "cat", "resource", "trace", "span", "parent", "traces", "members",
            "models", "n_days", "requests")
    return [{k: s.get(k) for k in keep} for s in run["spans"]
            if s.get("cat") == "serve" and not s["name"].startswith("serve_score:")], run


def test_daemon_tick_timeline_matches_jax_and_renders(rig, tmp_path, capsys):
    jd, td = _daemons(rig)
    got = {}
    for side, d, log_mod in (("jax", jd, jlogging), ("port", td, tlogging)):
        path = str(tmp_path / f"{side}.jsonl")
        logger = log_mod.MetricsLogger(jsonl_path=path, echo=False, run_name="serve")
        prev = log_mod.install_timeline(log_mod.Timeline(logger))
        try:
            d.handle_batch(_TICK)
        finally:
            log_mod.install_timeline(prev)
            logger.finish()
        got[side] = _serve_spans(path)
    spans, run = got["port"]
    assert [s["name"] for s in spans].count("serve_request") == 6
    assert spans == got["jax"][0]
    # the JAX renderer reads the port's stream unchanged
    assert run["_stats"]["bad"] == 0 and run["meta"][0]["platform"] == "cpu"
    assert "serve" in jtimeline.format_report(run)
    # the port's own trace renderer draws the traced request's tree
    assert trace.main([str(tmp_path / "port.jsonl"), "--trace", "wf-c00001"]) == 0
    out = capsys.readouterr().out
    assert "trace wf-c00001" in out and "serve_dispatch" in out and "serve_request" in out
    assert trace.main([str(tmp_path / "port.jsonl"), "--slowest", "2", "--stages"]) == 0
    assert "serve_tick" in capsys.readouterr().out


def test_span_helpers_are_no_ops_without_a_timeline():
    assert tlogging.current_timeline() is None and tlogging.timeline_now() is None
    with tlogging.timeline_span("x"):
        tlogging.timeline_event("y")
    tlogging.timeline_span_at("z", 0.0, 1.0)
    assert tlogging.timeline_span_begin("q") is None
    tlogging.timeline_span_end(None)


def test_cross_thread_span_token(tmp_path):
    path = str(tmp_path / "run.jsonl")
    logger = tlogging.MetricsLogger(jsonl_path=path, echo=False)
    prev = tlogging.install_timeline(tlogging.Timeline(logger))
    try:
        tok = tlogging.timeline_span_begin("serve_queue", cat="serve", resource="scheduler",
                                           span="a")
        tlogging.timeline_span_end(tok, outcome="cancelled")
        assert tlogging.timeline_now() >= 0
    finally:
        tlogging.install_timeline(prev)
        logger.finish()
    (span,) = jtimeline.load_run(path)["spans"]
    assert (span["name"], span["resource"], span["span"], span["outcome"]) == (
        "serve_queue", "scheduler", "a", "cancelled")
    assert span["t1"] >= span["t0"] and span["dur"] >= 0


# ---------------------------------------------------------------------------
# the stream's, the store's and the daemon's records


def _installed(tmp_path, fn):
    path = str(tmp_path / "run.jsonl")
    logger = tlogging.MetricsLogger(jsonl_path=path, echo=False)
    prev = tlogging.install_timeline(tlogging.Timeline(logger))
    try:
        fn()
    finally:
        tlogging.install_timeline(prev)
        logger.finish()
    return jtimeline.load_run(path)


def test_stream_spans_and_retry_mark(tmp_path, monkeypatch):
    monkeypatch.setattr(stream.ChunkStream, "RETRY_BACKOFF_S", 0.001)

    def make_chunk(i, alloc):
        a = alloc("values", (3, 2), np.float32)
        a[...] = i
        return (a,)

    def run():
        with chaos.active(chaos.ChaosPlan([chaos.Fault("stream_fail", chunk=1)])):
            assert [float(a[0, 0]) for (a,) in stream.ChunkStream(make_chunk, 3, "cpu")] \
                == [0.0, 1.0, 2.0]

    rec = _installed(tmp_path, run)
    produce = [s for s in rec["spans"] if s["name"] == "chunk_produce"]
    wait = [s for s in rec["spans"] if s["name"] == "chunk_wait"]
    assert sorted(s["chunk"] for s in produce) == [0, 1, 2]
    assert all(s["resource"] == "stream" and s["bytes"] == 24 for s in produce)
    assert [s["chunk"] for s in wait] == [0, 1, 2]
    assert all(s["resource"] == "stream_wait" for s in wait)
    (retry,) = [m for m in rec["marks"] if m["name"] == "stream_retry"]
    assert retry["chunk"] == 1 and retry["attempt"] == 1
    assert jtimeline.recovery_marks(rec) == [retry]


def test_append_and_extend_marks(rig, tmp_path):
    tp = rig["tp"]

    def piece(lo, hi):
        return Panel(values=tp.values[:, lo:hi], valid=tp.valid[lo:hi],
                     dates=tp.dates[lo:hi], instruments=tp.instruments)

    def run():
        store = PanelStore.create(str(tmp_path / "store"), piece(0, 26))
        store.append_panel(piece(26, 28))
        with chaos.active(chaos.ChaosPlan([chaos.Fault("corrupt_append_slab")])):
            with pytest.raises(Exception, match="sha256"):
                store.append_panel(piece(28, 30))
        _, td = _daemons(rig)
        td.dataset = PanelDataset(piece(0, 28), seq_len=T, device="cpu")
        assert td.extend_dataset(piece(28, 30)) and not td.extend_dataset(piece(28, 30))

    rec = _installed(tmp_path, run)
    names = [m["name"] for m in rec["marks"]]
    # the store's first slab, the append, then the rejected one
    assert names.count("append_slab") == 2 and names.count("append_slab_rejected") == 1
    first, slab = [m for m in rec["marks"] if m["name"] == "append_slab"]
    assert first["days"] == 26 and (slab["days"], slab["start"]) == (2, str(tp.dates[26]))
    (ext,) = [m for m in rec["marks"] if m["name"] == "serve_extend"]
    assert ext["n_days"] == D


def test_build_taxonomy_counts(monkeypatch, tmp_path):
    """`compile` counts a library that `build` compiled here (nvcc stands in
    as a script that writes its -o file), `compile_cached` one that `load`
    found already built; each library loads once per process."""
    from factorvae_tpu_torch import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then shift; '
                    ': > "$1"; fi; shift; done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_compiled", set())
    monkeypatch.setattr(_build, "_counts", {"compile": 0, "compile_cached": 0})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    (tmp_path / "libbuilt.so").write_bytes(b"")
    for name in ("built", "fresh", "fresh", "built"):
        _build.load(name)
    assert (tmp_path / "libfresh.so").exists()
    assert _build.compile_event_counts() == {"compile": 1, "compile_cached": 1}


# ---------------------------------------------------------------------------
# the run readers (report, timeline, live) against the JAX readers


def _trainer_stream(tmp_path, name="port_run.jsonl", faults=(1,)):
    """A metrics stream written by the port's Trainer with a timeline: stream
    residency (stream lanes), checkpoints every epoch (checkpoint lane),
    probes on, and a `nan_grads` epoch that the rollback answers."""
    from factorvae_tpu_torch.train.trainer import Trainer

    jp = synthetic_panel(num_days=36, num_instruments=11, num_features=6,
                         missing_prob=0.2, seed=4)
    tp = Panel(values=jp.values, valid=jp.valid,
               dates=jp.dates.values.astype("datetime64[D]"),
               instruments=np.asarray(jp.instruments))
    d = [str(x) for x in tp.dates]
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(num_features=6, hidden_size=8, num_factors=4,
                                  num_portfolios=10, seq_len=T),
        data=tconfig.DataConfig(seq_len=T, start_time=d[0], fit_end_time=d[24],
                                val_start_time=d[25], val_end_time=d[35],
                                stream_chunk_days=8),
        train=tconfig.TrainConfig(num_epochs=4, lr=1e-3, seed=2, days_per_step=4,
                                  recover_after=1, checkpoint_every=1, obs_probes=True,
                                  save_dir=str(tmp_path / "models")))
    path = str(tmp_path / name)
    logger = tlogging.MetricsLogger(jsonl_path=path, echo=False)
    prev = tlogging.install_timeline(tlogging.Timeline(logger))
    try:
        ds = PanelDataset(tp, seq_len=T, device="cpu", residency="stream")
        with chaos.active(chaos.ChaosPlan([chaos.Fault("nan_grads", epoch=e)
                                           for e in faults])):
            Trainer(cfg, ds, device="cpu", logger=logger).fit()
        tlogging.timeline_compile("gru_fwd", 0.0, 1.5)
        tlogging.timeline_compile("attention_fwd", 0.0, 0.01, cached=True)
    finally:
        tlogging.install_timeline(prev)
        logger.finish()
    return path


def _flagged_stream(tmp_path, base):
    """`base` plus the records every other flag reads, and a torn tail."""
    recs = [json.loads(x) for x in open(base)]
    epochs = [r for r in recs if r["event"] == "epoch"]
    extra = []
    last = dict(epochs[-1])
    for e in range(4, 9):      # a grad spike, a slow epoch, a diverging val loss
        rec = dict(last, epoch=e, val_loss=last["val_loss"] * (1.5 if e > 5 else 1.0),
                   grad_norm_max=last["grad_norm_mean"] * (50 if e == 6 else 1),
                   days_per_sec=last["days_per_sec"] * (0.1 if e == 7 else 1.0))
        extra.append(rec)
    extra += [
        {"event": "fleet_epoch", "epoch": 0, "train_loss": [1.0, float("nan")],
         "val_loss": [1.0, 2.0], "skipped_steps": [0.0, 3.0], "nonfinite_grads": [0.0, 9.0],
         "loss_scale": [1024.0, 1.0], "loss_scale_floor_steps": [0.0, 5.0],
         "lane_labels": ["seed=1", "seed=2"], "seed_days_per_sec": 10.0},
        {"event": "mark", "name": "circuit_open", "cat": "recovery", "resource": "serve",
         "t": 9.0, "model": "m0"},
        {"event": "mark", "name": "score_drift", "cat": "serve", "resource": "serve",
         "t": 9.5, "model": "m0", "rank_corr": 0.1, "threshold": 0.5},
        {"event": "mark", "name": "ckpt_quarantine", "cat": "recovery",
         "resource": "checkpoint", "t": 9.7, "step": 3},
    ]
    path = os.path.join(os.path.dirname(base), "flagged.jsonl")
    with open(path, "w") as fh:
        for r in recs:
            fh.write(json.dumps(r) + "\n")
        for r in extra:
            fh.write(json.dumps(r) + "\n")
        fh.write('{"event": "epoch", "epoch": 9, "train_lo')      # torn
    return path


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("streams")
    base = _trainer_stream(tmp)
    empty = tmp / "empty.jsonl"
    empty.write_text("")
    garbage = tmp / "garbage.jsonl"
    garbage.write_text("not json\nat all\n")
    return {"port_trainer": base, "flagged": _flagged_stream(tmp, base),
            "empty": str(empty), "garbage": str(garbage)}


def _run_main(mod, argv, capsys):
    rc = mod.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


_READERS = [("report", []), ("report", ["--json"]), ("timeline", []),
            ("timeline", ["--json"]), ("live", []), ("live", ["--json"])]


@pytest.mark.parametrize("stream_name", ["port_trainer", "flagged", "empty", "garbage"])
@pytest.mark.parametrize("reader,flags", _READERS,
                         ids=[f"{r}{'_json' if f else ''}" for r, f in _READERS])
def test_readers_give_the_jax_readers_output(streams, capsys, stream_name, reader, flags):
    """The same stream through the JAX reader and the port's: the same exit
    code, stdout and stderr (the torn tail's warning included)."""
    import importlib

    jmod = importlib.import_module(f"factorvae_tpu.obs.{reader}")
    tmod = importlib.import_module(f"factorvae_tpu_torch.obs.{reader}")
    path = streams[stream_name]
    want = _run_main(jmod, [path, *flags], capsys)
    got = _run_main(tmod, [path, *flags], capsys)
    assert got == want


def test_a_port_trainer_stream_reads_the_same_flags_in_both_reports(streams):
    from factorvae_tpu.obs import report as jreport

    from factorvae_tpu_torch.obs import report, timeline

    run, warnings = timeline.open_run(streams["port_trainer"])
    assert warnings == []
    rep = report.build_report(run)
    jrep = jreport.build_report(jtimeline.open_run(streams["port_trainer"])[0])
    assert json.dumps(rep, sort_keys=True, default=str) == json.dumps(
        jrep, sort_keys=True, default=str)
    flags = {(f["flag"], f["epoch"]) for f in rep["flags"]}
    # the poisoned epoch 1: non-finite gradients, every step skipped, a rollback
    assert {("nonfinite", 1), ("skip_step", 1), ("rollback", 1)} <= flags
    names = {s["name"] for s in run["spans"]}
    assert {"train_epoch_0", "val_epoch_0", "chunk_produce", "ckpt_save_0"} <= names
    lanes = {s["resource"] for s in run["spans"]}
    assert {"device", "stream", "checkpoint", "compile"} <= lanes
    comp = timeline.compile_summary(run)
    assert comp["records"] == 1 and comp["by_fn"]["gru_fwd"]["compiles"] == 1
    assert comp["by_fn"]["gru_fwd"]["wall_s"] == 1.5


def test_live_follow_tails_a_growing_stream_to_the_report(streams, tmp_path):
    """`LiveMonitor` fed a stream in pieces (a torn line cut mid-record and
    finished later) ends at the post-hoc report's flags."""
    from factorvae_tpu_torch.obs import live, report, timeline

    data = open(streams["flagged"], "rb").read()
    path = tmp_path / "growing.jsonl"
    path.write_bytes(b"")
    mon = live.LiveMonitor()
    offset = 0
    for cut in (len(data) // 3, len(data) // 3 + 7, len(data)):
        with open(path, "ab") as fh:
            fh.write(data[offset:cut])
        offset = cut
        payload, _ = live.tail_bytes(str(path), 0)
        assert payload.endswith(b"\n") or payload == b""
    mon = live.follow_run(str(path), follow=False)
    want = report.build_report(timeline.open_run(str(path))[0])["flags"]
    strip = [{k: f[k] for k in ("flag", "epoch", "detail")} for f in want]
    assert [{k: f[k] for k in ("flag", "epoch", "detail")}
            for f in mon.current_flags()] == strip


def test_textfile_exporter_is_jax_byte_for_byte(tmp_path):
    recs = [
        {"epoch": 3, "step": 120, "train_loss": 0.5, "val_loss": float("nan"),
         "grad_norm_max": 1.25e-3, "nonfinite_grads": 0.0, "skipped_steps": 2.0,
         "flag": True, "note": "text", "_private": 1.0},
        {"epoch": 0, "step": 10, "train_loss": [0.5, float("inf"), 1e-9],
         "lr": [1e-3, 3e-4, 1e-4], "lane_labels": ["seed=1 lr=0.001", "a\"b", "c\\d"],
         "seed_days_per_sec": 12.5},
    ]
    for i, rec in enumerate(recs):
        paths = tmp_path / f"port{i}" / "x.prom", tmp_path / f"jax{i}" / "x.prom"
        exp, jexp = metrics.TextfileExporter(str(paths[0])), jmetrics.TextfileExporter(
            str(paths[1]))
        for _ in range(2):
            exp.export_epoch(rec)
            jexp.export_epoch(rec)
        assert paths[0].read_bytes() == paths[1].read_bytes()
        assert not os.path.exists(str(paths[0]) + ".tmp")
    prev = metrics.install_exporter(metrics.TextfileExporter(str(tmp_path / "inst.prom")))
    try:
        metrics.export_epoch_metrics(recs[0])
    finally:
        metrics.install_exporter(prev)
    assert "factorvae_train_train_loss 0.5" in (tmp_path / "inst.prom").read_text()
    metrics.export_epoch_metrics(recs[0])          # nothing installed: a no-op


def test_build_and_export_write_compile_records(monkeypatch, tmp_path):
    """A stand-in nvcc build writes one `compile` record per library it
    built, a library found built one `compile_cached`; a torch.export one
    `compile`; the JAX `compile_summary` and program flags read them."""
    from factorvae_tpu.obs import report as jreport

    from factorvae_tpu_torch import _build
    from factorvae_tpu_torch.eval.export_aot import export_prediction
    from factorvae_tpu_torch.models.factorvae import FactorVAE

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then shift; '
                    ': > "$1"; fi; shift; done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_compiled", set())
    monkeypatch.setattr(_build, "_counts", {"compile": 0, "compile_cached": 0})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    (tmp_path / "libbuilt.so").write_bytes(b"")
    cfg = tconfig.Config(model=tconfig.ModelConfig(num_features=4, hidden_size=4,
                                                   num_factors=2, num_portfolios=3,
                                                   seq_len=3))
    model = FactorVAE(cfg.model)
    model.reset_parameters(__import__("torch").Generator().manual_seed(0))

    def run():
        _build.load("fresh")
        _build.load("built")
        export_prediction(model, cfg, n_max=5, platform="cpu")

    rec = _installed(tmp_path, run)
    comp = [r for r in rec["events"] if r["event"] in ("compile", "compile_cached")]
    assert [(r["event"], r["fn"], r["cached"]) for r in comp] == [
        ("compile", "fresh", False), ("compile_cached", "built", True),
        ("compile", f"export:{cfg.checkpoint_name()}", False)]
    for r in comp:
        assert r["wall_s"] >= 0 and r["compiles"] == 1
        assert all(r[k] is None for k in ("flops", "peak_bytes", "lower_s", "compile_s"))
    summary = jtimeline.compile_summary(rec)
    assert summary["records"] == 2 and summary["max_peak_bytes"] is None
    assert jreport.program_flags(rec) == [] and jtimeline.recovery_marks(rec) == []
    assert {s["name"] for s in rec["spans"]} == {
        "build:fresh", "build:built", f"build:export:{cfg.checkpoint_name()}"}


def test_watermark_is_a_no_op_on_the_cpu(tmp_path):
    from factorvae_tpu_torch.obs import memory

    assert memory.device_memory_stats() is None
    assert memory.watermark_event(epoch=0) is False
    rec = _installed(tmp_path, lambda: memory.watermark_event(epoch=1))
    assert rec["marks"] == []


# ---------------------------------------------------------------------------
# GET /runstream and the fleet collector


def test_runstream_serves_whole_lines_from_an_offset(tmp_path):
    import http.client
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    from factorvae_tpu_torch.obs import collect
    from factorvae_tpu_torch.serve.daemon import _serve_runstream

    path = tmp_path / "run.jsonl"
    logger = tlogging.MetricsLogger(jsonl_path=str(path), echo=False)
    prev = tlogging.install_timeline(tlogging.Timeline(logger))

    class H(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            _serve_runstream(self)

        def log_message(self, *a):
            pass

    server = HTTPServer(("127.0.0.1", 0), H)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05})
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        tlogging.timeline_event("one", n=1)
        tlogging.timeline_event("two", n=2)
        with open(path, "a") as fh:
            fh.write('{"event": "mark", "name": "thr')           # a torn last line
            fh.flush()
        recs, nxt = collect.fetch_runstream(url, 0)
        assert [r["name"] for r in recs if r["event"] == "mark"] == ["one", "two"]
        assert nxt == len(open(path, "rb").read().rsplit(b"\n", 1)[0]) + 1
        with open(path, "a") as fh:
            fh.write('ee", "t": 1.0}\n')
        recs, nxt2 = collect.fetch_runstream(url, nxt)
        assert [r["name"] for r in recs] == ["three"] and nxt2 == os.path.getsize(path)
        assert collect.fetch_runstream(url, nxt2) == ([], nxt2)
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=30)
        conn.request("GET", "/runstream?since=bogus")
        r = conn.getresponse()
        assert r.status == 200 and r.getheader("X-Runstream-Next") == str(nxt2)
        conn.close()
    finally:
        tlogging.install_timeline(prev)
        logger.finish()
        server.shutdown()
        server.server_close()
        thread.join(30)
    # without a metrics stream: an empty payload
    from factorvae_tpu_torch.obs import live

    assert live.tail_bytes(str(tmp_path / "missing.jsonl"), 0)[0] == b""


def test_collect_fleet_merges_a_cpu_router_and_two_workers(tmp_path):
    """A router over two CPU worker processes, each with its own metrics
    stream: `collect_fleet` pulls the three streams over /runstream, aligns
    the workers by the router's clock probes and merges them, equal to the
    JAX collector's merge of the same records."""
    from factorvae_tpu.obs import collect as jcollect

    from factorvae_tpu_torch.obs import collect
    from factorvae_tpu_torch.serve import router
    from factorvae_tpu_torch.serve.pool import WorkerPool, http_json

    rpath = tmp_path / "router.jsonl"
    logger = tlogging.MetricsLogger(jsonl_path=str(rpath), echo=False)
    prev = tlogging.install_timeline(tlogging.Timeline(logger))
    pool = WorkerPool([], ["--synthetic", "8,8"], 2, str(tmp_path / "store"),
                      work_dir=str(tmp_path / "work"), device="cpu",
                      metrics_base=str(tmp_path / "worker.jsonl"), health_interval_s=0.2)
    r = router.Router(pool, hedge=False)
    try:
        pool.start()
        r.start()
        url = f"http://127.0.0.1:{r.port}"
        for i in range(4):
            http_json(f"{url}/score", {"id": i, "cmd": "stats"}, timeout=120.0)
        __import__("time").sleep(0.6)                 # a few more clock probes
        merged, since = collect.collect_fleet(url)
        procs = {m["proc"] for m in merged}
        assert procs == {"router", "w0", "w1"} and set(since) == procs
        assert all(m.get("aligned", True) for m in merged)
        offsets = collect.estimate_offsets([m for m in merged if m["proc"] == "router"])
        assert set(offsets) == {"w0", "w1"} and all(o["probes"] >= 1 for o in offsets.values())
        again, since2 = collect.collect_fleet(url, since)
        assert all(since2[p] >= since[p] for p in since)
        router_recs = [json.loads(x) for x in open(rpath) if x.strip()]
        workers = {w: collect.parse_lines(open(f"{tmp_path}/worker_{w}.jsonl").read())
                   for w in ("w0", "w1")}
        assert collect.merge_records(router_recs, workers) == jcollect.merge_records(
            router_recs, workers)
    finally:
        r.stop()
        tlogging.install_timeline(prev)
        logger.finish()
