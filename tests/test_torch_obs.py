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
