"""Prometheus text exposition of the scoring daemon (`factorvae_tpu/obs/metrics.py`).

`daemon_metrics(daemon)` renders the daemon's state as exposition format
0.0.4 (`GET /metrics`): the request-latency histogram, per-model request
and warm gauges, the registry's hits, misses, evictions and cold starts,
breaker state, the sliding health window, the kernel libraries' build
taxonomy and the served-score drift monitors, under the JAX package's
family names. It reads counters only and scores nothing.

`compile_total{kind=...}` counts the kernel libraries of this process:
`compile` the ones `_build.build` compiled with nvcc, `compile_cached` the
ones `_build.load` found already built in the build directory (the port's
cache: a restarted daemon on a built tree scrapes compile 0).

`merge_expositions` is the router's fleet scrape: every worker's
exposition relabeled with its `worker_id` and merged under one HELP/TYPE
per family; `autoscale_families` renders the signals the autoscaler
decides from. `TextfileExporter` is the trainers' Prometheus textfile
(`--prom_textfile`): `export_epoch_metrics(rec)` rewrites it atomically
after each epoch when one is installed, byte for byte the JAX exporter's
text for the same record.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

#: the exposition-format content type /metrics answers with
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

PREFIX = "factorvae"


def _fmt(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(v) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def metric_line(name: str, value, labels: Optional[dict] = None) -> str:
    lab = ""
    if labels:
        inner = ",".join(f'{k}="{_escape(v)}"'
                         for k, v in labels.items() if v is not None)
        if inner:
            lab = "{" + inner + "}"
    return f"{name}{lab} {_fmt(value)}"


class LatencyHistogram:
    """Fixed-bucket latency histogram (seconds). Thread-safe: observe
    comes from the serving loop, render from the HTTP handler.

    Trace exemplars: `observe(dt, trace_id=...)` remembers the last trace
    that landed in each bucket, and `render` emits one `# exemplar`
    comment line per annotated bucket right after the bucket's sample
    (every exposition parser skips `#` lines)."""

    DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                       0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # + the +Inf slot
        self._exemplars: List[Optional[Tuple[str, float]]] = \
            [None] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, seconds: float,
                trace_id: Optional[str] = None) -> None:
        s = float(seconds)
        with self._lock:
            i = len(self.buckets)
            for j, b in enumerate(self.buckets):
                if s <= b:
                    i = j
                    break
            self._counts[i] += 1
            if trace_id is not None:
                self._exemplars[i] = (str(trace_id), s)
            self._sum += s
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def render(self, name: str, labels: Optional[dict] = None
               ) -> List[str]:
        with self._lock:
            counts = list(self._counts)
            exemplars = list(self._exemplars)
            total, n = self._sum, self._n
        lines = []
        cum = 0
        for b, c, ex in zip(self.buckets, counts, exemplars):
            cum += c
            lab = dict(labels or {})
            lab["le"] = _fmt(b)
            lines.append(metric_line(f"{name}_bucket", cum, lab))
            if ex is not None:
                tid, s = ex
                lines.append(f'# exemplar {name}_bucket '
                             f'le="{_fmt(b)}" trace_id="{_escape(tid)}" '
                             f'value={_fmt(round(s, 6))}')
        lab = dict(labels or {})
        lab["le"] = "+Inf"
        lines.append(metric_line(f"{name}_bucket", n, lab))
        if exemplars[-1] is not None:
            tid, s = exemplars[-1]
            lines.append(f'# exemplar {name}_bucket le="+Inf" '
                         f'trace_id="{_escape(tid)}" '
                         f'value={_fmt(round(s, 6))}')
        lines.append(metric_line(f"{name}_sum", total, labels))
        lines.append(metric_line(f"{name}_count", n, labels))
        return lines


def render_families(
        families: Sequence[Tuple[str, str, str, List[str]]]) -> str:
    """[(name, type, help, sample_lines)] -> exposition text (families
    with no samples are dropped — an absent metric beats a lying 0)."""
    out: List[str] = []
    for name, typ, help_, lines in families:
        if not lines:
            continue
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {typ}")
        out.extend(lines)
    return "\n".join(out) + "\n"


def inject_labels(sample: str, labels: dict) -> str:
    """One exposition sample line with extra labels spliced in —
    `name{a="b"} 1` or `name 1` gains every (k, v) of `labels` (a
    fleet scrape relabels each worker's families with its `worker_id`)."""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items()
                     if v is not None)
    if not inner:
        return sample
    brace = sample.find("{")
    if brace != -1 and brace < sample.rfind("}"):
        close = sample.rfind("}")
        existing = sample[brace + 1:close].strip()
        sep = "," if existing else ""
        return (sample[:brace + 1] + inner + sep
                + sample[brace + 1:])
    name, _, rest = sample.partition(" ")
    return f"{name}{{{inner}}} {rest}"


def merge_expositions(
        parts: Sequence[Tuple[dict, str]],
        extra_families: Sequence[Tuple[str, str, str, List[str]]] = (),
) -> str:
    """One valid exposition from several: `parts` is [(labels, text), ...];
    every sample line of `text` gains `labels` (the fleet scrape's
    `worker_id`), and a family that appears in several payloads keeps one
    `# HELP` / `# TYPE` header. `extra_families` (the router's own) render
    first. Samples within a family follow `parts` order, so one worker's
    histogram buckets stay together."""
    from collections import OrderedDict

    merged: "OrderedDict[str, List]" = OrderedDict()
    for name, typ, help_, lines in extra_families:
        merged[name] = [typ, help_, list(lines)]
    for labels, text in parts:
        family = None
        for line in (text or "").splitlines():
            if line.startswith("# HELP "):
                name, _, help_ = line[len("# HELP "):].partition(" ")
                family = name
                merged.setdefault(name, ["untyped", help_, []])
                merged[name][1] = merged[name][1] or help_
            elif line.startswith("# TYPE "):
                name, _, typ = line[len("# TYPE "):].partition(" ")
                family = name
                merged.setdefault(name, [typ or "untyped", "", []])
                if typ:
                    merged[name][0] = typ
            elif line.startswith("#") or not line.strip():
                continue
            else:
                sample = inject_labels(line, labels)
                name = line.split("{", 1)[0].split(" ", 1)[0]
                if family is None or not (name == family
                                          or name.startswith(family + "_")):
                    family = name
                    merged.setdefault(name, ["untyped", "", []])
                merged[family][2].append(sample)
    return render_families([(n, t, h, ls) for n, (t, h, ls) in merged.items()])


def autoscale_families(signals: Dict) -> List[Tuple[str, str, str, List[str]]]:
    """The router's autoscaler signals as exposition families: queue depth,
    observed p50/p99 against the declared SLO, worker counts, and in-flight
    forwards per `worker_id`. An absent signal renders no sample."""
    p = f"{PREFIX}_router"
    fam: List[Tuple[str, str, str, List[str]]] = []
    for key, name, help_ in (
            ("queue_depth", f"{p}_queue_depth",
             "client requests queued/in flight at the router (the "
             "autoscaler's load signal)"),
            ("p50_ms", f"{p}_observed_p50_ms",
             "median client-request latency over the router's sliding "
             "window"),
            ("p99_ms", f"{p}_observed_p99_ms",
             "p99 client-request latency over the router's sliding "
             "window (compared against the declared SLO)"),
            ("slo_ms", f"{p}_slo_ms",
             "declared latency SLO the autoscaler defends (0 = none "
             "declared)"),
            ("workers_healthy", f"{p}_autoscale_workers_healthy",
             "healthy workers the autoscaler can spread load over"),
            ("workers_total", f"{p}_autoscale_workers_total",
             "pool worker slots, healthy or not")):
        v = signals.get(key)
        fam.append((name, "gauge", help_, [] if v is None else [metric_line(name, v)]))
    inflight = signals.get("worker_inflight") or {}
    fam.append((f"{p}_worker_inflight", "gauge",
                "forwards currently in flight per worker",
                [metric_line(f"{p}_worker_inflight", v, {"worker_id": wid})
                 for wid, v in sorted(inflight.items())]))
    return fam


# ---------------------------------------------------------------------------
# serving-side exposition
# ---------------------------------------------------------------------------

_HEALTH_CODE = {"ok": 0, "degraded": 1, "failing": 2, "draining": 3}


def daemon_metrics(daemon) -> str:
    """The scoring daemon's full /metrics payload (see module
    docstring). Reads counters only: one scrape does no scoring work.
    Holds the daemon's tick lock for the whole render, so every counter
    comes from the same instant, never half-way through a tick. Lock
    order inside matches the tick path's: daemon -> registry/drift ->
    logger."""
    from factorvae_tpu_torch._build import compile_event_counts

    with daemon._lock:
        return _render_daemon_metrics(daemon, compile_event_counts)


def _render_daemon_metrics(daemon, compile_event_counts) -> str:
    p = PREFIX
    reg = daemon.registry.stats()
    health = daemon.health()
    fam: List[Tuple[str, str, str, List[str]]] = []

    fam.append((f"{p}_serve_requests_total", "counter",
                "scoring requests answered ok",
                [metric_line(f"{p}_serve_requests_total",
                             daemon.requests_served)]))
    fam.append((f"{p}_serve_ticks_total", "counter",
                "dispatch ticks handled",
                [metric_line(f"{p}_serve_ticks_total", daemon.ticks)]))
    fam.append((f"{p}_serve_dispatches_total", "counter",
                "scoring program dispatches (fused groups count once)",
                [metric_line(f"{p}_serve_dispatches_total",
                             daemon.dispatches)]))
    fam.append((f"{p}_serve_fused_requests_total", "counter",
                "requests answered through a fused multi-model dispatch",
                [metric_line(f"{p}_serve_fused_requests_total",
                             daemon.fused_requests)]))
    fam.append((f"{p}_serve_deadline_misses_total", "counter",
                "requests whose scores landed past their deadline",
                [metric_line(f"{p}_serve_deadline_misses_total",
                             daemon.deadline_misses)]))
    fam.append((f"{p}_serve_breaker_fast_fails_total", "counter",
                "requests fast-failed by an open circuit breaker",
                [metric_line(f"{p}_serve_breaker_fast_fails_total",
                             daemon.breaker_fast_fails)]))
    fam.append((f"{p}_serve_request_latency_seconds", "histogram",
                "tick arrival to scores landing, per scoring request",
                daemon.latency.render(
                    f"{p}_serve_request_latency_seconds")))

    # health window: status code, error rate, window fill
    fam.append((f"{p}_serve_health_status", "gauge",
                "0=ok 1=degraded 2=failing 3=draining",
                [metric_line(f"{p}_serve_health_status",
                             _HEALTH_CODE.get(health["status"], 2))]))
    fam.append((f"{p}_serve_health_error_rate", "gauge",
                "error rate over the sliding outcome window",
                [metric_line(f"{p}_serve_health_error_rate",
                             health["error_rate"])]))
    fam.append((f"{p}_serve_health_window", "gauge",
                "scoring outcomes currently in the health window",
                [metric_line(f"{p}_serve_health_window",
                             health["window"])]))

    # registry totals (cold_starts == tombstone recoveries)
    fam.append((f"{p}_registry_models", "gauge",
                "models currently resident",
                [metric_line(f"{p}_registry_models", reg["models"])]))
    fam.append((f"{p}_registry_bytes", "gauge",
                "resident parameter bytes",
                [metric_line(f"{p}_registry_bytes", reg["bytes"])]))
    for key, help_ in (("hits", "registry lookup hits"),
                       ("misses", "registry lookup misses"),
                       ("evictions", "LRU evictions"),
                       ("cold_starts",
                        "tombstone recoveries (evicted models reloaded "
                        "from their source)")):
        fam.append((f"{p}_registry_{key}_total", "counter", help_,
                    [metric_line(f"{p}_registry_{key}_total",
                                 reg[key])]))

    # per-model gauges
    req_lines, warm_lines, breaker_lines, fails_lines = [], [], [], []
    for e in reg["entries"]:
        lab = {"model": e["key"], "alias": e["alias"],
               "precision": e["precision"]}
        req_lines.append(metric_line(
            f"{p}_model_requests_total", e["requests"], lab))
        warm_lines.append(metric_line(
            f"{p}_model_compiled", int(bool(e["compiled"])), lab))
    for key, b in sorted(daemon.breaker_states().items()):
        lab = {"model": key}
        breaker_lines.append(metric_line(
            f"{p}_breaker_open", int(b["open"]), lab))
        fails_lines.append(metric_line(
            f"{p}_breaker_consecutive_fails", b["fails"], lab))
    fam.append((f"{p}_model_requests_total", "counter",
                "requests served per resident model", req_lines))
    fam.append((f"{p}_model_compiled", "gauge",
                "1 when the model's serial scoring program is warm",
                warm_lines))
    fam.append((f"{p}_breaker_open", "gauge",
                "1 while the model's circuit breaker is open",
                breaker_lines))
    fam.append((f"{p}_breaker_consecutive_fails", "gauge",
                "consecutive failures feeding the breaker",
                fails_lines))

    # kernel-library taxonomy: a restarted daemon on a built tree
    # scrapes compile == 0, compile_cached > 0
    cc = compile_event_counts()
    fam.append((f"{p}_compile_total", "counter",
                "kernel libraries by taxonomy (compile=built with nvcc here, "
                "compile_cached=found already built in the build directory)",
                [metric_line(f"{p}_compile_total", cc["compile"],
                             {"kind": "compile"}),
                 metric_line(f"{p}_compile_total", cc["compile_cached"],
                             {"kind": "compile_cached"})]))

    # served-score drift (+ per-model thresholds and drift state)
    corr_lines, drift_lines, day_lines = [], [], []
    thr_lines, drifting_lines = [], []
    for model, st in daemon.drift.stats().items():
        lab = {"model": model}
        if st["last_rank_corr"] is not None:
            corr_lines.append(metric_line(
                f"{p}_score_rank_corr_prev_day", st["last_rank_corr"],
                lab))
        drift_lines.append(metric_line(
            f"{p}_score_drift_total", st["drift_events"], lab))
        day_lines.append(metric_line(
            f"{p}_score_days_digested", st["days_digested"], lab))
        thr_lines.append(metric_line(
            f"{p}_score_drift_threshold", st["threshold"], lab))
        drifting_lines.append(metric_line(
            f"{p}_score_drifting", int(bool(st["drifting"])), lab))
    fam.append((f"{p}_score_rank_corr_prev_day", "gauge",
                "rank correlation of the served cross-section vs the "
                "model's previously served day", corr_lines))
    fam.append((f"{p}_score_drift_total", "counter",
                "day-over-day rank-correlation collapses below the "
                "drift threshold", drift_lines))
    fam.append((f"{p}_score_days_digested", "gauge",
                "distinct days with a served-score digest", day_lines))
    fam.append((f"{p}_score_drift_threshold", "gauge",
                "ACTIVE drift threshold per model (per-model override "
                "or the daemon-wide default)", thr_lines))
    fam.append((f"{p}_score_drifting", "gauge",
                "1 while the model's latest day-over-day rank "
                "correlation sits below its active threshold",
                drifting_lines))
    return render_families(fam)


# ---------------------------------------------------------------------------
# trainer-side textfile exporter
# ---------------------------------------------------------------------------

#: epoch-record keys exported as gauges when present (probe keys ride
#: along automatically — anything numeric and not in the skip set goes)
_EPOCH_SKIP = {"epoch", "step"}


class TextfileExporter:
    """Write one epoch's metrics as a Prometheus textfile (the
    node-exporter textfile-collector convention). The write is atomic
    (tmp + rename) so a scraper never reads a torn exposition."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.epochs = 0

    @staticmethod
    def _lanes(v) -> List[Tuple[Optional[int], float]]:
        """Numeric lanes of an epoch-record value: scalars are one
        unlabeled lane; fleet per-seed lists get a seed_lane label."""
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return [(None, float(v))]
        if isinstance(v, list):
            return [(i, float(x)) for i, x in enumerate(v)
                    if isinstance(x, (int, float))
                    and not isinstance(x, bool)]
        return []

    def export_epoch(self, rec: Dict) -> None:
        self.epochs += 1
        p = PREFIX
        fam: List[Tuple[str, str, str, List[str]]] = [
            (f"{p}_train_epochs_total", "counter",
             "epochs exported this run",
             [metric_line(f"{p}_train_epochs_total", self.epochs)]),
        ]
        if isinstance(rec.get("epoch"), (int, float)):
            fam.append((f"{p}_train_epoch", "gauge",
                        "most recent epoch number",
                        [metric_line(f"{p}_train_epoch",
                                     rec["epoch"])]))
        if isinstance(rec.get("step"), (int, float)):
            fam.append((f"{p}_train_step", "gauge",
                        "optimizer step after the epoch",
                        [metric_line(f"{p}_train_step", rec["step"])]))
        # Fleet lane-config labels: hyper lanes race
        # DIFFERENT configs, so every per-lane gauge carries the config
        # that produced it (lr/kl_weight/config hash) next to its
        # seed_lane index — the scrape-side twin of the obs.report flag
        # labels. Absent on serial runs.
        lane_names = rec.get("lane_labels")
        if not (isinstance(lane_names, list)
                and all(isinstance(x, str) for x in lane_names)):
            lane_names = None

        def _labels(lane):
            if lane is None:
                return None
            lab = {"seed_lane": str(lane)}
            if lane_names and lane < len(lane_names):
                lab["lane_config"] = lane_names[lane]
            return lab

        for key in sorted(rec):
            if key in _EPOCH_SKIP or key.startswith("_"):
                continue
            lanes = self._lanes(rec[key])
            if not lanes:
                continue
            name = f"{p}_train_{key}"
            lines = [metric_line(name, v, _labels(lane))
                     for lane, v in lanes]
            fam.append((name, "gauge",
                        f"epoch-record metric '{key}'", lines))
        text = render_families(fam)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, self.path)


# Module-level registry, mirroring utils.logging.install_timeline: the
# epoch loops call `export_epoch_metrics(rec)` unconditionally; without
# an installed exporter that is one `is None` check.
_EXPORTER: Optional[TextfileExporter] = None


def install_exporter(exp: Optional[TextfileExporter]
                     ) -> Optional[TextfileExporter]:
    """Install the process-wide textfile exporter; returns the previous
    one so callers (tests, the CLI's finally block) can restore it."""
    global _EXPORTER
    prev = _EXPORTER
    _EXPORTER = exp
    return prev


def current_exporter() -> Optional[TextfileExporter]:
    return _EXPORTER


def export_epoch_metrics(rec: Dict) -> None:
    exp = _EXPORTER
    if exp is not None:
        exp.export_epoch(rec)
