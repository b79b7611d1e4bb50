"""Scoring daemon: the request path over the model registry
(`factorvae_tpu/serve/daemon.py`, the single-process half).

`ScoringDaemon.handle_batch` answers one tick of JSON requests, in order:

  {"id", "model", "day" | "days" | "start"/"end", "top"?, "deadline_ms"?, "trace"?}
  {"cmd": "ping" | "stats" | "models" | "shutdown" | "admit"}

A scoring response carries `results` (one entry per day: `day`,
`instruments`, `scores`, best first when `top` is given), `n`, `model`,
`alias`, `precision`, `batched_with` and `latency_ms` (tick arrival to this
request's scores). A bad request answers `{"ok": false, "error"}` and never
stops the daemon.

**Fused multi-model dispatch.** The requests of a tick that share (scoring
architecture with its compute dtype, int8, the days) form a bucket. A
bucket of two or more distinct models stacks their weights once into the
(S, ...) tree of `predict_panel_fleet` (an LRU of `_STACK_CACHE_GROUPS`
stacks, cleared when `registry.version` moves), so K1 and K4 launch once
per 32-day chunk for the whole bucket, the S models on the kernels' lane
axis. Duplicates of one model share one serial dispatch; a lone model takes
the serial path (`registry.score`, bitwise `predict_panel`), and so does an
AOT artifact entry, whose program is fixed at export. A fused group
that fails marks `fused_fallback` and serves each member serially, on the
same kernels.

**Resilience.** `deadline_ms` bounds each scoring request (a request's own
`deadline_ms` overrides; 0: none): scores that land late answer `ok: false`
with the measured latency. A per-model circuit breaker opens after
`breaker_k` consecutive failures (errors or misses against the server's
deadline), fast-fails with `retry_after_s` for `breaker_cooldown_s`, then
lets one probe through (half-open): success closes it, failure re-opens
it. `health()` reads a sliding window of scoring outcomes: ok, degraded
past `degraded_at` or with an open breaker, failing past `failing_at`, and
draining after `request_drain`. Client garbage and fast-fails never enter
the window.

**Admission.** `admit` registers a candidate weights directory, scores it
and the incumbent behind an alias on holdout days outside the tick lock,
compares their Rank-IC (`ops.stats.masked_spearman`), and on a win flips
the alias and retires the incumbent under the tick lock: a request in
flight finishes on the model that was serving when it arrived.

**Front ends.** `serve_stdin` (JSONL; an array line is one tick, and lines
within `tick_s` of each other join one tick), `serve_batch_file` and
`serve_http` (POST /score /admit, GET /stats /models /healthz /metrics) all
funnel into `handle_batch`. With a `TickScheduler` the HTTP front is
threaded: concurrent clients' requests queue for one scheduler thread,
the only caller of `handle_batch`, and admissions for the scheduler's
admission thread, so no handler thread touches the card's tensors.

**Observability.** With a timeline installed, every tick is a `serve_tick`
span, every dispatch a `serve_dispatch` span and every response a
`serve_request` span, with trace fields (`obs/trace.py`); `/metrics` is
`obs.metrics.daemon_metrics`; served scores feed `obs.drift`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

import numpy as np

from factorvae_tpu_torch.data.panel import to_day
from factorvae_tpu_torch.obs.drift import ScoreDriftMonitor
from factorvae_tpu_torch.obs.metrics import LatencyHistogram
from factorvae_tpu_torch.obs.trace import TRACE_HEADER, parse_header, wire_ctx
from factorvae_tpu_torch.serve.registry import Entry, ModelRegistry, RegistryError
from factorvae_tpu_torch.utils.logging import (
    run_meta,
    timeline_event,
    timeline_now,
    timeline_span,
    timeline_span_begin,
    timeline_span_end,
)

_CMDS = ("ping", "stats", "models", "shutdown", "admit")
#: the answer to a request that a draining scheduler never scored (a router
#: forwards such a request to another worker)
SHUTTING_DOWN = "daemon is shutting down"


@dataclasses.dataclass
class _Resolved:
    """One parsed request, ready to dispatch."""

    request: dict
    entry: Optional[Entry] = None
    days: Optional[np.ndarray] = None
    error: Optional[str] = None
    cmd: Optional[str] = None
    scores: Optional[np.ndarray] = None   # filled by dispatch
    batched_with: int = 1
    done_t: Optional[float] = None        # when this request's scores landed
    deadline_ms: float = 0.0              # 0: none
    deadline_from_request: bool = False   # the client's, not the server's
    paid_compile: bool = False            # the entry's first scoring call
    retry_after_s: Optional[float] = None  # breaker fast-fail
    fast_failed: bool = False             # never dispatched (breaker open)
    server_fault: bool = False            # resolve failed on the daemon's side
    shared_outcome: bool = False          # a copy of another request's dispatch
    trace: Optional[dict] = None          # {"trace_id", "base", "n"}
    dispatch_span: Optional[str] = None


class ScoringDaemon:
    """Request handler over (registry, dataset). `stochastic=False` serves
    deterministic scores; True/None sample as `predict_panel` does, from a
    generator seeded with `seed`. The resilience knobs are described in the
    module docstring; `trace=False` drops every trace field."""

    _STACK_CACHE_GROUPS = 8

    def __init__(self, registry: ModelRegistry, dataset,
                 stochastic: Optional[bool] = False, seed: int = 0,
                 deadline_ms: float = 0.0, breaker_k: int = 3,
                 breaker_cooldown_s: float = 5.0, health_window: int = 64,
                 degraded_at: float = 0.1, failing_at: float = 0.5,
                 drift_threshold: float = 0.5, drift_min_overlap: int = 8,
                 trace: bool = True):
        self.registry = registry
        self.dataset = dataset
        self.stochastic = stochastic
        self.seed = seed
        self.deadline_ms = float(deadline_ms)
        self.breaker_k = max(1, int(breaker_k))
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.degraded_at = float(degraded_at)
        self.failing_at = float(failing_at)
        self.requests_served = 0
        self.dispatches = 0
        self.fused_requests = 0
        self.deadline_misses = 0
        self.breaker_fast_fails = 0
        self.ticks = 0
        self.admits = 0
        self.promotions = 0
        self.trace_enabled = bool(trace)
        self._trace_seq = 0
        self._tick_span: Optional[str] = None
        self.latency = LatencyHistogram()
        self.drift = ScoreDriftMonitor(threshold=drift_threshold,
                                       min_overlap=drift_min_overlap)
        self.run_meta = run_meta(run_name="serve")
        # the tick lock: held for a whole tick, by extend_dataset and by the
        # health/stats/metrics readers
        self._lock = threading.RLock()
        self._closing = False
        self._draining = False
        self._breakers: dict = {}     # key -> {"fails", "open_until", "half_open"}
        self._outcomes: deque = deque(maxlen=max(1, int(health_window)))
        self._stack_cache: "OrderedDict" = OrderedDict()
        self._stack_version: Optional[int] = None

    # ---- request parsing -------------------------------------------------

    def _resolve_days(self, req: dict) -> np.ndarray:
        ds = self.dataset
        if "day" in req:
            sel = [req["day"]]
        elif "days" in req:
            sel = list(req["days"])
        elif "start" in req or "end" in req:
            return ds.split_days(req.get("start"), req.get("end")).astype(np.int64)
        else:
            raise ValueError("request needs 'day', 'days' or 'start'/'end'")
        dates = ds.dates
        out = []
        for d in sel:
            if isinstance(d, (int, np.integer)) and not isinstance(d, bool):
                i = int(d)
                if not 0 <= i < len(dates):
                    raise ValueError(f"day index {i} out of range [0, {len(dates)})")
            else:
                day = to_day(d)
                i = int(np.searchsorted(dates, day))
                if i >= len(dates) or dates[i] != day:
                    raise ValueError(f"day {d!r} not in the serving panel "
                                     f"[{dates[0]}, {dates[-1]}]")
            out.append(i)
        return np.asarray(out, np.int64)

    def _resolve(self, req) -> _Resolved:
        if not isinstance(req, dict):
            return _Resolved(request={}, error="request must be a JSON object")
        cmd = req.get("cmd")
        if cmd is not None:
            if cmd not in _CMDS:
                return _Resolved(request=req, error=f"unknown cmd {cmd!r} "
                                 f"(known: {', '.join(_CMDS)})")
            return _Resolved(request=req, cmd=cmd)
        model = req.get("model")
        if not model:
            return _Resolved(request=req, error="request needs a 'model' (key or "
                             "alias; see {\"cmd\": \"models\"})")
        from_req = "deadline_ms" in req
        try:
            deadline = float(req.get("deadline_ms", self.deadline_ms) or 0)
            days = self._resolve_days(req)
        except Exception as e:     # noqa: BLE001 - client input answers, never kills
            return _Resolved(request=req, error=str(e))
        try:
            entry = self.registry.get(str(model))
        except Exception as e:     # noqa: BLE001 - a failed cold start answers
            # a name the registry knows that fails to load is the daemon's
            # fault and feeds health; an unknown name is client input
            try:
                self.registry.resolve_key(str(model))
                known = True
            except RegistryError:
                known = False
            return _Resolved(request=req, error=str(e), server_fault=known)
        return _Resolved(request=req, entry=entry, days=days, deadline_ms=deadline,
                         deadline_from_request=from_req, paid_compile=not entry.compiled)

    def _ingress_ctx(self, req) -> Optional[dict]:
        """The trace context a raw request enters the tick under: its own
        `"trace"` field, else a daemon-local root for scoring requests.
        Called under the tick lock."""
        if not self.trace_enabled or not isinstance(req, dict) \
                or req.get("cmd") is not None:
            return None
        ctx = wire_ctx(req)
        if ctx is None and "model" in req:
            self._trace_seq += 1
            ctx = {"trace_id": f"d-{self._trace_seq:06d}", "span_id": "in"}
        return ctx

    # ---- circuit breaker -------------------------------------------------

    def _breaker_gate(self, r: _Resolved) -> bool:
        """True when the request may dispatch: a closed breaker, or an open
        one past its cooldown (half-open: this request is the probe, and the
        window re-arms so a burst does not follow it)."""
        b = self._breakers.get(r.entry.key)
        if b is None or b.get("open_until") is None:
            return True
        remaining = b["open_until"] - time.perf_counter()
        if remaining <= 0:
            b["open_until"] = time.perf_counter() + self.breaker_cooldown_s
            b["half_open"] = True
            return True
        r.error = (f"circuit open for model {r.entry.alias or r.entry.key} after "
                   f"{b['fails']} consecutive failures; retry in {remaining:.2f}s")
        r.retry_after_s = round(remaining, 3)
        r.fast_failed = True
        self.breaker_fast_fails += 1
        return False

    def _breaker_record(self, entry: Entry, ok: bool) -> None:
        """One dispatch outcome into the entry's breaker: open after
        `breaker_k` consecutive failures (or a failed probe), close on a
        success."""
        b = self._breakers.setdefault(entry.key, {"fails": 0, "open_until": None,
                                                  "half_open": False})
        if ok:
            if b["open_until"] is not None:   # only an open breaker closes
                timeline_event("circuit_close", cat="recovery", resource="serve",
                               model=entry.key)
            b.update(fails=0, open_until=None, half_open=False)
            return
        b["fails"] += 1
        if b["fails"] >= self.breaker_k or b["half_open"]:
            b["open_until"] = time.perf_counter() + self.breaker_cooldown_s
            b["half_open"] = False
            timeline_event("circuit_open", cat="recovery", resource="serve",
                           model=entry.key, fails=b["fails"],
                           retry_after_s=self.breaker_cooldown_s)

    def open_breakers(self) -> list:
        now = time.perf_counter()
        return sorted(k for k, b in self._breakers.items()
                      if b.get("open_until") is not None and b["open_until"] > now)

    # ---- dispatch --------------------------------------------------------

    def _bucket_key(self, r: _Resolved):
        """Requests fuse when one lane-batched call serves them all: the same
        scoring architecture and compute dtype, int8 flag and days. An
        artifact entry's program is fixed at export, so its requests form a
        bucket of their own and take the serial path."""
        days = tuple(int(d) for d in r.days)
        if r.entry.artifact is not None:
            return ("artifact", r.entry.key, days)
        return (r.entry.score_config.model, r.entry.int8, days)

    def _stacked(self, entries: list) -> dict:
        from factorvae_tpu_torch.eval.predict import stack_params

        if self._stack_version != self.registry.version:
            self._stack_cache.clear()
            self._stack_version = self.registry.version
        cache_key = tuple(e.key for e in entries)
        stacked = self._stack_cache.get(cache_key)
        if stacked is None:
            stacked = stack_params([e.params for e in entries])
            self._stack_cache[cache_key] = stacked
            while len(self._stack_cache) > self._STACK_CACHE_GROUPS:
                self._stack_cache.popitem(last=False)
        else:
            self._stack_cache.move_to_end(cache_key)
        return stacked

    def _dispatch(self, resolved: list) -> None:
        """Fill `scores` on every resolvable request, fusing each bucket of
        distinct models into one `predict_panel_fleet` call."""
        from factorvae_tpu_torch.eval.predict import predict_panel_fleet

        buckets: dict = {}
        for r in resolved:
            if r.error or r.cmd:
                continue
            if not self._breaker_gate(r):
                continue
            buckets.setdefault(self._bucket_key(r), []).append(r)
        for bi, group in enumerate(buckets.values()):
            distinct: dict = {}
            for r in group:
                distinct.setdefault(r.entry.key, r.entry)
            if len(distinct) == 1:
                # one model, maybe asked twice: one serial dispatch whose
                # outcome is one piece of breaker and health evidence
                first = None
                for r in group:
                    if first is None:
                        self._dispatch_serial(r)
                        first = r
                    else:
                        r.scores, r.done_t, r.error = first.scores, first.done_t, first.error
                        r.shared_outcome = True
                        if r.trace is not None:
                            r.dispatch_span = first.dispatch_span
                continue
            entries = list(distinct.values())
            days = group[0].days
            cache_key = tuple(e.key for e in entries)
            try:
                stacked = self._stacked(entries)
                d_members = [r for r in group if r.trace is not None]
                dfields: dict = {}
                dspan = None
                if d_members and self._tick_span:
                    dspan = f"{self._tick_span}.d{bi}"
                    dfields = dict(span=dspan, parent=self._tick_span,
                                   traces=sorted({r.trace["trace_id"]
                                                  for r in d_members})[:16])
                t_call = time.perf_counter()
                with timeline_span("serve_dispatch", cat="serve", resource="device",
                                   models=len(entries), n_days=int(len(days)), **dfields):
                    fleet = predict_panel_fleet(stacked, entries[0].score_config,
                                                self.dataset, days,
                                                stochastic=self.stochastic, seed=self.seed,
                                                int8=entries[0].int8)
            except Exception as e:     # noqa: BLE001 - the members go serial
                timeline_event("fused_fallback", cat="serve", resource="serve",
                               models=len(entries), error=str(e))
                self._stack_cache.pop(cache_key, None)
                for r in group:
                    self._dispatch_serial(r)
                continue
            t1 = time.perf_counter()
            self.dispatches += 1
            for e in entries:
                if not e.compiled:    # its first scoring call was this fused one
                    e.compiled, e.compile_s = True, round(t1 - t_call, 6)
            by_key = {e.key: fleet[i] for i, e in enumerate(entries)}
            seen_keys: set = set()
            for r in group:
                r.scores = by_key[r.entry.key]
                r.batched_with = len(entries)
                r.done_t = t1
                if r.trace is not None:
                    r.dispatch_span = dspan
                r.shared_outcome = r.entry.key in seen_keys
                seen_keys.add(r.entry.key)
                r.entry.requests += 1
                self.fused_requests += 1

    def _dispatch_serial(self, r: _Resolved) -> None:
        dfields: dict = {}
        if r.trace is not None:
            r.dispatch_span = f"{r.trace['base']}.d{r.trace['n']}"
            dfields = dict(trace=r.trace["trace_id"], span=r.dispatch_span,
                           parent=self._tick_span or r.trace["base"])
        cm = (timeline_span("serve_dispatch", cat="serve", resource="device", models=1,
                            **dfields)
              if r.trace is not None else contextlib.nullcontext())
        try:
            with cm:
                r.scores = self.registry.score(r.entry.key, self.dataset, r.days,
                                               stochastic=self.stochastic, seed=self.seed,
                                               entry=r.entry)
            r.done_t = time.perf_counter()
            self.dispatches += 1
        except Exception as e:     # noqa: BLE001 - answers this request, not the daemon
            # a CUDA error, or a model and a panel that do not fit
            r.error = str(e)

    # ---- responses -------------------------------------------------------

    def _respond(self, r: _Resolved, t0: float) -> dict:
        rid = (r.request or {}).get("id")
        if r.error is not None:
            if r.entry is not None and not r.fast_failed and not r.shared_outcome:
                self._breaker_record(r.entry, False)
            if (r.cmd is None and not r.fast_failed and not r.shared_outcome
                    and (r.entry is not None or r.server_fault)):
                # health samples are the daemon's own scoring outcomes
                self._outcomes.append(False)
            out = {"id": rid, "ok": False, "error": r.error}
            if r.retry_after_s is not None:
                out["retry_after_s"] = r.retry_after_s
            return out
        if r.cmd is not None:
            if r.cmd == "shutdown":
                self._closing = True
                return {"id": rid, "ok": True, "cmd": "shutdown"}
            if r.cmd == "ping":
                return {"id": rid, "ok": True, "cmd": "ping"}
            if r.cmd == "models":
                return {"id": rid, "ok": True, "cmd": "models", "run_meta": self.run_meta,
                        "models": self.registry.stats()["entries"]}
            return {"id": rid, "ok": True, "cmd": "stats", **self.stats()}
        # judged from tick arrival to this request's scores landing
        done_lat_ms = ((r.done_t or time.perf_counter()) - t0) * 1e3
        self.latency.observe(done_lat_ms / 1e3)
        # a miss of the server's own deadline is evidence whatever deadline
        # the response used
        server_miss = bool(self.deadline_ms) and done_lat_ms > self.deadline_ms
        if r.deadline_ms and done_lat_ms > r.deadline_ms:
            self.deadline_misses += 1
            if not r.shared_outcome:
                if r.paid_compile or (r.deadline_from_request and not server_miss):
                    # a client's own budget, or the one-time first call: not
                    # evidence that the model is sick
                    self._breaker_record(r.entry, True)
                    self._outcomes.append(True)
                else:
                    self._breaker_record(r.entry, False)
                    self._outcomes.append(False)
            return {"id": rid, "ok": False,
                    "error": (f"deadline exceeded: scores landed at {done_lat_ms:.1f}ms > "
                              f"deadline_ms={r.deadline_ms:g}"),
                    "model": r.entry.key, "alias": r.entry.alias,
                    "latency_ms": round(done_lat_ms, 3)}
        if not r.shared_outcome:
            ok_ev = r.paid_compile or not server_miss
            self._breaker_record(r.entry, ok_ev)
            self._outcomes.append(ok_ev)
        ds = self.dataset
        top = (r.request or {}).get("top")
        results, n_total = [], 0
        valid = ds.valid[r.days]
        inst = np.asarray(ds.instruments)
        for i, day in enumerate(r.days):
            idx = np.nonzero(valid[i])[0]
            idx = idx[idx < inst.size]
            names = inst[idx]
            vals = np.asarray(r.scores[i], np.float32)[idx]
            # the full served cross-section, before any top-k cut
            self.drift.observe(r.entry.key, int(day), names, vals, alias=r.entry.alias)
            if top:
                order = np.argsort(-vals)[: int(top)]
                names, vals = names[order], vals[order]
            n_total += int(vals.size)
            results.append({"day": str(ds.dates[int(day)]),
                            "instruments": [str(n) for n in names],
                            "scores": [float(v) for v in vals]})
        self.requests_served += 1
        return {"id": rid, "ok": True, "model": r.entry.key, "alias": r.entry.alias,
                "precision": r.entry.precision, "n": n_total,
                "batched_with": r.batched_with, "results": results,
                "latency_ms": round(done_lat_ms, 3)}

    # ---- the panel and admission -------------------------------------------

    def extend_dataset(self, piece) -> bool:
        """Append the trading days of the Panel `piece` to the serving panel
        (`PanelDataset.extend_days`) under the tick lock: a tick in flight
        finishes on the old day axis. True when days were added, False for
        the idempotent no-op."""
        with self._lock:
            added = bool(self.dataset.extend_days(piece))
        if added:
            timeline_event("serve_extend", cat="serve", resource="serve",
                           n_days=len(self.dataset.dates))
        return added

    def _holdout_days(self, holdout_days) -> np.ndarray:
        """The gate's days: the given ones, else the newest day with at
        least 3 finite labels (`eval.metrics.labeled_holdout_days`)."""
        if holdout_days:
            return self._resolve_days({"days": list(holdout_days)})
        from factorvae_tpu_torch.eval.metrics import labeled_holdout_days

        days = labeled_holdout_days(self.dataset, 1)
        if not days:
            raise ValueError("no holdout day with >=3 finite labels in the serving "
                             "panel; pass explicit holdout_days")
        return np.asarray(days, np.int64)

    def _gate_rank_ic(self, key: str, days: np.ndarray) -> float:
        """Mean holdout Rank-IC of one entry (`ops.stats.masked_spearman`)."""
        from factorvae_tpu_torch.eval.metrics import panel_rank_ic

        ds = self.dataset
        scores = self.registry.score(key, ds, days, stochastic=self.stochastic,
                                     seed=self.seed)
        return panel_rank_ic(scores, ds.day_labels(days), ds.valid[days])

    def admit(self, path: str, alias: str, holdout_days=None, min_margin: float = 0.0,
              drift_threshold: Optional[float] = None, precision: Optional[str] = None,
              trace: Optional[dict] = None) -> dict:
        """`_admit_impl` under a `serve_admit` span when `trace` is a wire
        context."""
        kw = dict(holdout_days=holdout_days, min_margin=min_margin,
                  drift_threshold=drift_threshold, precision=precision)
        ctx = wire_ctx({"trace": trace}) if trace is not None else None
        if ctx is None or not self.trace_enabled:
            return self._admit_impl(path, alias, **kw)
        with timeline_span("serve_admit", cat="serve", resource="serve", alias=str(alias),
                           trace=ctx["trace_id"], span=f"{ctx['span_id']}.a",
                           parent=ctx["span_id"]):
            return self._admit_impl(path, alias, **kw)

    def _admit_impl(self, path: str, alias: str, holdout_days=None,
                    min_margin: float = 0.0, drift_threshold: Optional[float] = None,
                    precision: Optional[str] = None) -> dict:
        """Admit the candidate weights directory `path`, gate it against the
        incumbent behind `alias` (candidate Rank-IC >= incumbent's - margin
        on the holdout days) and, on a win, flip the alias and retire the
        incumbent under the tick lock. A loser is retired; with no incumbent
        the candidate is promoted (bootstrap). The gate's scoring runs
        outside the tick lock. A re-run after a crash between the verdict and
        the flip re-admits the same bytes (a refresh) and completes the
        flip."""
        from factorvae_tpu_torch import chaos

        alias = str(alias)
        with self._lock:
            self.admits += 1
            admit_no = self.admits    # the chaos coordinate: the Nth admission
            try:
                inc_key = self.registry.resolve_key(alias)
            except RegistryError as e:
                inc_key = None
                timeline_event("admit_no_incumbent", cat="serve", resource="serve",
                               alias=alias, error=str(e))
        cand_key = self.registry.register_checkpoint(str(path), precision=precision,
                                                     n_stocks=self.dataset.n_max)
        out = {"ok": True, "alias": alias, "model": cand_key, "incumbent": inc_key}
        cand_ic = inc_ic = None
        reason = "no incumbent behind alias (bootstrap admission)"
        promote = True
        if inc_key is not None and inc_key != cand_key:
            try:
                days = self._holdout_days(holdout_days)
                cand_ic = self._gate_rank_ic(cand_key, days)
                inc_ic = self._gate_rank_ic(inc_key, days)
            except Exception:
                # a gate that cannot judge leaves no ungated candidate behind
                self.registry.retire(cand_key)
                raise
            out["holdout_days"] = [int(d) for d in days]
            if np.isnan(cand_ic):
                promote, reason = False, "candidate Rank-IC undefined"
            elif np.isnan(inc_ic):
                promote, reason = True, "incumbent Rank-IC undefined"
            else:
                promote = cand_ic >= inc_ic - float(min_margin)
                reason = (f"candidate {cand_ic:+.4f} vs incumbent {inc_ic:+.4f} "
                          f"(margin {min_margin:g})")
        elif inc_key is not None:
            reason = "same config hash as incumbent (in-place refresh)"
        if chaos.fault("fidelity_gate_reject", request=admit_no) is not None:
            promote, reason = False, "chaos: forced fidelity-gate reject"
        out.update(candidate_rank_ic=cand_ic, incumbent_rank_ic=inc_ic, reason=reason)
        if not promote:
            if inc_key is not None and inc_key != cand_key:
                self.registry.retire(cand_key)
            timeline_event("admit_rejected", cat="serve", resource="serve", model=cand_key,
                           alias=alias, reason=reason, candidate_rank_ic=cand_ic,
                           incumbent_rank_ic=inc_ic)
            out["promoted"] = False
            return out
        if chaos.fault("kill_between_admit_and_drain", request=admit_no) is not None:
            chaos.ops.kill_now()
        with self._lock:
            self.registry.set_alias(alias, cand_key)
            if inc_key is not None and inc_key != cand_key:
                self.registry.retire(inc_key)
                self.drift.set_threshold(inc_key, None)
            if drift_threshold is not None:
                self.drift.set_threshold(cand_key, float(drift_threshold))
            self.promotions += 1
        timeline_event("admit_promoted", cat="serve", resource="serve", model=cand_key,
                       alias=alias, incumbent=out["incumbent"], reason=reason,
                       candidate_rank_ic=cand_ic, incumbent_rank_ic=inc_ic)
        entry = self.registry.get(cand_key)
        out.update(promoted=True, generation=entry.generation, precision=entry.precision)
        return out

    def _cmd_admit(self, req: dict) -> dict:
        """The {"cmd": "admit"} request, answered outside the tick lock (after
        it in `handle_batch`, on the admission thread under a `TickScheduler`):
        the flip takes effect from the next tick."""
        rid = req.get("id")
        if not isinstance(req.get("path"), str):
            return {"id": rid, "ok": False, "error": "admit wants a 'path' (candidate "
                    "weights directory) and an 'alias'"}
        try:
            return {"id": rid, "cmd": "admit", **self.admit(
                req["path"], req.get("alias", "prod"),
                holdout_days=req.get("holdout_days"),
                min_margin=float(req.get("min_margin", 0.0) or 0),
                drift_threshold=req.get("drift_threshold"),
                precision=req.get("precision"), trace=req.get("trace"))}
        except Exception as e:     # noqa: BLE001 - the incumbent keeps serving
            return {"id": rid, "ok": False, "error": str(e)}

    # ---- public API ------------------------------------------------------

    def handle_batch(self, requests: list) -> list:
        """Responses, in order, for one tick of requests, under the tick
        lock; admit commands are answered after it, in their slots."""
        t0 = time.perf_counter()
        admits: list = []
        with self._lock:
            self.ticks += 1
            bases = [self._ingress_ctx(r) for r in requests]
            traced = [b for b in bases if b is not None]
            tick_fields: dict = {}
            self._tick_span = None
            if traced:
                self._tick_span = f"{traced[0]['span_id']}.t{self.ticks}"
                tick_fields = dict(span=self._tick_span,
                                   traces=sorted({b["trace_id"] for b in traced})[:16],
                                   members=[b["span_id"] for b in traced][:64])
            with timeline_span("serve_tick", cat="serve", resource="serve",
                               requests=len(requests), **tick_fields):
                resolved = [self._resolve(r) for r in requests]
                for r, base in zip(resolved, bases):
                    if base is not None:
                        self._trace_seq += 1
                        r.trace = {"trace_id": base["trace_id"], "base": base["span_id"],
                                   "n": self._trace_seq}
                self._dispatch(resolved)
                out = []
                for r in resolved:
                    if r.cmd == "admit":
                        admits.append((len(out), r))
                        out.append(None)
                        continue
                    tf: dict = {}
                    if r.trace is not None:
                        tf = dict(trace=r.trace["trace_id"],
                                  span=f"{r.trace['base']}.r{r.trace['n']}",
                                  parent=(r.dispatch_span or self._tick_span
                                          or r.trace["base"]))
                    with timeline_span("serve_request", cat="serve", resource="serve",
                                       model=r.entry.key if r.entry else None, **tf):
                        out.append(self._respond(r, t0))
        for i, r in admits:
            out[i] = self._cmd_admit(r.request)
        return out

    def handle(self, request: dict) -> dict:
        return self.handle_batch([request])[0]

    @property
    def closing(self) -> bool:
        return self._closing

    def request_drain(self) -> None:
        """Finish the tick in flight, answer it and stop. Called from the
        serving loops (never from a signal handler: it writes the timeline)."""
        with self._lock:
            if not self._draining:
                self._draining = True
                timeline_event("sigterm_drain", cat="recovery", resource="serve",
                               requests_served=self.requests_served)
            self._closing = True

    def health(self) -> dict:
        """The sliding window's error rate: degraded past `degraded_at` or
        with an open breaker, failing past `failing_at`, draining once
        closing."""
        with self._lock:
            n = len(self._outcomes)
            errs = sum(1 for ok in self._outcomes if not ok)
            rate = errs / n if n else 0.0
            open_b = self.open_breakers()
            if self._closing or rate >= self.failing_at:
                status = "failing" if not self._closing else "draining"
            elif rate >= self.degraded_at or open_b:
                status = "degraded"
            else:
                status = "ok"
            return {"status": status, "ok": status in ("ok", "degraded"),
                    "error_rate": round(rate, 4), "window": n, "open_breakers": open_b,
                    "deadline_misses": self.deadline_misses,
                    "breaker_fast_fails": self.breaker_fast_fails}

    def breaker_states(self) -> dict:
        """key -> {"fails", "open"} for every entry the breaker has seen."""
        with self._lock:
            open_b = set(self.open_breakers())
            return {k: {"fails": b.get("fails", 0), "open": k in open_b}
                    for k, b in self._breakers.items()}

    def stats(self) -> dict:
        import torch

        from factorvae_tpu_torch.ops.kernels import attention, gru

        launches = {f.__name__: f.launches for f in (
            gru.gru_fwd, gru.gru_fwd_residuals, gru.gru_bwd, gru.gru_dwh,
            attention.attention_fwd, attention.attention_bwd)}
        device = self.dataset.device
        reserved = (torch.cuda.memory_reserved(device)
                    if torch.device(device).type == "cuda" else None)
        with self._lock:
            return {"run_meta": self.run_meta,
                    "requests_served": self.requests_served,
                    "dispatches": self.dispatches,
                    "fused_requests": self.fused_requests,
                    "ticks": self.ticks, "admits": self.admits,
                    "promotions": self.promotions, "health": self.health(),
                    "registry": self.registry.stats(), "drift": self.drift.stats(),
                    # this process's kernel launch counters: each worker of
                    # a pool reports its own
                    "kernel_launches": launches,
                    "panel": {"n_days": int(len(self.dataset.dates)),
                              "n_max": int(self.dataset.n_max),
                              "residency": self.dataset.residency,
                              "device": str(self.dataset.device),
                              # the caching allocator's hold on the card
                              "memory_reserved": reserved}}


class TickScheduler:
    """Continuous batching for the threaded HTTP front: concurrent clients'
    requests land in one queue, and one scheduler thread, the only caller of
    `handle_batch`, drains it into ticks. A backlog of `max_tick_batch`
    dispatches at once (the last tick's wall was the batching window); a
    shallow queue waits up to `tick_ms` for late arrivals.

    Admit commands (`{"cmd": "admit"}`, and POST /admit) queue for a second
    thread, the admission thread, which loads the candidate and scores the
    gate while ticks go on; only the alias flip takes the tick lock, as in
    `ScoringDaemon.admit`. Neither thread is a handler thread.

    `submit` runs on any number of handler threads and blocks until its
    requests are answered, in order. A traced request's wait is a
    `serve_queue` span, begun on the handler thread and ended on the thread
    that takes the request. `close()` stops both threads and answers
    whatever is still queued with `ok: false`."""

    def __init__(self, daemon: ScoringDaemon, tick_ms: float = 2.0,
                 max_tick_batch: int = 64):
        self.daemon = daemon
        self.tick_s = max(0.0, float(tick_ms)) / 1e3
        self.max_tick_batch = max(1, int(max_tick_batch))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # [request, results, slot, submission, queue-span token]
        self._q: deque = deque()
        self._admits: deque = deque()     # the same items, for admit commands
        self._closing = False
        self.ticks = 0
        self.scheduled = 0
        self.admitted = 0
        self._qseq = 0
        self.fused_ticks = 0       # ticks that carried more than one request
        self.max_queue_depth = 0
        # not daemon threads: close() joins them, so nothing exits mid-write
        self._thread = threading.Thread(target=self._loop, name="serve-tick-scheduler")
        self._admit_thread = threading.Thread(target=self._admit_loop, name="serve-admission")
        self._thread.start()
        self._admit_thread.start()

    def submit(self, requests: list) -> list:
        """Queue one client's requests; block until each is answered; the
        responses in request order. Parse errors answer in place."""
        results: list = [None] * len(requests)
        pending = 0
        done = threading.Event()
        sub = {"left": 0, "done": done}
        with self._lock:
            if self._closing:
                return [{"id": None, "ok": False, "error": SHUTTING_DOWN}
                        for _ in requests]
            for i, r in enumerate(requests):
                if isinstance(r, dict) and "_parse_error" in r:
                    results[i] = {"id": None, "ok": False, "error": r["_parse_error"]}
                    continue
                qtok = None
                ctx = wire_ctx(r) if self.daemon.trace_enabled else None
                if ctx is not None:
                    # re-parent a copy under the queue span
                    self._qseq += 1
                    qspan = f"{ctx['span_id']}.q{self._qseq}"
                    r = dict(r)
                    r["trace"] = {"trace_id": ctx["trace_id"], "span_id": qspan}
                    qtok = timeline_span_begin("serve_queue", cat="serve",
                                               resource="scheduler", trace=ctx["trace_id"],
                                               span=qspan, parent=ctx["span_id"])
                is_admit = isinstance(r, dict) and r.get("cmd") == "admit"
                (self._admits if is_admit else self._q).append([r, results, i, sub, qtok])
                pending += 1
            sub["left"] = pending
            self.scheduled += pending
            self.max_queue_depth = max(self.max_queue_depth, len(self._q))
            if pending:
                self._cv.notify_all()
        # a timed wait: if a scheduler thread died, answer instead of
        # blocking forever
        while pending and not done.wait(1.0):
            if self._thread.is_alive() and self._admit_thread.is_alive():
                continue
            with self._lock:
                for i in range(len(results)):
                    if results[i] is None:
                        results[i] = {"id": None, "ok": False,
                                      "error": "scheduler thread died before answering"}
            break
        return results

    def _next_batch(self):
        """Block until work exists, then the depth-aware window; None only at
        close."""
        with self._lock:
            while not self._q and not self._closing:
                self._cv.wait(0.25)
            if not self._q:
                return None
            if len(self._q) < self.max_tick_batch and self.tick_s > 0:
                deadline = time.monotonic() + self.tick_s
                while len(self._q) < self.max_tick_batch and not self._closing:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
            n = min(len(self._q), self.max_tick_batch)
            batch = [self._q.popleft() for _ in range(n)]
            self.ticks += 1
            if n > 1:
                self.fused_ticks += 1
            return batch

    def _answer(self, batch, responses) -> None:
        finished = []
        with self._lock:
            for (_, results, i, sub, _), resp in zip(batch, responses):
                results[i] = resp
                sub["left"] -= 1
                if sub["left"] == 0:
                    finished.append(sub["done"])
        for ev in finished:
            ev.set()

    def _loop(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            for item in batch:        # the queue wait ends as the tick takes it
                timeline_span_end(item[4])
                item[4] = None
            try:
                responses = self.daemon.handle_batch([item[0] for item in batch])
            except Exception as e:     # noqa: BLE001 - the tick's requests answer
                responses = [{"id": None, "ok": False, "error": f"tick failed: {e}"}
                             for _ in batch]
            self._answer(batch, responses)

    def _admit_loop(self) -> None:
        """One admission at a time, in arrival order, off the tick thread."""
        while True:
            with self._lock:
                while not self._admits and not self._closing:
                    self._cv.wait(0.25)
                if not self._admits:
                    return
                item = self._admits.popleft()
                self.admitted += 1
            timeline_span_end(item[4])
            item[4] = None
            self._answer([item], [self.daemon._cmd_admit(item[0])])

    def stats(self) -> dict:
        with self._lock:
            return {"tick_ms": round(self.tick_s * 1e3, 3),
                    "max_tick_batch": self.max_tick_batch, "ticks": self.ticks,
                    "scheduled": self.scheduled, "fused_ticks": self.fused_ticks,
                    "admitted": self.admitted, "max_queue_depth": self.max_queue_depth,
                    "queued": len(self._q) + len(self._admits)}

    def close(self) -> None:
        """Stop taking work, let both threads finish their queues, join
        them, and answer anything left. Idempotent."""
        with self._lock:
            self._closing = True
            self._cv.notify_all()
        for thread in (self._thread, self._admit_thread):
            if thread.is_alive():
                thread.join(timeout=60)
        leftovers = []
        with self._lock:
            for q in (self._q, self._admits):
                while q:
                    leftovers.append(q.popleft())
        if leftovers:
            for item in leftovers:
                timeline_span_end(item[4], outcome="cancelled")
                item[4] = None
            self._answer(leftovers, [{"id": None, "ok": False,
                                      "error": SHUTTING_DOWN}
                                     for _ in leftovers])


# ---------------------------------------------------------------------------
# Front ends
# ---------------------------------------------------------------------------


def _parse_line(line: str) -> list:
    """One JSONL line -> a list of requests (an array is one tick); a parse
    failure is one request that answers `ok: false`."""
    try:
        obj = json.loads(line)
    except ValueError as e:
        return [{"_parse_error": f"bad JSON: {e}"}]
    return obj if isinstance(obj, list) else [obj]


def _with_parse_errors(daemon: ScoringDaemon, requests: list) -> list:
    ok, responses_at = [], {}
    for i, r in enumerate(requests):
        if isinstance(r, dict) and "_parse_error" in r:
            responses_at[i] = {"id": None, "ok": False, "error": r["_parse_error"]}
        else:
            ok.append((i, r))
    answered = daemon.handle_batch([r for _, r in ok])
    for (i, _), resp in zip(ok, answered):
        responses_at[i] = resp
    return [responses_at[i] for i in range(len(requests))]


@contextlib.contextmanager
def _drain_on_sigterm(daemon: ScoringDaemon):
    """A SIGTERM handler that only sets an Event (yielded): the serving loop
    polls it and drains in its own code, since a handler that wrote the
    timeline could re-enter the lock of the write it interrupted. Off the
    main thread no handler can be installed, and nothing sets the Event."""
    import signal

    term = threading.Event()

    def on_term(signum, frame):
        term.set()

    try:
        prev = signal.signal(signal.SIGTERM, on_term)
    except ValueError:
        yield term
        return
    try:
        yield term
    finally:
        signal.signal(signal.SIGTERM, prev)


def _stdin_ticks(inp, tick_s: float, max_batch: int, stop=None):
    """Lists of raw lines, one per tick. On a selectable stream, lines that
    arrive within `tick_s` of each other join one tick (at most `max_batch`);
    otherwise each line is a tick. `stop` is polled when idle."""
    try:
        fd = inp.fileno()
    except (AttributeError, OSError, ValueError):
        for line in inp:
            if line.strip():
                yield [line]
        return
    import select

    buf = b""
    pending: list = []
    eof = False
    while True:
        while b"\n" in buf and len(pending) < max_batch:
            line, buf = buf.split(b"\n", 1)
            if line.strip():
                pending.append(line.decode(errors="replace"))
        if pending and len(pending) >= max_batch:
            yield pending
            pending = []
            continue
        if eof:
            if buf.strip():
                pending.append(buf.decode(errors="replace"))
                buf = b""
            if pending:
                yield pending
            return
        try:
            idle = 0.25 if stop is not None else None
            ready, _, _ = select.select([fd], [], [], tick_s if pending else idle)
        except OSError:
            eof = True
            continue
        if not ready:
            if pending:
                yield pending
                pending = []
            elif stop is not None and stop():
                return
            continue
        data = os.read(fd, 65536)
        if not data:
            eof = True
        else:
            buf += data


def serve_stdin(daemon: ScoringDaemon, inp, out, tick_s: float = 0.02,
                max_batch: int = 64) -> int:
    """JSONL request/response loop until EOF, a shutdown cmd or a SIGTERM
    drain (the tick in flight is answered first). Returns the number of
    requests answered."""
    answered = 0
    with _drain_on_sigterm(daemon) as term:

        def stop() -> bool:
            if term.is_set():
                daemon.request_drain()
            return daemon.closing

        for lines in _stdin_ticks(inp, tick_s, max_batch, stop=stop):
            if term.is_set():
                daemon.request_drain()
            requests = [r for line in lines for r in _parse_line(line)]
            for resp in _with_parse_errors(daemon, requests):
                out.write(json.dumps(resp) + "\n")
                answered += 1
            out.flush()
            if daemon.closing:
                break
    return answered


def serve_batch_file(daemon: ScoringDaemon, path: str, out, max_batch: int = 64) -> int:
    """Score a JSONL request file in ticks of `max_batch`, writing JSONL
    responses to `out`. Returns the number answered."""
    with open(path) as fh:
        lines = [ln for ln in fh if ln.strip()]
    requests = [r for line in lines for r in _parse_line(line)]
    answered = 0
    for i in range(0, len(requests), max_batch):
        for resp in _with_parse_errors(daemon, requests[i:i + max_batch]):
            out.write(json.dumps(resp) + "\n")
            answered += 1
    out.flush()
    return answered


def _serve_runstream(handler) -> None:
    """`GET /runstream?since=<byte offset>`, the fleet collector's transport
    (`obs/collect.py`), on the daemon's front and the router's: this
    process's metrics stream from `since`, cut at its last newline
    (`obs/live.tail_bytes`: a torn last line is never served), with the
    offset to resume from in `X-Runstream-Next`. A process without a
    metrics stream answers an empty payload."""
    from urllib.parse import parse_qs, urlparse

    from factorvae_tpu_torch.obs.live import tail_bytes
    from factorvae_tpu_torch.utils.logging import current_timeline

    q = parse_qs(urlparse(handler.path).query)
    try:
        since = int(q.get("since", ["0"])[0])
    except ValueError:
        since = 0
    jsonl = getattr(getattr(current_timeline(), "logger", None), "jsonl_path", None)
    payload, nxt = tail_bytes(jsonl, since) if jsonl else (b"", 0)
    handler.send_response(200)
    handler.send_header("Content-Type", "application/x-ndjson")
    handler.send_header("Content-Length", str(len(payload)))
    handler.send_header("X-Runstream-Next", str(nxt))
    handler.end_headers()
    handler.wfile.write(payload)


def _profile_answer(req) -> tuple:
    """(HTTP code, payload) of a POST /profile body."""
    from factorvae_tpu_torch.utils.profiling import ProfilerError, start_profile, stop_profile

    req = req if isinstance(req, dict) else {}
    action = req.get("action")
    try:
        if action == "start":
            return 200, {"ok": True, "action": "start",
                         "log_dir": start_profile(req.get("log_dir"))}
        if action == "stop":
            return 200, {"ok": True, "action": "stop",
                         **stop_profile(top=int(req.get("top", 10)))}
    except ProfilerError as e:
        return 409, {"ok": False, "error": str(e)}
    return 400, {"ok": False, "error": "POST /profile wants {\"action\": \"start\"|"
                                      "\"stop\"} (optional \"log_dir\" on start)"}


def serve_http(daemon: ScoringDaemon, port: int, host: str = "127.0.0.1",
               scheduler: Optional[TickScheduler] = None, ready=None):
    """A stdlib HTTP front: POST /score (an object or an array), /admit and
    /profile ({"action": "start" | "stop"}, optional "log_dir" on start and
    "top" on stop: a `torch.profiler` capture of every thread, whose stop
    answers the capture's summary); GET /stats, /models, /healthz (503 only
    when failing or draining), /metrics (Prometheus text) and
    /runstream?since=N (`_serve_runstream`). A request's `X-Factorvae-Trace`
    header is its trace context. Blocks until a shutdown request or a SIGTERM
    drain. Single-threaded, unless a `scheduler` is given: then a
    ThreadingHTTPServer whose /score goes through the scheduler's tick
    thread and /admit through its admission thread, so no handler thread
    touches the card. `ready`, when given, is
    called with the bound server before the loop (port 0 binds any free
    port)."""
    from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer

    from factorvae_tpu_torch.obs.metrics import CONTENT_TYPE, daemon_metrics

    class Handler(BaseHTTPRequestHandler):
        # keep-alive on the threaded front only: one keep-alive client would
        # hold the single-threaded front's only accept loop
        protocol_version = "HTTP/1.1" if scheduler is not None else "HTTP/1.0"

        def _send_body(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            try:
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                # the client left: a router shuts the socket of a hedged
                # forward that lost its race
                self.close_connection = True

        def _send(self, code: int, payload) -> None:
            self._send_body(code, json.dumps(payload).encode(), "application/json")

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            if self.path == "/healthz":
                health = daemon.health()
                health["mono"] = timeline_now()
                self._send(200 if health["ok"] else 503, health)
            elif self.path == "/stats":
                payload = daemon.stats()
                if scheduler is not None:
                    payload["scheduler"] = scheduler.stats()
                self._send(200, payload)
            elif self.path == "/models":
                self._send(200, {"run_meta": daemon.run_meta,
                                 "models": daemon.registry.stats()["entries"]})
            elif self.path == "/metrics":
                self._send_body(200, daemon_metrics(daemon).encode(), CONTENT_TYPE)
            elif self.path.startswith("/runstream"):
                _serve_runstream(self)
            else:
                self._send(404, {"ok": False, "error": f"unknown path {self.path}"})

        def _admit(self, req) -> None:
            if not (isinstance(req, dict) and isinstance(req.get("path"), str)):
                self._send(400, {"ok": False, "error":
                                 "POST /admit wants {\"path\": \"<weights dir>\", "
                                 "\"alias\": \"<serving alias>\"} (optional "
                                 "holdout_days, min_margin, drift_threshold, precision)"})
                return
            if scheduler is not None:
                resp = scheduler.submit([{**req, "cmd": "admit"}])[0]
                resp = {k: v for k, v in resp.items() if k not in ("id", "cmd")}
                self._send(200, resp)
                return
            try:
                self._send(200, daemon.admit(
                    req["path"], req.get("alias", "prod"),
                    holdout_days=req.get("holdout_days"),
                    min_margin=float(req.get("min_margin", 0.0) or 0),
                    drift_threshold=req.get("drift_threshold"),
                    precision=req.get("precision"), trace=req.get("trace")))
            except Exception as e:     # noqa: BLE001 - the incumbent keeps serving
                self._send(200, {"ok": False, "error": str(e)})

        def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
            if self.path not in ("/score", "/profile", "/admit"):
                self._send(404, {"ok": False, "error": f"unknown path {self.path}"})
                return
            n = int(self.headers.get("Content-Length") or 0)
            requests = _parse_line(self.rfile.read(n).decode())
            if self.path == "/profile":
                self._send(*_profile_answer(requests[0] if requests else {}))
                return
            if daemon.trace_enabled:
                hdr = parse_header(self.headers.get(TRACE_HEADER))
                if hdr is not None:
                    for r in requests:
                        if isinstance(r, dict) and "trace" not in r:
                            r["trace"] = hdr
            if self.path == "/admit":
                self._admit(requests[0] if requests else {})
                return
            if scheduler is not None:
                responses = scheduler.submit(requests)
            else:
                responses = _with_parse_errors(daemon, requests)
            self._send(200, responses if len(responses) != 1 else responses[0])

        def log_message(self, fmt, *args):  # stdout is the response stream
            timeline_event("http", cat="serve", resource="serve", line=fmt % args)

    server_cls = HTTPServer if scheduler is None else ThreadingHTTPServer
    try:
        server = server_cls((host, port), Handler)
    except Exception:
        if scheduler is not None:
            scheduler.close()      # a failed bind must still join the thread
        raise
    server.timeout = 0.25          # a drain ends the loop within one wait
    if ready is not None:
        ready(server)
    with _drain_on_sigterm(daemon) as term:
        try:
            while not daemon.closing:
                if term.is_set():
                    daemon.request_drain()
                    break
                server.handle_request()
        finally:
            if scheduler is not None:
                scheduler.close()
            server.server_close()
    return server
