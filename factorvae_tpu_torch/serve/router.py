"""HTTP router over a worker fleet (`factorvae_tpu/serve/router.py`): sticky
routing, failover, shedding, hedging and the fleet's control plane.

- **Sticky routing.** A scoring request routes by its `model` (key or
  alias) through bounded-load rendezvous hashing over the healthy workers:
  the owner is the first worker in the key's highest-random-weight ranking
  whose count of sticky keys is under ceil(keys / workers). A model's
  traffic concentrates on one worker (its warm registry entry lives in one
  place), and removing a worker remaps only its own keys. The ranking is
  also the failover order: a forward that fails goes to the next worker,
  and the failed one is marked for the pool's watcher.
- **Shedding.** Past `max_inflight` client requests in flight, or when no
  candidate worker is healthy, the router answers 503 with `retry_after_s`
  (and a `Retry-After` header) instead of queueing.
- **Hedging.** Once a forward has been in flight past the hedge delay (a
  pinned `hedge_ms`, else the `hedge_quantile` of the router's sliding
  latency window once `hedge_min_samples` are in), the same request goes to
  the key's second candidate; the first answer wins and the loser's socket
  is shut down. A hedged pair is one request in every counter and one
  latency sample; `hedges` / `hedge_wins` count the duplication. Scoring is
  idempotent, which makes the duplicate safe.
- **Telemetry.** `GET /metrics` prepends the router's families to every
  live worker's exposition, relabeled with `worker_id` and merged under one
  HELP/TYPE per family (`obs.metrics.merge_expositions`). `GET /stats`
  carries the router's counters and the pool's worker table with each
  worker's scrape URLs. `GET /healthz` is 200 while any worker is healthy.
- **Control plane.** `POST /admit` is the pool's fan-out; `POST /register`
  adopts a remote worker (refused on a capability mismatch), `POST
  /deregister` is its graceful leave; `GET /artifacts` and `GET
  /artifact/<sha256>` are the content-addressed artifact service a cold
  host joins from; `POST /upgrade` starts the pool's rolling upgrade on a
  thread.
- **Traces.** Every `/score` request gets a root trace context at ingress
  (`r-<request count>`, or a child of an incoming `X-Factorvae-Trace`),
  carried on every forward leg as the header and a per-request `trace`
  field; hedge legs are sibling spans `h0`/`h1`, failover attempts chain.
  `GET /runstream?since=N` serves the router's metrics stream from byte N
  (the daemon's `_serve_runstream`), which `obs/collect.collect_fleet`
  merges with its workers' onto the router's clock.

Requests without a model (`cmd` requests) route to the owner of the key
`#cmd`; a shutdown command is not fanned out (stopping the fleet is the
pool's drain). Threading: a ThreadingHTTPServer, one thread per client
connection; the router's counters live behind `self._lock`, the worker
table behind the pool's.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import http.client
import json
import queue
import socket
import threading
import time
from typing import List, Optional

from factorvae_tpu_torch.obs.trace import (
    TRACE_HEADER,
    child,
    format_header,
    parse_header,
    span_fields,
    wire_ctx,
)
from factorvae_tpu_torch.serve.daemon import SHUTTING_DOWN
from factorvae_tpu_torch.serve.pool import WorkerPool, free_port
from factorvae_tpu_torch.utils.logging import (
    timeline_event,
    timeline_now,
    timeline_span,
    timeline_span_at,
)


class _Cancelled(Exception):
    """A hedge leg lost the race (the winner shut its socket): not a worker
    failure, so neither a retry nor a mark."""


def rendezvous_order(key: str, worker_ids: List[str]) -> List[str]:
    """Workers ranked by highest-random-weight hash (sha256, the same in
    every process) for `key`: the owner first, then the failover order.
    Removing a worker remaps only the keys it owned."""

    def weight(wid: str) -> int:
        return int.from_bytes(hashlib.sha256(f"{key}|{wid}".encode()).digest()[:8], "big")

    return sorted(worker_ids, key=lambda w: (-weight(w), w))


class Router:
    """Routing state over one `WorkerPool`. `serve()` runs the blocking CLI
    loop; `start()` / `stop()` run it on a thread. `max_inflight=0` turns the
    depth shed off; `hedge_ms < 0` measures the hedge delay: the
    HEDGE_QUANTILE of the latency window once it holds HEDGE_MIN_SAMPLES."""

    SHED_RETRY_S = 1.0           # the retry_after_s of a shed answer
    FORWARD_TIMEOUT_S = 600.0    # a forward's socket timeout
    HEDGE_QUANTILE = 0.9
    HEDGE_MIN_SAMPLES = 20       # an unmeasured fleet does not guess a delay

    def __init__(self, pool: WorkerPool, max_inflight: int = 64, slo_ms: float = 0.0,
                 hedge_ms: float = -1.0, hedge: bool = True, trace: bool = True):
        from factorvae_tpu_torch.obs.metrics import LatencyHistogram

        self.pool = pool
        self.trace_enabled = bool(trace)
        self.max_inflight = int(max_inflight)
        self.slo_ms = float(slo_ms)         # 0: none declared
        self.hedge_enabled = bool(hedge)
        self.hedge_ms = float(hedge_ms)
        self._lock = threading.Lock()
        self.requests = 0
        self.forwarded = 0
        self.shed = 0
        self.reroutes = 0
        self.proxy_errors = 0
        self.inflight = 0
        self.hedges = 0
        self.hedge_wins = 0
        # one sample per client request (a hedged pair lands one): the
        # window feeds the hedge delay and /stats, the histogram /metrics
        self.lat_hist = LatencyHistogram()
        self._lat_window: collections.deque = collections.deque(maxlen=512)
        self._worker_inflight: dict = {}
        self.autoscaler = None       # set by the CLI with --autoscale
        self.last_upgrade: Optional[dict] = None
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        # keep-alive worker connections, each held by one forward at a time
        self._conns: dict = {}
        self._assign: dict = {}      # sticky owners: model key -> worker id

    def _candidates(self, key: str, healthy: List[str]) -> List[str]:
        """The key's forward order: the sticky owner (cached, else placed by
        bounded-load rendezvous: the first worker in the ranking whose
        sticky-key count is under ceil(keys / workers)), then the ranking."""
        if not healthy:
            return []
        order = rendezvous_order(key, healthy)
        with self._lock:
            wid = self._assign.get(key)
            if wid not in healthy:
                counts = {w: 0 for w in healthy}
                live = 0
                for w in self._assign.values():
                    if w in counts:
                        counts[w] += 1
                        live += 1
                bound = -(-(live + 1) // len(healthy))
                wid = next((w for w in order if counts[w] < bound), order[0])
                self._assign[key] = wid
        order.remove(wid)
        return [wid] + order

    # ---- routing ---------------------------------------------------------

    def _shed_response(self, why: str) -> dict:
        with self._lock:
            self.shed += 1
        return {"ok": False,
                "error": f"router shedding load: {why}; retry in {self.SHED_RETRY_S:g}s",
                "retry_after_s": self.SHED_RETRY_S}

    def route_batch(self, requests: list, ctx: Optional[dict] = None) -> list:
        """Answer one client submission: group the requests by their sticky
        worker, forward the groups concurrently, and merge the answers in
        request order. A request with no healthy candidate, or whose every
        forward failed, answers in place. `ctx` is the root trace context."""
        if ctx is not None:
            with timeline_span("router_ingress", cat="serve", resource="router",
                               **span_fields(ctx, requests=len(requests))):
                return self._route_batch(requests, ctx)
        return self._route_batch(requests, None)

    def _route_batch(self, requests: list, ctx: Optional[dict]) -> list:
        healthy = self.pool.healthy_ids()
        groups: dict = {}
        responses: list = [None] * len(requests)
        for i, req in enumerate(requests):
            if isinstance(req, dict) and "_parse_error" in req:
                responses[i] = {"id": None, "ok": False, "error": req["_parse_error"]}
                continue
            key = str(req["model"]) if isinstance(req, dict) and req.get("model") else "#cmd"
            order = self._candidates(key, healthy)
            if not order:
                responses[i] = self._shed_response("no healthy worker")
                continue
            groups.setdefault(tuple(order), []).append((i, req))
        group_list = list(groups.items())
        threads = [threading.Thread(target=self._forward_group,
                                    args=(list(order), items, responses, ctx, gi),
                                    name="router-forward")
                   for gi, (order, items) in enumerate(group_list[1:], 1)]
        for t in threads:
            t.start()
        if group_list:
            order, items = group_list[0]
            self._forward_group(list(order), items, responses, ctx, 0)
        for t in threads:
            t.join()
        return responses

    def _forward(self, wid: str, host: str, port: int, body: bytes,
                 cancel: Optional[threading.Event] = None, slot: Optional[list] = None,
                 trace_hdr: Optional[str] = None):
        """POST one group to a worker over a pooled keep-alive connection (a
        fresh one on first use or after a failure: a respawned worker keeps
        its port). A hedge leg passes `cancel` and `slot`, where its live
        connection parks so the winner can shut it; a cancelled leg raises
        `_Cancelled` and never pools its connection."""
        last = None
        for fresh in (False, True):
            if cancel is not None and cancel.is_set():
                raise _Cancelled()
            conn = None
            if not fresh:
                with self._lock:
                    stack = self._conns.get(wid)
                    if stack:
                        conn = stack.pop()
            if conn is None:
                conn = http.client.HTTPConnection(host, port, timeout=self.FORWARD_TIMEOUT_S)
            if slot is not None:
                slot[0] = conn
            headers = {"Content-Type": "application/json"}
            if trace_hdr is not None:
                headers[TRACE_HEADER] = trace_hdr
            try:
                conn.request("POST", "/score", body=body, headers=headers)
                out = json.loads(conn.getresponse().read().decode() or "null")
            except (OSError, ValueError, http.client.HTTPException) as e:
                if slot is not None:
                    slot[0] = None
                with contextlib.suppress(OSError):
                    conn.close()
                if cancel is not None and cancel.is_set():
                    raise _Cancelled() from None    # the winner shut it mid-read
                last = e
                continue
            if slot is not None:
                slot[0] = None
            if cancel is not None and cancel.is_set():
                conn.close()
                raise _Cancelled()
            with self._lock:
                stack = self._conns.setdefault(wid, [])
                if len(stack) < 16:
                    stack.append(conn)
                    conn = None
            if conn is not None:
                conn.close()
            return out
        raise last

    def _try_forward(self, wid: str, body: bytes, n: int,
                     cancel: Optional[threading.Event] = None, slot: Optional[list] = None,
                     trace_hdr: Optional[str] = None) -> Optional[list]:
        """One forward attempt: the worker's `n` answers, else None. A
        transport failure counts a proxy error and marks the worker; a
        cancelled hedge leg counts nothing."""
        worker = self.pool.worker(wid)
        with self._lock:
            self._worker_inflight[wid] = self._worker_inflight.get(wid, 0) + 1
        try:
            out = self._forward(wid, worker.host, worker.port, body, cancel=cancel,
                                slot=slot, trace_hdr=trace_hdr)
        except _Cancelled:
            return None
        except Exception as e:   # noqa: BLE001 - the failover takes over
            with self._lock:
                self.proxy_errors += 1
            self.pool.note_failure(wid)
            timeline_event("router_reroute", cat="serve", resource="router", worker=wid,
                           error=str(e)[:200])
            return None
        finally:
            with self._lock:
                self._worker_inflight[wid] = max(0, self._worker_inflight.get(wid, 1) - 1)
        if isinstance(out, dict):
            out = [out]
        if not isinstance(out, list) or len(out) != n:
            with self._lock:
                self.proxy_errors += 1
            return None
        if any(isinstance(o, dict) and o.get("error") == SHUTTING_DOWN for o in out):
            # a draining worker that scored nothing: fail over, as if it
            # were gone (scoring is idempotent)
            with self._lock:
                self.proxy_errors += 1
            self.pool.note_failure(wid)
            return None
        return out

    # ---- hedging ---------------------------------------------------------

    def _hedge_delay_s(self) -> Optional[float]:
        """Seconds before a forward is duplicated, or None: hedging off, or
        measuring with fewer than `hedge_min_samples` latencies."""
        if not self.hedge_enabled:
            return None
        if self.hedge_ms >= 0:
            return self.hedge_ms / 1e3
        with self._lock:
            if len(self._lat_window) < self.HEDGE_MIN_SAMPLES:
                return None
            lat = sorted(self._lat_window)
        return lat[min(len(lat) - 1, int(self.HEDGE_QUANTILE * len(lat)))]

    @staticmethod
    def _cancel_leg(cancel: threading.Event, slot: list) -> None:
        """Wake a losing leg: set its flag and shut its socket (`close()`
        alone does not interrupt a blocked read; `shutdown` does)."""
        cancel.set()
        conn = slot[0]
        if conn is not None:
            with contextlib.suppress(OSError):
                if getattr(conn, "sock", None) is not None:
                    conn.sock.shutdown(socket.SHUT_RDWR)
            with contextlib.suppress(OSError):
                conn.close()

    def _forward_hedged(self, primary: str, secondary: str, body_for, n: int,
                        delay_s: float, ctx: Optional[dict] = None, prefix: str = ""):
        """Forward to `primary`; past `delay_s` without an answer, also to
        `secondary`: the first valid answer wins, the loser is cancelled.
        Returns (out, wid, hedged); an answer or failure before the delay
        returns (out or None, primary, False) and the caller's serial
        failover goes on. `body_for(leg_ctx)` serializes the group for one
        leg (each leg has its own span id); each leg writes its
        `router_forward` span once the race is settled."""
        q: "queue.Queue" = queue.Queue()
        legs: dict = {}
        verdict: dict = {}
        settled = threading.Event()

        def run(wid: str, leg: str) -> None:
            cancel, slot = legs[wid]
            leg_ctx = child(ctx, leg) if ctx is not None else None
            hdr = format_header(leg_ctx) if leg_ctx is not None else None
            t0 = time.perf_counter()
            out = self._try_forward(wid, body_for(leg_ctx), n, cancel=cancel, slot=slot,
                                    trace_hdr=hdr)
            t1 = time.perf_counter()
            q.put((wid, out))
            if leg_ctx is None:
                return
            settled.wait(timeout=30.0)
            if out is None:
                outcome = "cancelled" if cancel.is_set() else "error"
            else:
                outcome = verdict.get(wid, "ok")
            timeline_span_at("router_forward", t0, t1, cat="serve", resource="router",
                             worker=wid, hedge=leg, outcome=outcome, **span_fields(leg_ctx))

        def launch(wid: str, leg: str) -> None:
            legs[wid] = (threading.Event(), [None])
            threading.Thread(target=run, args=(wid, leg), name="router-hedge").start()

        try:
            launch(primary, f"{prefix}h0")
            try:
                wid, out = q.get(timeout=delay_s)
            except queue.Empty:          # the primary is past the delay
                with self._lock:
                    self.hedges += 1
                timeline_event("router_hedge", cat="serve", resource="router",
                               primary=primary, secondary=secondary,
                               delay_ms=round(delay_s * 1e3, 3),
                               **({"trace": ctx["trace_id"]} if ctx else {}))
                launch(secondary, f"{prefix}h1")
                wid, out = q.get()
                if out is None:
                    wid, out = q.get()   # the first finisher failed
            else:
                return out, wid, False
            if out is not None:
                with self._lock:
                    if wid == secondary:
                        self.hedge_wins += 1
                verdict[wid] = "winner"
                for lw in legs:
                    verdict.setdefault(lw, "loser")
                for lw, (cancel, slot) in legs.items():
                    if lw != wid:
                        self._cancel_leg(cancel, slot)
            return out, wid, True
        finally:
            settled.set()

    def _forward_group(self, order: List[str], items: list, responses: list,
                       ctx: Optional[dict] = None, gi: int = 0) -> None:
        def body_for(leg_ctx: Optional[dict]) -> bytes:
            # each leg stamps its span id into every request's trace field
            if leg_ctx is None:
                return json.dumps([req for _, req in items]).encode()
            reqs = []
            for _, req in items:
                if isinstance(req, dict):
                    req = dict(req)
                    req["trace"] = {"trace_id": leg_ctx["trace_id"],
                                    "span_id": leg_ctx["span_id"]}
                reqs.append(req)
            return json.dumps(reqs).encode()

        prefix = f"g{gi}" if gi else ""
        n = len(items)
        t0 = time.monotonic()
        out, wid, start = None, None, 0
        delay = self._hedge_delay_s() if len(order) >= 2 else None
        if delay is not None:
            out, wid, hedged = self._forward_hedged(order[0], order[1], body_for, n, delay,
                                                    ctx=ctx, prefix=prefix)
            start = 2 if hedged else 1
            if out is None and start < len(order):
                with self._lock:
                    self.reroutes += 1
        if out is None:
            # serial failover: attempt k+1 is a child of attempt k's span
            parent_ctx = ctx
            for attempt in range(start, len(order)):
                wid = order[attempt]
                leg_ctx = child(parent_ctx, f"{prefix}f{attempt}") if parent_ctx else None
                hdr = format_header(leg_ctx) if leg_ctx is not None else None
                lt0 = time.perf_counter()
                out = self._try_forward(wid, body_for(leg_ctx), n, trace_hdr=hdr)
                lt1 = time.perf_counter()
                if leg_ctx is not None:
                    timeline_span_at("router_forward", lt0, lt1, cat="serve",
                                     resource="router", worker=wid,
                                     outcome="ok" if out is not None else "error",
                                     **span_fields(leg_ctx))
                if out is not None:
                    break
                parent_ctx = leg_ctx or parent_ctx
                if attempt + 1 < len(order):
                    with self._lock:
                        self.reroutes += 1
        if out is not None:
            dt = time.monotonic() - t0
            tid = ctx["trace_id"] if ctx is not None else None
            with self._lock:
                self.forwarded += n
                self._lat_window.extend([dt] * n)
            for _ in range(n):
                self.lat_hist.observe(dt, trace_id=tid)
            for (i, _), resp in zip(items, out):
                if isinstance(resp, dict):
                    resp.setdefault("worker", wid)
                responses[i] = resp
            return
        shed = self._shed_response("every candidate worker failed")
        for i, _ in items:
            responses[i] = dict(shed)

    # ---- telemetry -------------------------------------------------------

    def healthz(self) -> dict:
        pool = self.pool.stats()
        healthy, total = pool["healthy"], len(pool["workers"])
        if pool["draining"]:
            status = "draining"
        elif healthy == 0:
            status = "failing"
        elif healthy < total:
            status = "degraded"
        else:
            status = "ok"
        return {"status": status, "ok": status in ("ok", "degraded"),
                "workers_healthy": healthy, "workers": total}

    def _quantiles(self):
        """(p50_ms, p99_ms) over the latency window; (None, None) before any
        request."""
        with self._lock:
            lat = sorted(self._lat_window)
        if not lat:
            return None, None
        return tuple(lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3 for p in (0.5, 0.99))

    def autoscale_signals(self) -> dict:
        """What the autoscaler decides from and /metrics exports: queue
        depth, p50/p99 against the SLO, worker liveness, in-flight forwards
        per worker."""
        p50, p99 = self._quantiles()
        pool = self.pool.stats()
        with self._lock:
            return {"queue_depth": self.inflight, "p50_ms": p50, "p99_ms": p99,
                    "slo_ms": self.slo_ms, "workers_healthy": pool["healthy"],
                    "workers_total": len(pool["workers"]),
                    "worker_inflight": dict(self._worker_inflight)}

    def stats(self) -> dict:
        import torch

        delay = self._hedge_delay_s()
        p50, p99 = self._quantiles()
        with self._lock:
            router = {"requests": self.requests, "forwarded": self.forwarded,
                      "shed": self.shed, "reroutes": self.reroutes,
                      "proxy_errors": self.proxy_errors, "inflight": self.inflight,
                      "max_inflight": self.max_inflight, "slo_ms": self.slo_ms,
                      "observed_p50_ms": p50, "observed_p99_ms": p99,
                      "worker_inflight": dict(self._worker_inflight),
                      # this process routes and exports; it never holds a
                      # CUDA context
                      "cuda_initialized": torch.cuda.is_initialized(),
                      "hedge": {"enabled": self.hedge_enabled,
                                "delay_ms": None if delay is None else round(delay * 1e3, 3),
                                "hedges": self.hedges, "hedge_wins": self.hedge_wins}}
        out = {"router": router, "health": self.healthz(), "pool": self.pool.stats()}
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.describe()
        if self.last_upgrade is not None:
            out["last_upgrade"] = self.last_upgrade
        return out

    def metrics(self) -> str:
        """The fleet's exposition: the router's families, then every live
        worker's `/metrics` relabeled with its `worker_id`, merged."""
        from factorvae_tpu_torch.obs.metrics import (
            PREFIX,
            autoscale_families,
            merge_expositions,
            metric_line,
        )

        pool = self.pool.stats()
        signals = self.autoscale_signals()
        with self._lock:
            counters = [
                ("requests_total", "counter", "client requests through the router",
                 self.requests),
                ("forwarded_total", "counter", "requests forwarded to a worker",
                 self.forwarded),
                ("shed_total", "counter", "requests shed with 503 + retry_after",
                 self.shed),
                ("reroutes_total", "counter", "forwards retried on a failover candidate",
                 self.reroutes),
                ("proxy_errors_total", "counter", "worker forwards that failed",
                 self.proxy_errors),
                ("hedges_total", "counter", "forwards duplicated past the hedge delay",
                 self.hedges),
                ("hedge_wins_total", "counter",
                 "hedged forwards won by the speculative duplicate", self.hedge_wins),
                ("inflight", "gauge", "client requests currently in flight",
                 self.inflight)]
        fam = [(f"{PREFIX}_router_{n}", typ, help_,
                [metric_line(f"{PREFIX}_router_{n}", v)]) for n, typ, help_, v in counters]
        fam.append((f"{PREFIX}_router_workers", "gauge", "pool workers by liveness",
                    [metric_line(f"{PREFIX}_router_workers", pool["healthy"],
                                 {"state": "healthy"}),
                     metric_line(f"{PREFIX}_router_workers", len(pool["workers"]),
                                 {"state": "total"})]))
        fam.append((f"{PREFIX}_router_respawns_total", "counter",
                    "workers respawned by the pool watcher",
                    [metric_line(f"{PREFIX}_router_respawns_total", pool["respawns"])]))
        fam.append((f"{PREFIX}_router_request_latency_seconds", "histogram",
                    "router-observed client request latency (a hedged pair observes "
                    "once)", self.lat_hist.render(
                        f"{PREFIX}_router_request_latency_seconds")))
        fam.extend(autoscale_families(signals))
        if self.autoscaler is not None:
            fam.extend(self.autoscaler.metric_families())
        parts = []
        for w in pool["workers"]:
            if w["state"] == "dead":
                continue
            try:
                text = self.pool.scrape_metrics(self.pool.worker(w["worker_id"]))
            except Exception as e:   # noqa: BLE001 - drop that worker's families only
                timeline_event("router_scrape_failed", cat="serve", resource="router",
                               worker=w["worker_id"], error=str(e)[:200])
                continue
            parts.append(({"worker_id": w["worker_id"]}, text))
        return merge_expositions(parts, extra_families=fam)

    # ---- HTTP front --------------------------------------------------------

    def _build_server(self, port: int, host: str):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from factorvae_tpu_torch.obs.metrics import CONTENT_TYPE
        from factorvae_tpu_torch.serve.daemon import _parse_line

        router = self

        class Handler(BaseHTTPRequestHandler):
            # threaded, with Content-Length on every response: keep-alive
            protocol_version = "HTTP/1.1"

            def _send_body(self, code: int, body: bytes, content_type: str,
                           retry_after: Optional[float] = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                if retry_after is not None:
                    self.send_header("Retry-After", f"{retry_after:g}")
                self.end_headers()
                self.wfile.write(body)

            def _send(self, code: int, payload, retry_after: Optional[float] = None) -> None:
                self._send_body(code, json.dumps(payload).encode(), "application/json",
                                retry_after)

            def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
                if self.path == "/healthz":
                    health = router.healthz()
                    self._send(200 if health["ok"] else 503, health)
                elif self.path == "/stats":
                    self._send(200, router.stats())
                elif self.path == "/metrics":
                    self._send_body(200, router.metrics().encode(), CONTENT_TYPE)
                elif self.path == "/artifacts":
                    self._send(200, router.pool.artifact_manifest())
                elif self.path.startswith("/runstream"):
                    from factorvae_tpu_torch.serve.daemon import _serve_runstream

                    _serve_runstream(self)
                elif self.path.startswith("/artifact/"):
                    sha = self.path[len("/artifact/"):]
                    path = router.pool.store.blob_path(sha)
                    if path is None:
                        self._send(404, {"ok": False, "error":
                                         f"no artifact with sha256 {sha[:16]}… in the "
                                         "store; GET /artifacts lists the aliases and "
                                         "digests this fleet serves"})
                        return
                    with open(path, "rb") as fh:
                        blob = fh.read()
                    self._send_body(200, blob, "application/octet-stream")
                else:
                    self._send(404, {"ok": False, "error":
                                     f"unknown path {self.path} (the router serves "
                                     "/score /admit /stats /metrics /healthz /runstream "
                                     "/artifacts /artifact/<sha256> /register "
                                     "/deregister /upgrade)"})

            def _control_body(self) -> Optional[dict]:
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    req = json.loads(self.rfile.read(n).decode() or "{}")
                except ValueError:
                    return None
                return req if isinstance(req, dict) else None

            def _register(self) -> None:
                req = self._control_body()
                if req is None or not req.get("port"):
                    self._send(400, {"ok": False, "error":
                                     "POST /register wants {\"port\": <int>, \"host\": "
                                     "\"...\" (default: the caller's address), "
                                     "\"capability\": \"<digest from GET /artifacts>\"}"})
                    return
                try:
                    w = router.pool.adopt_remote(str(req.get("host")
                                                     or self.client_address[0]),
                                                 int(req["port"]),
                                                 capability=req.get("capability"))
                except Exception as e:   # noqa: BLE001 - the caller's answer
                    self._send(400, {"ok": False, "error": str(e)})
                    return
                # `mono` lets the agent log a reverse clock probe
                self._send(200, {"ok": True, "worker": w.describe(),
                                 "mono": timeline_now()})

            def _deregister(self) -> None:
                wid = (self._control_body() or {}).get("worker_id")
                if not wid:
                    self._send(400, {"ok": False, "error":
                                     "POST /deregister wants {\"worker_id\": \"<wid>\"}"})
                    return
                try:
                    self._send(200, router.pool.deregister(str(wid)))
                except Exception as e:   # noqa: BLE001 - the caller's answer
                    self._send(400, {"ok": False, "error": str(e)})

            def _upgrade(self) -> None:
                self._control_body()

                def run_upgrade() -> None:
                    try:
                        router.last_upgrade = router.pool.rolling_upgrade()
                    except Exception as e:   # noqa: BLE001 - reported in /stats
                        router.last_upgrade = {"ok": False, "error": str(e)[:500]}

                router.last_upgrade = {"ok": None, "running": True}
                threading.Thread(target=run_upgrade, name="router-upgrade").start()
                self._send(200, {"ok": True, "started": True,
                                 "note": "rolling upgrade running in the background; "
                                         "watch last_upgrade in GET /stats"})

            def _admit(self, requests: list) -> None:
                req = requests[0] if requests else {}
                if not (isinstance(req, dict) and isinstance(req.get("path"), str)):
                    self._send(400, {"ok": False, "error":
                                     "POST /admit wants {\"path\": \"<weights dir>\", "
                                     "\"alias\": \"<alias>\"}; the router fans it out "
                                     "to every worker"})
                    return
                actx = None
                if router.trace_enabled:
                    up = parse_header(self.headers.get(TRACE_HEADER)) or wire_ctx(req)
                    if up is not None:
                        actx = child(up, "admit")
                        req = {**req, "trace": {"trace_id": actx["trace_id"],
                                                "span_id": actx["span_id"]}}
                if actx is None:
                    self._send(200, router.pool.admit_fanout(req))
                    return
                with timeline_span("router_admit", cat="serve", resource="router",
                                   **span_fields(actx)):
                    fanned = router.pool.admit_fanout(req)
                self._send(200, fanned)

            def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
                control = {"/register": self._register, "/deregister": self._deregister,
                           "/upgrade": self._upgrade}
                if self.path in control:
                    control[self.path]()
                    return
                if self.path not in ("/score", "/admit"):
                    self._control_body()
                    self._send(404, {"ok": False, "error": f"unknown path {self.path}"})
                    return
                n = int(self.headers.get("Content-Length") or 0)
                requests = _parse_line(self.rfile.read(n).decode())
                if self.path == "/admit":
                    self._admit(requests)
                    return
                single = len(requests) == 1
                ingress = None
                with router._lock:
                    router.requests += len(requests)
                    # a deterministic root (the request count, under the lock
                    # that counts it), or a child of an incoming context
                    if router.trace_enabled:
                        up = parse_header(self.headers.get(TRACE_HEADER))
                        ingress = (child(up, "rt") if up is not None
                                   else {"trace_id": f"r-{router.requests:06d}",
                                         "span_id": "in"})
                    overloaded = (router.max_inflight > 0
                                  and router.inflight >= router.max_inflight)
                    if not overloaded:
                        router.inflight += 1
                if overloaded:
                    shed = router._shed_response(f"inflight >= {router.max_inflight}")
                    self._send(503, shed if single else [dict(shed) for _ in requests],
                               retry_after=router.SHED_RETRY_S)
                    return
                try:
                    responses = router.route_batch(requests, ctx=ingress)
                finally:
                    with router._lock:
                        router.inflight -= 1
                first = responses[0] if responses else None
                if (single and isinstance(first, dict) and first.get("retry_after_s")
                        and "shedding" in str(first.get("error", ""))):
                    self._send(503, first, retry_after=router.SHED_RETRY_S)
                    return
                self._send(200, first if single else responses)

            def log_message(self, fmt, *args):  # stderr stays quiet
                timeline_event("router_http", cat="serve", resource="router",
                               line=fmt % args)

        server = ThreadingHTTPServer((host, port), Handler)
        server.timeout = 0.25
        return server

    def serve(self, port: int, host: str = "127.0.0.1") -> None:
        """The CLI loop: blocks until SIGTERM, then stops accepting and
        drains the pool (the daemon's set-a-flag SIGTERM shape)."""
        from factorvae_tpu_torch.serve.daemon import _drain_on_sigterm

        server = self._build_server(port, host)
        self.port = port
        with _drain_on_sigterm(None) as term:
            try:
                while not term.is_set():
                    server.handle_request()
            finally:
                server.server_close()
                self.pool.stop()

    def start(self, port: Optional[int] = None, host: str = "127.0.0.1") -> int:
        """Serve on a thread; returns the port. `stop()` shuts it down."""
        port = port or free_port()
        self._server = self._build_server(port, host)
        self.port = port
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        kwargs={"poll_interval": 0.1}, name="router-http")
        self._thread.start()
        return port

    def stop(self, stop_pool: bool = True) -> None:
        server, thread = self._server, self._thread
        self._server = self._thread = None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None and thread.is_alive():
            thread.join(timeout=30)
        if stop_pool:
            self.pool.stop()
