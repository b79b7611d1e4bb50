"""Scoring daemon: the request path over the model registry
(`factorvae_tpu/serve/daemon.py`, minimal).

`ScoringDaemon.handle_batch` answers one tick of JSON requests, in order:

  {"id", "model", "day" | "days" | "start"/"end", "top"?}  -> scores
  {"cmd": "ping" | "stats" | "shutdown"}

A scoring response carries `results` (one entry per day: `day`,
`instruments`, `scores`, best first when `top` is given), `n`, `model`,
`alias` and `latency_ms`. A bad request answers `{"ok": false, "error"}`
and never stops the daemon. `serve_stdin` drives it with one JSONL line per
tick (a line may hold an array of requests). `extend_dataset` appends
trading days to the serving panel under the tick lock: a tick in flight
finishes on the old day axis, and the next one can score the new days.
Fused multi-model dispatch,
breakers, deadlines, HTTP, tracing and drift monitoring are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Optional

import numpy as np

from factorvae_tpu_torch.data.panel import to_day
from factorvae_tpu_torch.serve.registry import Entry, ModelRegistry

_CMDS = ("ping", "stats", "shutdown")


@dataclasses.dataclass
class _Resolved:
    request: dict
    entry: Optional[Entry] = None
    days: Optional[np.ndarray] = None
    error: Optional[str] = None
    cmd: Optional[str] = None
    scores: Optional[np.ndarray] = None
    done_t: Optional[float] = None


class ScoringDaemon:
    """Request handler over (registry, dataset). `stochastic=False` serves
    deterministic scores; True/None sample as `predict_panel` does, from a
    generator seeded with `seed`."""

    def __init__(self, registry: ModelRegistry, dataset,
                 stochastic: Optional[bool] = False, seed: int = 0):
        self.registry = registry
        self.dataset = dataset
        self.stochastic = stochastic
        self.seed = seed
        self.requests_served = 0
        self.dispatches = 0
        self.errors = 0
        self.ticks = 0
        self.closing = False
        # a tick and an append of days exclude each other
        self._lock = threading.Lock()

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
        if "_parse_error" in req:
            return _Resolved(request={}, error=req["_parse_error"])
        cmd = req.get("cmd")
        if cmd is not None:
            if cmd not in _CMDS:
                return _Resolved(request=req, error=f"unknown cmd {cmd!r} "
                                 f"(known: {', '.join(_CMDS)})")
            return _Resolved(request=req, cmd=cmd)
        model = req.get("model")
        if not model:
            return _Resolved(request=req, error="request needs a 'model' (key or alias)")
        try:
            days = self._resolve_days(req)
            entry = self.registry.get(str(model))
        except ValueError as e:   # RegistryError is a ValueError
            return _Resolved(request=req, error=str(e))
        return _Resolved(request=req, entry=entry, days=days)

    def _dispatch(self, r: _Resolved) -> None:
        try:
            r.scores = self.registry.score(r.entry, self.dataset, r.days,
                                           stochastic=self.stochastic,
                                           seed=self.seed)
            r.done_t = time.perf_counter()
            self.dispatches += 1
        except (RuntimeError, ValueError) as e:
            # a failed dispatch (a CUDA error, a shape mismatch between the
            # model and the panel) answers this request, not the daemon
            r.error = str(e)

    def _respond(self, r: _Resolved, t0: float) -> dict:
        rid = r.request.get("id")
        if r.error is not None:
            self.errors += 1
            return {"id": rid, "ok": False, "error": r.error}
        if r.cmd == "shutdown":
            self.closing = True
            return {"id": rid, "ok": True, "cmd": "shutdown"}
        if r.cmd == "ping":
            return {"id": rid, "ok": True, "cmd": "ping"}
        if r.cmd == "stats":
            return {"id": rid, "ok": True, "cmd": "stats", **self.stats()}
        ds = self.dataset
        top = r.request.get("top")
        inst = np.asarray(ds.instruments)
        valid = ds.valid[r.days]
        results, n_total = [], 0
        for i, day in enumerate(r.days):
            idx = np.nonzero(valid[i])[0]
            idx = idx[idx < inst.size]
            names, vals = inst[idx], r.scores[i][idx]
            if top:
                order = np.argsort(-vals)[: int(top)]
                names, vals = names[order], vals[order]
            n_total += int(vals.size)
            results.append({"day": str(ds.dates[int(day)]),
                            "instruments": [str(s) for s in names],
                            "scores": [float(v) for v in vals]})
        self.requests_served += 1
        return {"id": rid, "ok": True, "model": r.entry.key,
                "alias": r.entry.alias, "n": n_total, "results": results,
                "latency_ms": round((r.done_t - t0) * 1e3, 3)}

    def handle_batch(self, requests: list) -> list:
        """Responses, in order, for one tick of requests."""
        with self._lock:
            t0 = time.perf_counter()
            self.ticks += 1
            resolved = [self._resolve(r) for r in requests]
            for r in resolved:
                if r.error is None and r.cmd is None:
                    self._dispatch(r)
            return [self._respond(r, t0) for r in resolved]

    def extend_dataset(self, piece) -> bool:
        """Append the trading days of the Panel `piece` to the serving panel
        (`PanelDataset.extend_days`) under the tick lock. True when days
        were added, False for the idempotent no-op."""
        with self._lock:
            return bool(self.dataset.extend_days(piece))

    def stats(self) -> dict:
        return {
            "requests_served": self.requests_served,
            "dispatches": self.dispatches,
            "errors": self.errors,
            "ticks": self.ticks,
            "device": str(self.dataset.device),
            "registry": self.registry.stats(),
            "panel": {"n_days": int(len(self.dataset.dates)),
                      "n_max": int(self.dataset.n_max),
                      "residency": self.dataset.residency},
        }


def _parse_line(line: str) -> list:
    """One JSONL line -> a list of requests (an array is one tick)."""
    try:
        obj = json.loads(line)
    except ValueError as e:
        return [{"_parse_error": f"bad JSON: {e}"}]
    return obj if isinstance(obj, list) else [obj]


def serve_stdin(daemon: ScoringDaemon, inp, out) -> int:
    """JSONL request/response loop until EOF or a shutdown cmd. Returns the
    number of requests answered."""
    answered = 0
    for line in inp:
        if not line.strip():
            continue
        for resp in daemon.handle_batch(_parse_line(line)):
            out.write(json.dumps(resp) + "\n")
            answered += 1
        out.flush()
        if daemon.closing:
            break
    return answered
