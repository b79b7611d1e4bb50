"""Pillar 5: the streaming run monitor — obs.report, while the run flies.

    python -m factorvae_tpu_torch.obs.live RUN.jsonl --follow [--json]
        [--poll 0.2] [--idle-timeout S]
        [--spike-mult 10] [--slow-frac 0.5] [--diverge-frac 0.2]
        [--diverge-epochs 3]

Every other obs surface reads a FINISHED stream. This one tail-follows
an in-flight RUN.jsonl — torn-line tolerant: a partially-written final
line (the async writer mid-record) is buffered, never parsed, and
emits exactly once when the writer completes it — and feeds the records
into the SAME flag logic `obs.report` uses (`build_report`: nonfinite,
grad_spike, val_divergence, slow_epoch, compile_storm, budget breaches,
recovery flags, score_drift), emitting an alert as each flag appears.

**Consistency pin** (tests/test_live.py): the monitor's final flag set
over an in-flight stream is IDENTICAL — same flags, same record
identities (`line`), same details — to `obs.report` run post-hoc on the
completed stream, because both run `build_report` over identically
parsed record lists. There is no second flag implementation to drift.

The retrospective checks (medians, divergence baselines) are honest
about being retrospective: a flag raised early can dissolve as later
records move the baseline (a slow-looking epoch 1 stops being slow once
the run median settles). The alert stream says so — a dissolved flag
emits a `resolved` alert — rather than pinning live semantics to a
weaker "first N records" judgment that post-hoc reports would then
contradict.

`obs.timeline --follow` and `obs.report --follow` delegate here, so one
CLI covers in-flight and finished runs.

A copy of `factorvae_tpu/obs/live.py` (host Python over the same records,
so both readers give the same output on a stream); the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterator, List, Optional, Tuple

from factorvae_tpu_torch.obs.timeline import RunStreamError

#: record routing shared with obs.timeline.load_run — one taxonomy,
#: never two (the consistency pin depends on it)
_EPOCH_EVENTS = ("epoch", "fleet_epoch")


class LiveRun:
    """Incremental accumulator with exactly `load_run`'s shape:
    {"spans", "marks", "epochs", "meta", "events"} plus `_stats`. Feed
    it raw lines in stream order and `run` stays what `load_run` would
    have parsed from the same prefix."""

    def __init__(self) -> None:
        self.run: dict = {"spans": [], "marks": [], "epochs": [],
                          "meta": [], "events": []}
        self.lines = 0      # physical lines seen (torn tail excluded)
        self.bad = 0
        self.records = 0

    def add_line(self, index: int, line: str) -> Optional[dict]:
        """Route one COMPLETE physical line (same skip/annotate rules as
        load_run); returns the parsed record or None."""
        text = line.strip()
        if not text:
            return None
        self.lines += 1
        try:
            rec = json.loads(text)
        except ValueError:
            self.bad += 1
            return None
        if not isinstance(rec, dict):
            self.bad += 1
            return None
        rec.setdefault("_line", index)
        ev = rec.get("event")
        if ev == "span":
            self.run["spans"].append(rec)
        elif ev == "mark":
            self.run["marks"].append(rec)
        elif ev in _EPOCH_EVENTS:
            self.run["epochs"].append(rec)
        elif ev == "run_meta":
            self.run["meta"].append(rec)
        else:
            self.run["events"].append(rec)
        self.records += 1
        return rec


def iter_lines(path: str, follow: bool = True, poll_s: float = 0.2,
               idle_timeout: Optional[float] = None,
               stop: Optional[Callable[[], bool]] = None,
               wait_for_file: bool = True,
               ) -> Iterator[Tuple[int, str]]:
    """Yield (physical_line_index, text) for each COMPLETE line of a
    growing JSONL file. The torn-line contract: bytes after the last
    newline stay buffered — a half-written record is never yielded, and
    yields exactly once when its newline lands. `follow=False` drains
    what exists and returns (the buffered tail, if any, is dropped
    exactly like `load_run`'s last_bad skip when it isn't valid yet —
    callers wanting finished-stream semantics use open_run instead).

    Under `follow=True` the generator polls for growth every `poll_s`
    and ends when `stop()` turns true or `idle_timeout` seconds pass
    with no new bytes (None = follow forever)."""
    deadline = None
    while not os.path.exists(path):
        if not follow or not wait_for_file:
            raise RunStreamError(f"cannot read {path}: no such file")
        if stop is not None and stop():
            return
        if deadline is None and idle_timeout is not None:
            deadline = time.perf_counter() + idle_timeout
        if deadline is not None and time.perf_counter() > deadline:
            return
        time.sleep(poll_s)
    buf = b""
    index = 0
    stopping = False
    idle_since = time.perf_counter()
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(65536)
            if chunk:
                idle_since = time.perf_counter()
                buf += chunk
                while b"\n" in buf:
                    raw, buf = buf.split(b"\n", 1)
                    yield index, raw.decode("utf-8", errors="replace")
                    index += 1
                continue
            if stopping or not follow:
                return
            if stop is not None and stop():
                # one more read pass before returning: bytes the writer
                # appended between our empty read and the stop signal
                # must not be lost to that race
                stopping = True
                continue
            if idle_timeout is not None and \
                    time.perf_counter() - idle_since > idle_timeout:
                return
            time.sleep(poll_s)


def tail_bytes(path: str, since: int = 0,
               max_bytes: int = 4 << 20) -> Tuple[bytes, int]:
    """Server side of ``GET /runstream?since=<offset>`` (pillar 6,
    obs/collect.py): the byte range [since, next) of a growing JSONL
    file, cut at the LAST newline so a torn final line — the writer
    mid-record — is never served; the client re-requests from ``next``
    and receives that line exactly once, complete. The same contract
    `iter_lines` keeps locally, spoken over HTTP. Returns (payload,
    next_offset); missing file or out-of-range offset yields an empty
    payload with a resynced offset (streams are append-only, so a
    too-large `since` only happens against a recreated file)."""
    since = max(0, int(since))
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            if since >= size:
                return b"", min(since, size)
            fh.seek(since)
            chunk = fh.read(max_bytes)
    except OSError:
        return b"", 0
    cut = chunk.rfind(b"\n") + 1
    return chunk[:cut], since + cut


class LiveMonitor:
    """Flag state over a live stream. `update()` recomputes the full
    `obs.report` flag set over everything seen so far — the SAME
    `build_report` the post-hoc CLI runs, so the current set is always
    exactly what a report over the accumulated prefix would say — and
    diffs it against the previous set, returning (new, resolved) alert
    lists. Flag identity is (flag, line, epoch, ordinal): the stream
    position pins the record in concatenated multi-run streams where
    epoch numbers repeat, and the ordinal keeps DISTINCT same-kind
    flags on one record distinct (a record with a NaN loss AND a
    nonfinite probe counter is two flags; two spiking seed lanes on
    one fleet record are two flags) — while keeping the identity
    stable across recomputes whose detail strings move with the
    baselines (a shifting run median must not churn new/resolved
    pairs)."""

    def __init__(self, **report_kw) -> None:
        self.acc = LiveRun()
        self.report_kw = report_kw
        self._current: dict = {}   # identity -> flag dict
        self.last_report: Optional[dict] = None

    def add_line(self, index: int, line: str) -> Optional[dict]:
        return self.acc.add_line(index, line)

    def flags(self) -> List[dict]:
        from factorvae_tpu_torch.obs.report import build_report

        self.last_report = build_report(self.acc.run, **self.report_kw)
        return self.last_report["flags"]

    def update(self) -> Tuple[List[dict], List[dict]]:
        now: dict = {}
        counts: dict = {}
        for f in self.flags():
            base = (f.get("flag"), f.get("line"), f.get("epoch"))
            n = counts.get(base, 0)
            counts[base] = n + 1
            now[base + (n,)] = f
        new = [f for k, f in now.items() if k not in self._current]
        resolved = [f for k, f in self._current.items() if k not in now]
        self._current = now
        return new, resolved

    def current_flags(self) -> List[dict]:
        return list(self._current.values())


def follow_run(path: str, follow: bool = True, poll_s: float = 0.2,
               idle_timeout: Optional[float] = None,
               stop: Optional[Callable[[], bool]] = None,
               on_alert: Optional[Callable[[str, dict], None]] = None,
               update_every: int = 1,
               update_interval_s: float = 0.5,
               **report_kw) -> LiveMonitor:
    """Drive a LiveMonitor over `path`: drain complete lines, recompute
    flags when `update_every` records have arrived AND at least
    `update_interval_s` passed since the last recompute (and always
    once at the end), calling `on_alert(status, flag)` with status
    "new" / "resolved" as the flag set changes. The time throttle is
    what keeps a long follow linear: each recompute replays
    `build_report` over the whole accumulated run, so per-record
    recomputation over a high-rate stream (a serving daemon's request
    spans) would grow quadratic and fall behind the writer; at most
    ~2 recomputes/second the steady-state cost stays bounded while
    the end-of-stream state — the consistency pin — is untouched.
    `update_interval_s=0` disables the throttle (tests). Returns the
    monitor (its `current_flags()` after a completed stream equals
    the post-hoc report's flags)."""
    mon = LiveMonitor(**report_kw)
    pending = 0
    last_update = float("-inf")

    def emit_update() -> None:
        new, resolved = mon.update()
        if on_alert is not None:
            for f in new:
                on_alert("new", f)
            for f in resolved:
                on_alert("resolved", f)

    for index, line in iter_lines(path, follow=follow, poll_s=poll_s,
                                  idle_timeout=idle_timeout, stop=stop):
        if mon.add_line(index, line) is None:
            continue
        pending += 1
        if pending >= max(1, update_every) \
                and time.perf_counter() - last_update >= update_interval_s:
            pending = 0
            emit_update()
            last_update = time.perf_counter()
    emit_update()
    return mon


def main(argv: Optional[list] = None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m factorvae_tpu_torch.obs.live",
        description="Streaming run monitor: obs.report's flags emitted "
                    "as alerts while the RUN.jsonl is still being "
                    "written (pillar 5, docs/observability.md)")
    ap.add_argument("run_jsonl")
    ap.add_argument("--follow", action="store_true",
                    help="keep tailing for new records (default: drain "
                         "the stream once and exit)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable alert stream (one JSON "
                         "object per alert + a final summary)")
    ap.add_argument("--poll", type=float, default=0.2,
                    help="tail poll interval, seconds")
    ap.add_argument("--idle-timeout", type=float, default=None,
                    help="stop following after this many seconds "
                         "without new bytes (default: follow forever)")
    ap.add_argument("--spike-mult", type=float, default=10.0)
    ap.add_argument("--slow-frac", type=float, default=0.5)
    ap.add_argument("--diverge-frac", type=float, default=0.2)
    ap.add_argument("--diverge-epochs", type=int, default=3)
    args = ap.parse_args(argv)

    def emit(status: str, f: dict) -> None:
        if args.json:
            print(json.dumps({"event": "alert", "status": status, **f}),
                  flush=True)
        else:
            where = (f"epoch {f['epoch']}" if f.get("epoch") is not None
                     else "program")
            tag = "ALERT" if status == "new" else "RESOLVED"
            print(f"{tag} {where}: [{f['flag']}] {f['detail']}",
                  flush=True)

    try:
        mon = follow_run(
            args.run_jsonl, follow=args.follow, poll_s=args.poll,
            idle_timeout=args.idle_timeout, on_alert=emit,
            spike_mult=args.spike_mult, slow_frac=args.slow_frac,
            diverge_frac=args.diverge_frac,
            diverge_epochs=args.diverge_epochs)
    except RunStreamError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        print("", file=sys.stderr)
        return 130
    flags = mon.current_flags()
    counts: dict = {}
    for f in flags:
        counts[f["flag"]] = counts.get(f["flag"], 0) + 1
    if args.json:
        print(json.dumps({
            "event": "summary", "records": mon.acc.records,
            "lines": mon.acc.lines, "bad_lines": mon.acc.bad,
            "flags": len(flags), "flag_counts": counts,
        }))
    else:
        if counts:
            print("current flags: " + ", ".join(
                f"{k} x{n}" for k, n in sorted(counts.items())))
        else:
            print(f"no health flags over {mon.acc.records} record(s)")
    if mon.acc.lines == 0:
        print(f"error: {args.run_jsonl} is empty — no run has written "
              "to this stream yet", file=sys.stderr)
        return 2
    if mon.acc.bad == mon.acc.lines:
        print(f"error: {args.run_jsonl} is not a JSONL metric stream "
              f"(none of its {mon.acc.lines} lines parse)",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
