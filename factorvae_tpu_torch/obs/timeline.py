"""Render a RUN.jsonl host timeline as a text Gantt + overlap report.

    python -m factorvae_tpu_torch.obs.timeline RUN.jsonl [--width 72]
        [--top 10] [--json] [--follow]

Reads the `span` / `mark` records that `utils.logging.Timeline` emits
(Trainer/FleetTrainer epochs on the "device" resource, ChunkStream
prefetch on "stream", checkpoint saves/serializes on "checkpoint",
compile-watchdog spans on "compile") and prints:

- one Gantt lane per resource (merged busy intervals over the run
  window), so the overlap structure of the pipeline — is the prefetch
  really hiding behind the epoch scan? is the async checkpoint really
  off the critical path? — is visible at a glance;
- per-resource totals: busy seconds, span count, and `overlap_frac` —
  the fraction of that resource's busy time that overlapped "device"
  busy time. This is the run-level generalization of the ChunkStream
  ledger's overlap number: ~1.0 means the work hid behind compute,
  ~0.0 means it ran in the gaps (or the gaps ran in it).

Span names deliberately match `utils.profiling.step_annotation` names
(`train_epoch_{e}`, ...), so a host span here can be located on the
device lanes of a `--profile` trace (utils/trace_summary.py) by name.

Serving-plane spans additionally carry `trace` / `span` / `parent`
fields (the fleet trace plane, obs/trace.py); this renderer ignores
them — they are additive annotations on the same `span` records, and
the per-resource Gantt here stays the resource-utilization view while
`python -m factorvae_tpu_torch.obs.trace` renders the per-request causal
tree. The per-process-section discipline below (span_sections) is the
same lesson the trace collector solves properly: records from
different processes share NO time base until clock probes align them
(obs/collect.py).

A copy of `factorvae_tpu/obs/timeline.py` (host Python over the same records,
so both readers give the same output on a stream); the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

Interval = Tuple[float, float]

DEVICE_RESOURCE = "device"

# Recovery-action marks (docs/robustness.md): shown on the
# Gantt as `!` instants and summarized in a RECOVERY line, so a healed
# run's damage is visible in the same rendering as its pipeline.
RECOVERY_MARK_NAMES = (
    "recovery_rollback",
    "recovery_rollback_unavailable",
    "ckpt_quarantine",
    "ckpt_unverified",
    "serve_quarantine",
    "circuit_open",
    "circuit_close",
    "stream_retry",
    "cold_start_retry",
    "sigterm_drain",
)


def recovery_marks(run: dict) -> List[dict]:
    """The stream's recovery-action marks, in stream order."""
    return [m for m in run.get("marks", [])
            if m.get("name") in RECOVERY_MARK_NAMES]


def load_run(path: str) -> dict:
    """Split a RUN.jsonl into {"spans", "marks", "epochs", "meta",
    "events"} record lists (unparseable lines are skipped, not fatal —
    a live-tailed file may end mid-line). Parse bookkeeping lands in
    `_stats` so `open_run` can tell an async-kill torn tail (warning)
    from a file that isn't JSONL at all (error)."""
    out: dict = {"spans": [], "marks": [], "epochs": [], "meta": [],
                 "events": []}
    lines = bad = 0
    last_bad = False
    # errors="replace": a binary (non-UTF-8) file must surface as "no
    # line parses" — the one-line not-a-JSONL error — not as a
    # UnicodeDecodeError traceback out of the iterator.
    with open(path, errors="replace") as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            lines += 1
            try:
                rec = json.loads(line)
            except ValueError:
                bad += 1
                last_bad = True
                continue
            last_bad = False
            if not isinstance(rec, dict):
                bad += 1
                continue
            # Stream position: the report needs record ORDER across the
            # split lists (e.g. which plan record precedes which run's
            # epochs in a concatenated session stream).
            rec.setdefault("_line", i)
            ev = rec.get("event")
            if ev == "span":
                out["spans"].append(rec)
            elif ev == "mark":
                out["marks"].append(rec)
            elif ev in ("epoch", "fleet_epoch"):
                out["epochs"].append(rec)
            elif ev == "run_meta":
                out["meta"].append(rec)
            else:
                out["events"].append(rec)
    out["_stats"] = {"lines": lines, "bad": bad, "last_bad": last_bad}
    return out


class RunStreamError(Exception):
    """A RUN.jsonl that cannot be rendered at all — missing, empty, or
    not JSONL. Carries the ONE-line message the CLIs print (a
    truncated stream is an error message, never a traceback)."""


def open_run(path: str) -> Tuple[dict, List[str]]:
    """`load_run` + stream sanity for the CLI entry points: returns
    (run, warnings). Raises RunStreamError on a missing/unreadable
    file, an empty stream, or a file none of whose lines parse as
    JSONL. A trailing partially-written line — the artifact of killing
    an async writer — is SKIPPED with a warning, and so are isolated
    corrupt lines in the middle; only a stream with nothing readable is
    fatal."""
    try:
        run = load_run(path)
    except OSError as e:
        raise RunStreamError(
            f"cannot read {path}: {e.strerror or e}") from e
    stats = run["_stats"]
    if stats["lines"] == 0:
        raise RunStreamError(
            f"{path} is empty — no run has written to this stream yet")
    if stats["bad"] == stats["lines"]:
        raise RunStreamError(
            f"{path} is not a JSONL metric stream "
            f"(none of its {stats['lines']} lines parse)")
    warnings = []
    if stats["last_bad"]:
        warnings.append(
            f"{path}: trailing partial line skipped (stream was cut "
            "mid-write — an async kill artifact, not corruption)")
        if stats["bad"] > 1:
            warnings.append(
                f"{path}: {stats['bad'] - 1} additional unparseable "
                "line(s) skipped")
    elif stats["bad"]:
        warnings.append(
            f"{path}: {stats['bad']} unparseable line(s) skipped")
    return run, warnings


def merge_intervals(iv: List[Interval]) -> List[Interval]:
    """Sorted union of possibly-overlapping intervals."""
    out: List[Interval] = []
    for lo, hi in sorted(iv):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def total(iv: List[Interval]) -> float:
    return sum(hi - lo for lo, hi in iv)


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """Intersection of two MERGED interval lists (linear sweep)."""
    out: List[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def resource_intervals(spans: List[dict]) -> dict:
    """resource -> merged busy intervals."""
    by_res: dict = {}
    for s in spans:
        try:
            by_res.setdefault(s.get("resource", "host"), []).append(
                (float(s["t0"]), float(s["t1"])))
        except (KeyError, TypeError, ValueError):
            continue
    return {r: merge_intervals(iv) for r, iv in by_res.items()}


def overlap_report(spans: List[dict]) -> List[dict]:
    """Per-resource busy totals + overlap_frac vs the device lane.
    overlap_frac is None for the device lane itself and when no device
    spans exist (nothing to overlap with — report honestly, don't
    default to 0 or 1)."""
    res = resource_intervals(spans)
    device = res.get(DEVICE_RESOURCE, [])
    counts: dict = {}
    for s in spans:
        counts[s.get("resource", "host")] = counts.get(
            s.get("resource", "host"), 0) + 1
    rows = []
    for r in sorted(res):
        busy = total(res[r])
        if r == DEVICE_RESOURCE or not device or busy <= 0.0:
            frac: Optional[float] = None
        else:
            frac = total(intersect(res[r], device)) / busy
        rows.append({
            "resource": r,
            "busy_seconds": round(busy, 6),
            "spans": counts.get(r, 0),
            "overlap_frac": None if frac is None else round(frac, 4),
        })
    return rows


def gantt(spans: List[dict], width: int = 72,
          marks: Optional[List[dict]] = None) -> str:
    """One text lane per resource over the run window. `marks`
    (recovery events) overlay as `!` at their instant on their
    resource's lane — a lane that only ever saw marks (e.g. `recovery`)
    still appears."""
    res = resource_intervals(spans)
    marks = [m for m in (marks or []) if isinstance(m.get("t"),
                                                    (int, float))]
    if not res and not marks:
        return "(no spans)"
    los = [iv[0][0] for iv in res.values() if iv] + [m["t"] for m in marks]
    his = [iv[-1][1] for iv in res.values() if iv] + [m["t"] for m in marks]
    lo, hi = min(los), max(his)
    window = max(hi - lo, 1e-9)
    lanes = sorted(set(res) | {m.get("resource", "host") for m in marks})
    name_w = max(len(r) for r in lanes)
    lines = [f"{'':<{name_w}}  |{'run window':-^{width}}| "
             f"{lo:.3f}s .. {hi:.3f}s"]
    for r in lanes:
        cells = [" "] * width
        for a, b in res.get(r, []):
            c0 = int((a - lo) / window * width)
            c1 = max(c0 + 1, int((b - lo) / window * width + 0.5))
            for c in range(c0, min(c1, width)):
                cells[c] = "#"
        for m in marks:
            if m.get("resource", "host") != r:
                continue
            c = min(int((m["t"] - lo) / window * width), width - 1)
            cells[c] = "!"
        lines.append(f"{r:<{name_w}}  |{''.join(cells)}|")
    return "\n".join(lines)


def span_sections(run: dict) -> List[List[dict]]:
    """Partition a stream's spans into per-process sections at
    `run_meta` boundaries (every file-backed MetricsLogger attach
    writes one). Each process's Timeline origin restarts near zero, so
    spans from different sections of a concatenated session stream
    share NO time base: merging them would overlay separate runs into
    one window and fabricate overlap between work that never ran
    concurrently. Streams without positional info (hand-built lists)
    or with a single header stay one section."""
    bounds = sorted(m["_line"] for m in run.get("meta", [])
                    if m.get("_line") is not None)
    spans = run["spans"]
    if len(bounds) <= 1 or any(s.get("_line") is None for s in spans):
        return [spans] if spans else []
    sections: List[List[dict]] = [[] for _ in bounds]
    for s in spans:
        # the section whose header precedes this span
        i = sum(1 for b in bounds if b < s["_line"]) - 1
        sections[max(i, 0)].append(s)
    return [sec for sec in sections if sec]


def _marks_for_section(run: dict, spans: List[dict],
                       rmarks: List[dict]) -> List[dict]:
    """The recovery marks sharing a span section's time base: those
    between the same pair of `run_meta` headers (each process/section
    has its own perf_counter origin — a mark from another section
    overlaid here would land at a fabricated spot). Single-section
    streams and positionless records keep everything."""
    if not spans or not rmarks:
        return []
    bounds = sorted(m["_line"] for m in run.get("meta", [])
                    if m.get("_line") is not None)
    if len(bounds) <= 1 or any(s.get("_line") is None for s in spans):
        return rmarks
    # the section is owned by the last header preceding its spans
    first = min(s["_line"] for s in spans)
    i = max(sum(1 for b in bounds if b < first) - 1, 0)
    lo = bounds[i]
    hi = bounds[i + 1] if i + 1 < len(bounds) else float("inf")
    return [m for m in rmarks
            if m.get("_line") is None or lo <= m["_line"] < hi]


def format_report(run: dict, width: int = 72, top: int = 10) -> str:
    sections = span_sections(run)
    rmarks = recovery_marks(run)
    lines: List[str] = []
    for i, spans in enumerate(sections):
        if len(sections) > 1:
            lines.append(f"=== run section {i + 1}/{len(sections)} "
                         "(separate process: own time base) ===")
        lines.append(gantt(spans, width=width,
                           marks=_marks_for_section(run, spans, rmarks)))
        lines.append("")
        rows = overlap_report(spans)
        if rows:
            w = max(len("resource"), max(len(r["resource"]) for r in rows))
            lines.append(f"{'resource':<{w}} {'busy':>10} {'spans':>6}  "
                         "overlap_frac")
            for r in rows:
                frac = ("-" if r["overlap_frac"] is None
                        else f"{r['overlap_frac']:.1%}")
                lines.append(
                    f"{r['resource']:<{w}} {r['busy_seconds']:>9.3f}s "
                    f"{r['spans']:>6}  {frac}")
        if top > 0 and spans:
            longest = sorted(spans,
                             key=lambda s: -float(s.get("dur", 0.0)))[:top]
            lines.append("")
            lines.append(f"longest spans (top {len(longest)}):")
            for s in longest:
                lines.append(
                    f"  {s.get('dur', 0.0):>9.3f}s  [{s.get('resource')}] "
                    f"{s.get('name')}")
        if len(sections) > 1:
            lines.append("")
    compiles = compile_summary(run)
    if compiles["records"]:
        lines.append(
            f"compiled programs: {len(compiles['by_fn'])} jits, "
            f"{compiles['records']} compiles, "
            f"{compiles['total_wall_s']:.2f}s total compile wall"
            + (f", peak program HBM estimate "
               f"{compiles['max_peak_bytes'] / 1e6:.1f} MB"
               if compiles.get("max_peak_bytes") else ""))
    storms = [m for m in run["marks"] if m.get("name") == "retrace_storm"]
    if storms:
        worst = max(storms, key=lambda m: m.get("compiles", 0))
        cost = compiles["by_fn"].get(worst.get("fn"), {}).get("wall_s")
        lines.append(
            f"RETRACE STORM: '{worst.get('fn')}' compiled "
            f"{worst.get('compiles')} times over {worst.get('calls')} calls"
            # the cost dimension: what the storm actually
            # burned, from the per-miss compile records
            + (f" — {cost:.2f}s of compile wall" if cost else ""))
    if rmarks:
        by: dict = {}
        for m in rmarks:
            by[m["name"]] = by.get(m["name"], 0) + 1
        lines.append(
            "RECOVERY: "
            + ", ".join(f"{k} x{n}" for k, n in sorted(by.items()))
            + " (`!` marks on the Gantt; detail: obs.report)")
    return "\n".join(lines)


def compile_summary(run: dict) -> dict:
    """Aggregate the stream's `compile` records (obs/watchdog.py emits
    one per detected cache miss): total/per-fn wall seconds, compile
    counts, and the largest cost/memory figures the guarded capture
    yielded (nulls where the jax version lacks the APIs)."""
    recs = [r for r in run["events"] if r.get("event") == "compile"]
    by_fn: dict = {}
    for r in recs:
        fn = str(r.get("fn"))
        e = by_fn.setdefault(fn, {"compiles": 0, "wall_s": 0.0,
                                  "flops": None, "peak_bytes": None})
        e["compiles"] += 1
        e["wall_s"] = round(e["wall_s"] + float(r.get("wall_s") or 0.0), 6)
        for k in ("flops", "peak_bytes"):
            v = r.get(k)
            if v is not None:
                e[k] = max(e[k] or 0, v)
    peaks = [e["peak_bytes"] for e in by_fn.values()
             if e["peak_bytes"] is not None]
    return {
        "records": len(recs),
        "total_wall_s": round(sum(float(r.get("wall_s") or 0.0)
                                  for r in recs), 6),
        "max_peak_bytes": max(peaks) if peaks else None,
        "by_fn": by_fn,
    }


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m factorvae_tpu_torch.obs.timeline",
        description="Text Gantt + per-resource overlap for a RUN.jsonl "
                    "span stream")
    ap.add_argument("run_jsonl")
    ap.add_argument("--width", type=int, default=72)
    ap.add_argument("--top", type=int, default=10,
                    help="longest spans listed (0 disables)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable overlap report instead of text")
    ap.add_argument("--follow", action="store_true",
                    help="tail an in-flight stream instead: delegates "
                         "to the live follower (obs/live.py), emitting "
                         "health/compile/recovery flags as alerts while "
                         "the run writes (Gantt rendering needs the "
                         "finished stream — rerun without --follow)")
    ap.add_argument("--idle-timeout", type=float, default=None,
                    help="with --follow: stop after this many seconds "
                         "without new bytes (default: follow forever)")
    args = ap.parse_args(argv)
    import sys

    if args.follow:
        from factorvae_tpu_torch.obs import live

        follow_args = [args.run_jsonl, "--follow"]
        if args.json:
            follow_args.append("--json")
        if args.idle_timeout is not None:
            follow_args += ["--idle-timeout", str(args.idle_timeout)]
        return live.main(follow_args)

    try:
        run, warnings = open_run(args.run_jsonl)
    except RunStreamError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for w in warnings:
        print(f"warning: {w}", file=sys.stderr)
    if args.json:
        print(json.dumps({
            # per-section: spans across run_meta boundaries carry
            # separate per-process time bases (see span_sections)
            "sections": [overlap_report(sec)
                         for sec in span_sections(run)],
            "num_spans": len(run["spans"]),
            "compiles": compile_summary(run),
            "retrace_storms": [m for m in run["marks"]
                               if m.get("name") == "retrace_storm"],
            "recovery_marks": recovery_marks(run),
        }, indent=2))
    else:
        print(format_report(run, width=args.width, top=args.top))
    return 0 if run["spans"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
