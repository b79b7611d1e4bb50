"""The trace plane (`factorvae_tpu/obs/trace.py`): deterministic request
identity across the serving path, and per-trace span trees.

A trace context is a dict `{"trace_id", "span_id"}` (plus `"parent"` while
it is built). Ids are deterministic (a daemon's counter gives `d-000007`),
and child span ids are hierarchical: `child(ctx, label)` appends `.label`.
On the wire the pair rides one HTTP header, `X-Factorvae-Trace:
<trace_id>;<span_id>`, or a JSONL request's `"trace"` field. Spans are the
timeline's own records (`utils/logging.py`) with `trace` / `span` /
`parent` fields; a fused span that serves several requests (`serve_tick`)
carries `traces` and `members` lists instead, and the tree renderer grafts
it into each member trace.

    python -m factorvae_tpu_torch.obs.trace RUN.jsonl [--trace ID] [--slowest N] [--stages]

renders the trees, ranks the slowest traces and breaks the wall down per
stage. `sample_keep` is a hash-of-trace-id filter (sha256, no RNG) that
always keeps SLO breachers.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from typing import Any, Dict, Iterable, List, Optional, Tuple

TRACE_HEADER = "X-Factorvae-Trace"

# Span names emitted along the serving path, in causal order; the stage
# breakdown reports wall per stage under these keys.
STAGES = ("router_ingress", "router_forward", "serve_queue", "serve_tick",
          "serve_dispatch", "serve_request")


# ---------------------------------------------------------------------------
# Context construction / propagation
# ---------------------------------------------------------------------------


def root_ctx(trace_id: str, span_id: str = "in") -> dict:
    """A fresh root context. `trace_id` must come from a deterministic
    per-process counter (router request counter, wf cycle id) — never
    from RNG or wall clock."""
    return {"trace_id": str(trace_id), "span_id": str(span_id)}


def child(ctx: dict, label: str) -> dict:
    """Child context: hierarchical span id, parent = the given ctx."""
    sid = f"{ctx['span_id']}.{label}"
    return {"trace_id": ctx["trace_id"], "span_id": sid,
            "parent": ctx["span_id"]}


def span_fields(ctx: Optional[dict], **extra: Any) -> dict:
    """Timeline `**fields` for a span carrying this context. Returns
    `extra` unchanged on a None/invalid ctx so call sites stay
    unconditional."""
    if not isinstance(ctx, dict) or "trace_id" not in ctx:
        return extra
    fields = {"trace": ctx["trace_id"], "span": ctx["span_id"]}
    parent = ctx.get("parent")
    if parent:
        fields["parent"] = parent
    fields.update(extra)
    return fields


def format_header(ctx: dict) -> str:
    return f"{ctx['trace_id']};{ctx['span_id']}"


def parse_header(value: Optional[str]) -> Optional[dict]:
    """Parse `X-Factorvae-Trace`; None on absent/malformed (a bad
    header must never fail the request it rides on)."""
    if not value or ";" not in value:
        return None
    tid, _, sid = value.partition(";")
    tid, sid = tid.strip(), sid.strip()
    if not tid or not sid:
        return None
    return {"trace_id": tid, "span_id": sid}


def wire_ctx(req: Any) -> Optional[dict]:
    """The `"trace"` field of a JSONL request dict, validated."""
    if not isinstance(req, dict):
        return None
    t = req.get("trace")
    if (isinstance(t, dict) and isinstance(t.get("trace_id"), str)
            and isinstance(t.get("span_id"), str)):
        return {"trace_id": t["trace_id"], "span_id": t["span_id"]}
    return None


def sample_keep(trace_id: str, rate: float, breach: bool = False) -> bool:
    """Deterministic tail-biased sampling: SLO breachers are always
    kept; otherwise keep iff sha256(trace_id) falls under `rate`.
    rate>=1 keeps everything, rate<=0 keeps only breachers."""
    if breach:
        return True
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = int.from_bytes(hashlib.sha256(trace_id.encode()).digest()[:8], "big")
    return (h / float(1 << 64)) < rate


# ---------------------------------------------------------------------------
# Assembly: records -> per-trace span trees
# ---------------------------------------------------------------------------


def assemble_traces(records: Iterable[dict]) -> Dict[str, dict]:
    """Group span records by trace id.

    Returns {trace_id: {"spans": [rec...], "shared": [rec...]}} where
    `spans` carry an explicit `trace` field and `shared` are fused
    spans (a `traces` list) serving several traces at once. Records are
    kept verbatim — the collector has already mapped times onto one
    base when streams were merged.
    """
    traces: Dict[str, dict] = {}

    def bucket(tid: str) -> dict:
        return traces.setdefault(tid, {"spans": [], "shared": []})

    for rec in records:
        if rec.get("event") != "span":
            continue
        tid = rec.get("trace")
        if isinstance(tid, str):
            bucket(tid)["spans"].append(rec)
        for t in rec.get("traces") or ():
            if isinstance(t, str):
                bucket(t)["shared"].append(rec)
    return traces


def _tree_index(trace: dict) -> Tuple[Dict[str, List[dict]], List[dict]]:
    """(parent span_id -> children, roots). Shared spans are grafted
    under their first member span id that belongs to this trace; spans
    whose parent never arrived (partial collection) surface as extra
    roots rather than vanishing."""
    by_id: Dict[str, dict] = {}
    for rec in trace["spans"] + trace["shared"]:
        sid = rec.get("span")
        if isinstance(sid, str):
            # Last write wins; duplicate ids only happen on re-collected
            # overlapping streams where the records are identical.
            by_id[sid] = rec
    members = set(by_id)
    roots: List[dict] = []
    children: Dict[str, List[dict]] = {}
    for rec in trace["spans"]:
        parent = rec.get("parent")
        if isinstance(parent, str) and parent in by_id:
            children.setdefault(parent, []).append(rec)
        else:
            roots.append(rec)
    for rec in trace["shared"]:
        parent = rec.get("parent")
        anchor = None
        if isinstance(parent, str) and parent in by_id:
            anchor = parent
        else:
            for m in rec.get("members") or ():
                if m in members:
                    anchor = m
                    break
        if anchor is not None:
            children.setdefault(anchor, []).append(rec)
        else:
            roots.append(rec)
    for recs in children.values():
        recs.sort(key=lambda r: r.get("t0", 0.0))
    roots.sort(key=lambda r: r.get("t0", 0.0))
    return children, roots


def render_tree(tid: str, trace: dict, width: int = 100) -> str:
    """Text tree + proportional bars for one trace."""
    children, roots = _tree_index(trace)
    spans = trace["spans"] + trace["shared"]
    if not spans:
        return f"trace {tid}: no spans"
    t_lo = min(r.get("t0", 0.0) for r in spans)
    t_hi = max(r.get("t1", 0.0) for r in spans)
    total = max(t_hi - t_lo, 1e-9)
    bar_w = max(20, width - 64)
    lines = [f"trace {tid}  wall {total * 1e3:.2f} ms  spans {len(spans)}"]
    seen = set()

    def emit(rec: dict, depth: int) -> None:
        key = (rec.get("span"), rec.get("name"), rec.get("t0"))
        if key in seen:       # shared spans graft once per anchor; render once
            return
        seen.add(key)
        t0, t1 = rec.get("t0", t_lo), rec.get("t1", t_lo)
        lo = int((t0 - t_lo) / total * bar_w)
        hi = max(lo + 1, int((t1 - t_lo) / total * bar_w))
        bar = " " * lo + "=" * (hi - lo)
        annot = ""
        for k in ("worker", "outcome", "leg", "requests", "models", "cycle"):
            if k in rec:
                annot += f" {k}={rec[k]}"
        label = f"{'  ' * depth}{rec.get('name', '?')}"
        lines.append(
            f"{label:<36} {(t1 - t0) * 1e3:9.3f} ms |{bar:<{bar_w}}|{annot}")
        sid = rec.get("span")
        if isinstance(sid, str):
            for c in children.get(sid, ()):
                emit(c, depth + 1)

    for root in roots:
        emit(root, 0)
    return "\n".join(lines)


def trace_wall(trace: dict) -> float:
    spans = trace["spans"] + trace["shared"]
    if not spans:
        return 0.0
    return (max(r.get("t1", 0.0) for r in spans)
            - min(r.get("t0", 0.0) for r in spans))


def trace_breached(trace: dict, slo_s: Optional[float]) -> bool:
    return slo_s is not None and trace_wall(trace) > slo_s


def stage_breakdown(traces: Dict[str, dict]) -> Dict[str, dict]:
    """Per-stage wall percentiles across traces: {stage: {n, p50_ms,
    p99_ms}}. A trace contributes the SUM of its spans per stage (a
    hedged trace has two forward legs; both waits were real)."""
    per_stage: Dict[str, List[float]] = {s: [] for s in STAGES}
    for trace in traces.values():
        sums: Dict[str, float] = {}
        for rec in trace["spans"] + trace["shared"]:
            name = rec.get("name")
            if name in per_stage:
                sums[name] = sums.get(name, 0.0) + float(rec.get("dur", 0.0))
        for name, s in sums.items():
            per_stage[name].append(s)
    out: Dict[str, dict] = {}
    for name, walls in per_stage.items():
        if not walls:
            continue
        walls.sort()
        out[name] = {
            "n": len(walls),
            "p50_ms": round(_pctl(walls, 0.50) * 1e3, 3),
            "p99_ms": round(_pctl(walls, 0.99) * 1e3, 3),
        }
    return out


def _pctl(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def load_records(paths: Iterable[str]) -> List[dict]:
    """All JSON records from the given JSONL files, torn lines skipped
    (the tail of a live stream may hold a partial write)."""
    records: List[dict] = []
    for path in paths:
        with open(path, "r", errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
    return records


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m factorvae_tpu_torch.obs.trace",
        description="Render per-trace span trees from (merged) RUN.jsonl "
                    "streams.")
    p.add_argument("paths", nargs="+", help="RUN.jsonl stream(s); pass the "
                   "obs.collect merged stream for cross-process trees")
    p.add_argument("--trace", default=None, help="render this trace id only")
    p.add_argument("--slowest", type=int, default=0, metavar="N",
                   help="render the N slowest traces (tail exemplars)")
    p.add_argument("--trace_sample", type=float, default=1.0, metavar="RATE",
                   help="deterministic keep-rate by trace-id hash; "
                   "SLO breachers (--slo_ms) always kept")
    p.add_argument("--slo_ms", type=float, default=None,
                   help="SLO for breach marking/sampling bias")
    p.add_argument("--stages", action="store_true",
                   help="print the per-stage p50/p99 breakdown")
    args = p.parse_args(argv)

    traces = assemble_traces(load_records(args.paths))
    slo_s = args.slo_ms / 1e3 if args.slo_ms is not None else None
    kept = {tid: tr for tid, tr in traces.items()
            if sample_keep(tid, args.trace_sample,
                           breach=trace_breached(tr, slo_s))}
    if not kept:
        print("no traces found", file=sys.stderr)
        return 1
    if args.trace is not None:
        tr = kept.get(args.trace)
        if tr is None:
            print(f"trace {args.trace!r} not found "
                  f"({len(kept)} traces present)", file=sys.stderr)
            return 1
        print(render_tree(args.trace, tr))
        return 0
    ranked = sorted(kept.items(), key=lambda kv: -trace_wall(kv[1]))
    shown = ranked[:args.slowest] if args.slowest else ranked
    for tid, tr in shown:
        mark = " SLO-BREACH" if trace_breached(tr, slo_s) else ""
        print(f"{tid:<24} wall {trace_wall(tr) * 1e3:9.2f} ms  "
              f"spans {len(tr['spans']) + len(tr['shared']):3d}{mark}")
    if args.slowest:
        for tid, tr in shown:
            print()
            print(render_tree(tid, tr))
    if args.stages:
        print()
        for name, row in stage_breakdown(kept).items():
            print(f"{name:<16} n={row['n']:<5d} p50={row['p50_ms']:9.3f} ms  "
                  f"p99={row['p99_ms']:9.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
