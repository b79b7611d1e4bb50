"""Run report: per-epoch health tables + flags from a RUN.jsonl.

    python -m factorvae_tpu_torch.obs.report RUN.jsonl [--json] [--follow]
        [--spike-mult 10] [--slow-frac 0.5] [--diverge-frac 0.2]
        [--diverge-epochs 3]

`--follow` tails an IN-FLIGHT stream instead (delegating to
`obs/live.py`, pillar 5): the same flags, emitted as alerts while the
run is still writing, pinned identical to this report run post-hoc.

Aggregates the metric stream (epoch / fleet_epoch records, the health
probes when `obs` was on, the `plan` decision block, the compiled-
program `compile` records, scores/best events) into one table and
raises health flags:

- `nonfinite`     — NaN/inf train or val loss, non-finite gradient
                    elements, or non-finite per-day losses (the probe
                    counters). This is the flag that would have caught
                    a donation bug (NaN epoch-3 losses after
                    resume) in the first epoch record instead of a
                    root-cause hunt.
- `grad_spike`    — grad_norm_max > spike-mult x the run's median
                    grad_norm_mean (needs `obs` probes).
- `val_divergence`— val loss sitting >= diverge-frac above its best for
                    diverge-epochs consecutive epochs while training
                    continues (classic overfit/collapse signature).
- `slow_epoch`    — days_per_sec below slow-frac x the run median, and
                    (when the planner's measured envelope is in the
                    stream) below slow-frac x the plan row's measured
                    rate — a throughput regression against the envelope
                    the planner promised.
- `loss_scale_collapse`
                  — the mixed-precision dynamic loss scale spent steps
                    pinned at its floor this epoch
                    (`loss_scale_floor_steps` probe; per seed lane on
                    fleets). A bf16 lane overflowing faster than the
                    backoff can absorb is silently skipping its updates
                    wholesale — the lane has numerically collapsed even
                    though every loss it reports is finite.
- `compile_storm` — a retrace storm, now with its COST dimension: the
                    per-miss `compile` records say what the storm burned
                    in compile wall seconds.
- `hbm_over_budget` / `compile_over_budget`
                  — a `compile` record whose program peak-HBM estimate
                    or compile wall exceeds the governing plan row's
                    optional `budgets` envelope (plan.py
                    budget_peak_hbm_bytes / budget_compile_s; rows
                    without the block promise nothing and flag nothing).

Recovery events (docs/robustness.md) render as first-class
flags too — a run that HEALED is not a clean run, and the report is
where the healing becomes visible:

- `skip_step`      — the in-graph finite guard skipped updates this
                     epoch (`skipped_steps` metric; per seed lane on
                     fleets).
- `rollback`       — host-side escalation restored a checkpoint
                     (`recovery` events: serial rollback + lr backoff,
                     or a fleet lane rolling back alone; the
                     *_unavailable kinds mean it wanted to and could
                     not).
- `quarantine`     — a checkpoint step or serve weights directory
                     failed sha256 manifest verification and was fenced
                     (`ckpt_quarantine` / `serve_quarantine` marks).
- `circuit_open`   — a served model's breaker opened after K
                     consecutive failures (`circuit_open` marks).
- `retry`          — a bounded-backoff retry fired (`stream_retry` /
                     `cold_start_retry` marks): the fault healed below
                     the epoch/request level.

Served-score drift renders as `score_drift`: the scoring
daemon's drift monitor (obs/drift.py) saw a model's day-over-day
served rank correlation collapse below its threshold — the signal
degraded while every request kept answering 200.

Human output by default; `--json` for the machine-readable form. An
empty, missing, or non-JSONL stream exits with a one-line error; a
trailing torn line (async-kill artifact) is a warning, never fatal.

A copy of `factorvae_tpu/obs/report.py` (host Python over the same records,
so both readers give the same output on a stream); the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import re
from statistics import median
from typing import List, Optional

from factorvae_tpu_torch.obs.probes import TRAIN_PROBE_KEYS
from factorvae_tpu_torch.obs.timeline import (
    RunStreamError,
    compile_summary,
    load_run,
    open_run,
)

# load_run/open_run are re-exported CLI plumbing here; keeping the names
# referenced preserves the public import path tests rely on.
__all__ = ["build_report", "drift_flags", "format_report",
           "health_flags", "load_run", "main", "open_run",
           "plan_measured_days_per_sec", "program_flags",
           "recovery_flags"]

# timeline marks that announce a recovery action -> report flag name
RECOVERY_MARK_FLAGS = {
    "ckpt_quarantine": "quarantine",
    "serve_quarantine": "quarantine",
    "circuit_open": "circuit_open",
    "stream_retry": "retry",
    "cold_start_retry": "retry",
}

# serve-side drift marks (obs/drift.py) -> report flag name. Distinct
# from recovery: the daemon took no action — the SIGNAL degraded, and
# the report is where that becomes a first-class flag.
DRIFT_MARK_FLAGS = {
    "score_drift": "score_drift",
}

# autotune_plan rows carry "train 0.1234 s/day" in their source string;
# a matched value is the measured envelope the planner promised.
_PLAN_RATE_RE = re.compile(r"train ([0-9.eE+-]+) s/day")


def _nums(v) -> List[float]:
    """Numeric leaves of an epoch-record value (fleet records hold
    per-seed lists; serial records hold scalars)."""
    if isinstance(v, (int, float)):
        return [float(v)]
    if isinstance(v, list):
        return [float(x) for x in v if isinstance(x, (int, float))]
    return []


def _any_nonfinite(v) -> bool:
    return any(not math.isfinite(x) for x in _nums(v))


def _mean(v) -> Optional[float]:
    xs = [x for x in _nums(v) if math.isfinite(x)]
    return sum(xs) / len(xs) if xs else None


def _parse_plan_rate(rec: dict) -> Optional[float]:
    """Measured train rate promised by ONE `plan` record, or None —
    default-provenance plans promise no envelope."""
    if rec.get("provenance") != "measured":
        return None
    m = _PLAN_RATE_RE.search(str(rec.get("source", "")))
    if not m:
        return None
    try:
        s_per_day = float(m.group(1))
        return 1.0 / s_per_day if s_per_day > 0 else None
    except ValueError:
        return None


def plan_measured_days_per_sec(events: List[dict]) -> Optional[float]:
    """Envelope of the stream's FIRST plan record (single-run streams)."""
    for rec in events:
        if rec.get("event") == "plan":
            return _parse_plan_rate(rec)
    return None


def _plan_rate_for(seg: List[dict], events: List[dict]) -> Optional[float]:
    """The plan envelope governing THIS segment: the last `plan` record
    the stream logged before the segment's first epoch (record order via
    the `_line` annotation obs.timeline.load_run attaches). A plan from
    a different run in a concatenated session must not set the envelope
    here — and a run whose own plan was default-provenance gets none.
    Hand-built record lists without `_line` fall back to the stream's
    first plan record."""
    plans = [r for r in events if r.get("event") == "plan"]
    if not plans:
        return None
    first = seg[0].get("_line") if seg else None
    if first is not None and all(p.get("_line") is not None for p in plans):
        prior = [p for p in plans if p["_line"] < first]
        if not prior:
            return None
        return _parse_plan_rate(prior[-1])
    return _parse_plan_rate(plans[0])


def _segments(epochs: List[dict]) -> List[List[dict]]:
    """Split a (possibly concatenated) stream's epoch records into
    per-run segments. One RUN.jsonl deliberately carries many runs —
    autotune + train + sweep sessions, parity grid points, fleet groups
    — and the stateful health checks (divergence baselines, throughput
    medians, the compile-epoch exemption) must not leak across run
    boundaries. A new segment starts wherever the epoch number fails to
    increase: a fresh run restarts at 0 (or any earlier epoch), while a
    resume continues its predecessor's numbering and correctly extends
    the segment."""
    segs: List[List[dict]] = []
    cur: List[dict] = []
    last: Optional[float] = None
    for rec in epochs:
        e = rec.get("epoch")
        if cur and isinstance(e, (int, float)) \
                and isinstance(last, (int, float)) and e <= last:
            segs.append(cur)
            cur = []
        cur.append(rec)
        if isinstance(e, (int, float)):
            last = e
    if cur:
        segs.append(cur)
    return segs


def _lane_count(seg: List[dict], key: str) -> int:
    """Seed-lane width of a metric over a segment: fleets log per-seed
    LISTS, serial runs scalars (width 1). Health checks run per lane so
    one bad seed is never diluted by the healthy majority ("flags fire
    if ANY seed trips")."""
    return max((len(_nums(r.get(key))) for r in seg), default=0)


def _lane(rec: dict, key: str, s: int) -> Optional[float]:
    lanes = _nums(rec.get(key))
    return lanes[s] if s < len(lanes) else None


def _lane_name(recs, s: int) -> Optional[str]:
    """The lane-CONFIG label for seed lane `s`, from the newest record
    carrying `lane_labels` (fleet epoch records: the
    hyper fleet races DIFFERENT configs per lane, so an alert must name
    the config that diverged — lr/kl_weight/config hash — not just the
    lane index). None on streams without them."""
    if isinstance(recs, dict):
        recs = [recs]
    for rec in reversed(list(recs)):
        labels = rec.get("lane_labels")
        if isinstance(labels, list) and s < len(labels) \
                and isinstance(labels[s], str):
            return labels[s]
    return None


def _seed_tag(recs, s: int, width: int) -> str:
    """' (seed lane N)' / ' (seed lane N: <config label>)' / '' — ONE
    formatter for every per-lane flag detail, so obs.report, obs.live
    and the skip_step recovery flags name lanes identically."""
    if width <= 1:
        return ""
    name = _lane_name(recs, s)
    return (f" (seed lane {s}: {name})" if name
            else f" (seed lane {s})")


def health_flags(epochs: List[dict], events: List[dict],
                 spike_mult: float = 10.0, slow_frac: float = 0.5,
                 diverge_frac: float = 0.2,
                 diverge_epochs: int = 3) -> List[dict]:
    flags: List[dict] = []

    def flag(rec, kind, detail):
        # `line` (the load_run stream position) identifies the exact
        # record: in a concatenated multi-run stream, epoch NUMBERS
        # repeat across runs and must not be the join key.
        flags.append({"epoch": rec.get("epoch"), "line": rec.get("_line"),
                      "flag": kind, "detail": detail})

    def seed_tag(rec, s: int, width: int) -> str:
        return _seed_tag(rec, s, width)

    # Every stateful check runs PER SEGMENT (per run): baselines,
    # medians, exemptions and the plan envelope from one grid point or
    # fleet group must not flag — or excuse — the next one.
    for seg in _segments(epochs):
        # nonfinite: losses + probe counters. A run with NO validation
        # split records NaN val_loss every epoch BY DESIGN — the
        # exemption is judged over THIS run only, so a sibling run's
        # finite val split can't un-excuse it.
        no_val = all(_any_nonfinite(r.get("val_loss", 0.0)) for r in seg)
        for rec in seg:
            for key in ("train_loss", "val_loss"):
                if key in rec and _any_nonfinite(rec[key]):
                    if key == "val_loss" and no_val:
                        continue
                    flag(rec, "nonfinite",
                         f"{key} is not finite: {rec[key]}")
            for key in ("nonfinite_grads", "nonfinite_loss",
                        "val_nonfinite_loss"):
                n = _mean(rec.get(key, 0.0))
                if n and n > 0:
                    flag(rec, "nonfinite", f"{key}={n:g} (probe counter)")

        # loss-scale collapse (mixed precision): the dynamic
        # loss scale spent steps pinned at its configured floor this
        # epoch. Every one of those steps overflowed AND could not back
        # off further — the lane is shedding updates wholesale while
        # its reported losses stay finite, so nothing else flags it.
        s_ls = _lane_count(seg, "loss_scale_floor_steps")
        for rec in seg:
            for s in range(s_ls):
                n = _lane(rec, "loss_scale_floor_steps", s)
                if n is None or n <= 0:
                    continue
                scale = _lane(rec, "loss_scale", s)
                at = (f", scale={scale:g}" if scale is not None
                      and math.isfinite(scale) else "")
                flag(rec, "loss_scale_collapse",
                     f"loss scale pinned at its floor for {n:g} "
                     f"overflowed step(s){at}"
                     + seed_tag(rec, s, s_ls))

        # grad spikes (probe data required), per seed lane: each seed
        # is judged against ITS OWN epoch-median grad_norm_mean
        s_grad = _lane_count(seg, "grad_norm_mean")
        for s in range(s_grad):
            means = [m for r in seg
                     for m in [_lane(r, "grad_norm_mean", s)]
                     if m is not None and math.isfinite(m)]
            if not means:
                continue
            base = median(means)
            for rec in seg:
                gmax = _lane(rec, "grad_norm_max", s)
                if gmax is not None and base > 0 \
                        and gmax > spike_mult * base:
                    flag(rec, "grad_spike",
                         f"grad_norm_max={gmax:.4g} > {spike_mult:g}x "
                         f"median grad_norm_mean ({base:.4g})"
                         + seed_tag(rec, s, s_grad))

        # val divergence, per seed lane: >= diverge_epochs consecutive
        # epochs sitting diverge_frac above that seed's best in this run
        s_val = _lane_count(seg, "val_loss")
        for s in range(s_val):
            best = math.inf
            streak: List[dict] = []
            for rec in seg:
                v = _lane(rec, "val_loss", s)
                if v is None or not math.isfinite(v):
                    continue
                if math.isfinite(best) and v > best * (1.0 + diverge_frac):
                    streak.append(rec)
                    if len(streak) == diverge_epochs:
                        flag(streak[0], "val_divergence",
                             f"val loss >= {1 + diverge_frac:g}x its "
                             f"best ({best:.6g}) for {diverge_epochs} "
                             "consecutive epochs (through epoch "
                             f"{rec.get('epoch')})"
                             + seed_tag(streak[0], s, s_val))
                else:
                    streak = []
                best = min(best, v)

        # throughput: vs this run's median, and vs THIS run's plan
        # envelope (the last plan record logged before this segment).
        # Each run's FIRST epoch record pays jit compilation and is
        # exempt — flagging every cold start would train readers to
        # ignore the flag.
        plan_rate = _plan_rate_for(seg, events)
        timed = seg[1:] if len(seg) > 1 else seg
        rates = [r for rec in timed
                 for r in [_mean(rec.get("days_per_sec",
                                         rec.get("seed_days_per_sec")))]
                 if r is not None and r > 0]
        if rates:
            run_median = median(rates)
            for rec in timed:
                r = _mean(rec.get("days_per_sec",
                                  rec.get("seed_days_per_sec")))
                if r is None or r <= 0:
                    continue
                if r < slow_frac * run_median:
                    flag(rec, "slow_epoch",
                         f"{r:.3g} days/s < {slow_frac:g}x run median "
                         f"({run_median:.3g})")
                elif plan_rate is not None and r < slow_frac * plan_rate:
                    flag(rec, "slow_epoch",
                         f"{r:.3g} days/s < {slow_frac:g}x the plan "
                         f"row's measured {plan_rate:.3g} days/s")
    return flags


def _budgets_for(rec: dict, events: List[dict]) -> dict:
    """The observability budgets governing one `compile` record: the
    last `plan` record the stream logged before it (same record-order
    rule as `_plan_rate_for`). {} when no plan with budgets precedes it
    — budgets are opt-in, and a plan from a LATER run must not judge an
    earlier program."""
    plans = [r for r in events if r.get("event") == "plan"]
    line = rec.get("_line")
    if line is not None and all(p.get("_line") is not None for p in plans):
        plans = [p for p in plans if p["_line"] < line]
    if not plans:
        return {}
    p = plans[-1]
    return {
        "compile_s": float(p.get("budget_compile_s") or 0.0),
        "peak_hbm_bytes": int(p.get("budget_peak_hbm_bytes") or 0),
    }


def program_flags(run: dict) -> List[dict]:
    """Compiled-program flags, judged per RECORD rather than
    per epoch: retrace storms with their measured compile-wall cost,
    and compile records past the governing plan row's budgets."""
    flags: List[dict] = []
    events = run.get("events", [])
    compiles = [r for r in events if r.get("event") == "compile"]

    # compile_storm: one flag per stormed jit, worst mark wins; the
    # cost dimension comes from that jit's compile records.
    storms: dict = {}
    for m in run.get("marks", []):
        if m.get("name") != "retrace_storm":
            continue
        fn = m.get("fn")
        prev = storms.get(fn)
        if prev is None or (m.get("compiles") or 0) > (prev.get("compiles")
                                                       or 0):
            storms[fn] = m
    for fn, m in storms.items():
        cost = sum(float(c.get("wall_s") or 0.0)
                   for c in compiles if c.get("fn") == fn)
        flags.append({
            "epoch": None, "line": m.get("_line"), "flag": "compile_storm",
            "detail": f"'{fn}' compiled {m.get('compiles')}x over "
                      f"{m.get('calls')} calls"
                      + (f" — {cost:.2f}s of compile wall burned"
                         if cost else ""),
        })

    for c in compiles:
        budgets = _budgets_for(c, events)
        peak_budget = budgets.get("peak_hbm_bytes") or 0
        peak = c.get("peak_bytes")
        if peak_budget > 0 and peak is not None and peak > peak_budget:
            flags.append({
                "epoch": None, "line": c.get("_line"),
                "flag": "hbm_over_budget",
                "detail": f"'{c.get('fn')}' program peak HBM estimate "
                          f"{peak / 1e6:.1f} MB > budget "
                          f"{peak_budget / 1e6:.1f} MB (plan row)",
            })
        s_budget = budgets.get("compile_s") or 0.0
        wall = c.get("wall_s")
        if s_budget > 0 and wall is not None and wall > s_budget:
            flags.append({
                "epoch": None, "line": c.get("_line"),
                "flag": "compile_over_budget",
                "detail": f"'{c.get('fn')}' compile wall {wall:.2f}s > "
                          f"budget {s_budget:g}s (plan row)",
            })
    return flags


def recovery_flags(run: dict) -> List[dict]:
    """Recovery actions as first-class flags. Three sources:
    epoch records whose `skipped_steps` metric shows the in-graph
    finite guard fired (per seed lane on fleets), `recovery` logger
    events (rollbacks — including the *_unavailable kinds, which mean
    the escalation wanted a checkpoint and had none), and the recovery
    timeline marks (quarantines, circuit breakers, bounded retries)."""
    flags: List[dict] = []
    for rec in run.get("epochs", []):
        if "skipped_steps" not in rec:
            continue
        lanes = _nums(rec.get("skipped_steps"))
        hit = [(s, n) for s, n in enumerate(lanes) if n > 0]
        if not hit:
            continue
        width = len(lanes)
        detail = ", ".join(
            f"{n:g} update(s) skipped" + _seed_tag(rec, s, width)
            for s, n in hit)
        flags.append({"epoch": rec.get("epoch"), "line": rec.get("_line"),
                      "flag": "skip_step",
                      "detail": f"finite guard: {detail}"})
    for rec in run.get("events", []):
        if rec.get("event") != "recovery":
            continue
        kind = rec.get("kind", "rollback")
        if kind in ("rollback", "lane_rollback"):
            lane = (f"seed lane {rec['lane']} " if "lane" in rec else "")
            lr = (f", lr_scale={rec['lr_scale']:g}"
                  if isinstance(rec.get("lr_scale"), (int, float)) else "")
            detail = (f"{lane}rolled back to checkpoint step "
                      f"{rec.get('restored_step')}{lr}")
        else:
            detail = f"{kind}: {rec.get('note', '')}".strip(": ")
        flags.append({"epoch": rec.get("epoch"), "line": rec.get("_line"),
                      "flag": "rollback", "detail": detail})
    for m in run.get("marks", []):
        kind = RECOVERY_MARK_FLAGS.get(m.get("name"))
        if kind is None:
            continue
        what = {k: v for k, v in m.items()
                if k in ("step", "reason", "model", "path", "chunk",
                         "attempt", "error", "fails")}
        detail = (m.get("name") + (" " + " ".join(
            f"{k}={v}" for k, v in sorted(what.items())) if what else ""))
        flags.append({"epoch": m.get("epoch"), "line": m.get("_line"),
                      "flag": kind, "detail": detail})
    flags.sort(key=lambda f: (f.get("line") is None, f.get("line") or 0))
    return flags


def drift_flags(run: dict) -> List[dict]:
    """Served-score drift (obs/drift.py emits the marks): a
    model whose day-over-day served ranking collapsed below the drift
    threshold — the Rank-IC-decay signature of regime shift — raises a
    `score_drift` flag per mark."""
    flags: List[dict] = []
    for m in run.get("marks", []):
        kind = DRIFT_MARK_FLAGS.get(m.get("name"))
        if kind is None:
            continue
        corr = m.get("rank_corr")
        corr_s = (f"{corr:.3f}" if isinstance(corr, (int, float))
                  else str(corr))
        flags.append({
            "epoch": None, "line": m.get("_line"), "flag": kind,
            "detail": (f"model {m.get('alias') or m.get('model')}: "
                       f"day-over-day rank corr {corr_s} < "
                       f"{m.get('threshold')} (day {m.get('day')} vs "
                       f"{m.get('prev_day')}, n={m.get('n_common')})"),
        })
    return flags


def build_report(run: dict, **kw) -> dict:
    epochs = run["epochs"]
    flags = health_flags(epochs, run["events"], **kw)
    flags += program_flags(run)
    flags += drift_flags(run)
    recov = recovery_flags(run)
    flags += recov
    by_kind: dict = {}
    for f in flags:
        by_kind[f["flag"]] = by_kind.get(f["flag"], 0) + 1
    finals = [r for r in run["events"] if r.get("event") in ("best",
                                                            "fleet_best")]
    scores = [r for r in run["events"] if r.get("event") == "scores"]
    probes_on = any(k in rec for rec in epochs for k in TRAIN_PROBE_KEYS)
    return {
        "meta": run["meta"][-1] if run["meta"] else None,
        "num_epochs": len(epochs),
        "probes": probes_on,
        "epochs": epochs,
        "compiles": compile_summary(run),
        "flags": flags,
        "summary": {
            "flag_counts": by_kind,
            "healthy": not flags,
            # recovery actions alone (subset of flag_counts): the run
            # took damage AND healed — distinct from undetected-problem
            # flags like grad_spike
            "recovery_counts": {
                k: n for k, n in sorted(by_kind.items())
                if k in ("skip_step", "rollback", "quarantine",
                         "circuit_open", "retry")},
            "best": finals[-1] if finals else None,
            "scores": scores[-1] if scores else None,
        },
    }


def _flag_matches(f: dict, rec: dict) -> bool:
    """Row join for the table: by stream position when both sides have
    it (epoch numbers repeat across concatenated runs), else by epoch
    number (hand-built record lists)."""
    if f.get("line") is not None and rec.get("_line") is not None:
        return f["line"] == rec["_line"]
    return f["epoch"] == rec.get("epoch")


def format_report(rep: dict) -> str:
    lines = []
    meta = rep["meta"] or {}
    lines.append(
        f"run: {meta.get('run_name') or '?'}  platform="
        f"{meta.get('platform')}  devices={meta.get('device_count')}  "
        f"git={meta.get('git_sha')}  config={meta.get('config_hash')}")
    lines.append(f"epochs: {rep['num_epochs']}   health probes: "
                 f"{'on' if rep['probes'] else 'off'}")
    comp = rep.get("compiles") or {}
    if comp.get("records"):
        peak = comp.get("max_peak_bytes")
        lines.append(
            f"compiled programs: {len(comp['by_fn'])} jits / "
            f"{comp['records']} compiles, "
            f"{comp['total_wall_s']:.2f}s compile wall"
            + (f", peak program HBM estimate {peak / 1e6:.1f} MB"
               if peak else ""))
    if rep["epochs"]:
        cols = ["epoch", "train_loss", "val_loss", "lr", "days_per_sec"]
        if rep["probes"]:
            cols += ["grad_norm_max", "nonfinite_grads"]
        lines.append("  ".join(f"{c:>13}" for c in cols) + "  flags")
        for rec in rep["epochs"]:
            row = []
            for c in cols:
                v = _mean(rec.get(c)) if c != "epoch" else rec.get(c)
                row.append(f"{v:>13.6g}" if isinstance(v, (int, float))
                           else f"{'-':>13}")
            marks = sorted({f["flag"] for f in rep["flags"]
                            if _flag_matches(f, rec)})
            lines.append("  ".join(row) + ("  !! " + ",".join(marks)
                                           if marks else ""))
        if any(isinstance(r.get("train_loss"), list) for r in rep["epochs"]):
            lines.append("(fleet run: per-seed lists reported as means; "
                         "flags fire if ANY seed trips)")
    if rep["flags"]:
        lines.append("")
        lines.append(f"HEALTH FLAGS ({len(rep['flags'])}):")
        for f in rep["flags"]:
            where = (f"epoch {f['epoch']}" if f.get("epoch") is not None
                     else "program")  # compile/budget flags are per jit
            lines.append(f"  {where}: [{f['flag']}] {f['detail']}")
    else:
        lines.append("no health flags — run looks clean")
    recov = rep["summary"].get("recovery_counts") or {}
    if recov:
        lines.append(
            "recovery actions: "
            + ", ".join(f"{k} x{n}" for k, n in recov.items())
            + " (the run took damage and healed — docs/robustness.md)")
    best = rep["summary"]["best"]
    if best:
        vals = best.get("best_val")
        lines.append(f"best val: {vals}")
    sc = rep["summary"]["scores"]
    if sc:
        lines.append(f"scores: rank_ic={sc.get('rank_ic')} "
                     f"rank_ic_ir={sc.get('rank_ic_ir')} -> {sc.get('path')}")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m factorvae_tpu_torch.obs.report",
        description="Per-epoch health table + flags for a RUN.jsonl")
    ap.add_argument("run_jsonl")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--follow", action="store_true",
                    help="tail an in-flight stream instead of reading "
                         "a finished one: delegates to the live "
                         "follower (obs/live.py), emitting each flag "
                         "as an alert when it appears; flags are "
                         "pinned identical to this report run post-hoc")
    ap.add_argument("--idle-timeout", type=float, default=None,
                    help="with --follow: stop after this many seconds "
                         "without new bytes (default: follow forever)")
    ap.add_argument("--spike-mult", type=float, default=10.0)
    ap.add_argument("--slow-frac", type=float, default=0.5)
    ap.add_argument("--diverge-frac", type=float, default=0.2)
    ap.add_argument("--diverge-epochs", type=int, default=3)
    args = ap.parse_args(argv)
    import sys

    if args.follow:
        from factorvae_tpu_torch.obs import live

        follow_args = [args.run_jsonl, "--follow"]
        if args.json:
            follow_args.append("--json")
        if args.idle_timeout is not None:
            follow_args += ["--idle-timeout", str(args.idle_timeout)]
        follow_args += [
            "--spike-mult", str(args.spike_mult),
            "--slow-frac", str(args.slow_frac),
            "--diverge-frac", str(args.diverge_frac),
            "--diverge-epochs", str(args.diverge_epochs)]
        return live.main(follow_args)

    try:
        run, warnings = open_run(args.run_jsonl)
    except RunStreamError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for w in warnings:
        print(f"warning: {w}", file=sys.stderr)
    rep = build_report(
        run, spike_mult=args.spike_mult,
        slow_frac=args.slow_frac, diverge_frac=args.diverge_frac,
        diverge_epochs=args.diverge_epochs)
    if args.json:
        print(json.dumps(rep, indent=2, default=str))
    else:
        print(format_report(rep))
    return 0 if rep["num_epochs"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
