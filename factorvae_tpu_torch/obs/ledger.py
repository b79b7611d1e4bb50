"""Perf-regression ledger (`factorvae_tpu/obs/ledger.py`): bench payloads as
a tracked history, each metric's latest row checked against the trailing
median of its own rig's rows.

    python -m factorvae_tpu_torch.obs.ledger [HISTORY]                 # check; exit 1 on regression
    python -m factorvae_tpu_torch.obs.ledger [HISTORY] --json          # the report as JSON
    python -m factorvae_tpu_torch.obs.ledger HISTORY --backfill A.json [B.json ...]

Exit codes: 0 ok, 1 a regression, 2 no history (or `--backfill` with no
artifact, which writes nothing).

Row schema (one JSON object per line), the JAX module's:

    {"ts", "metric", "value", "unit", "platform", "vs_baseline",
     "plan": <the bench plan block>, "run_meta": {git_sha, env, ...}}

The functions, the `_trackable` rule, the threshold and window defaults,
`check`'s report (backfilled rows sorted ahead of tracked ones) and
`format_report`'s text are the JAX module's. Where they differ:

- **History file.** `BENCH_HISTORY_TORCH.jsonl` at the repo root, or
  ``$FACTORVAE_TORCH_BENCH_HISTORY``; never the JAX package's
  `BENCH_HISTORY.jsonl` or ``$FACTORVAE_BENCH_HISTORY``.
- **Backfill.** `backfill` reads only the artifacts it is given; there is
  no default set (the repo's `BENCH_*.json` hold the JAX package's TPU and
  CPU numbers, which the port does not carry over).
- **Row metadata.** `make_row` falls back to the port's
  `utils/logging.run_meta()`, plus the card's power limit on a CUDA device
  (`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`).
- **Rig key.** `rig_key` adds `run_meta.device` (the card's name) and the
  power limit, so two cards, or one card at two power limits, are never
  one rig.

Metrics are higher-is-better: a regression is `latest < (1 - threshold) x
trailing median` of up to `window` prior same-rig rows.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from statistics import median
from typing import List, Optional, Tuple

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
HISTORY_ENV = "FACTORVAE_TORCH_BENCH_HISTORY"
DEFAULT_HISTORY_PATH = os.path.join(_REPO_ROOT, "BENCH_HISTORY_TORCH.jsonl")

DEFAULT_THRESHOLD = 0.4
DEFAULT_WINDOW = 5


def history_path(path: Optional[str] = None) -> str:
    return path or os.environ.get(HISTORY_ENV) or DEFAULT_HISTORY_PATH


def rig_key(row: dict) -> str:
    """Canonical comparability key of one row: platform, device_count, the
    backend env, the card's name and power limit (sorted JSON, so dict order
    never splits a rig). A backfilled row keys on its source artifact too:
    its own rig, never a regression baseline for tracked rows."""
    meta = row.get("run_meta") or {}
    key = {
        "platform": row.get("platform"),
        "device_count": meta.get("device_count"),
        "env": meta.get("env"),
        "device": meta.get("device"),
        "power_limit": meta.get("power_limit"),
        "backfill_source": meta.get("backfill_source"),
    }
    return json.dumps(key, sort_keys=True)


def power_limit() -> Optional[str]:
    """The power limit of the process's first visible card as `nvidia-smi`
    gives it ("700.00 W"), or None without nvidia-smi."""
    visible = (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0].strip()
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
           f"--id={visible if visible.isdigit() else 0}"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        return None
    return lines[0].rsplit(",", 1)[-1].strip()


def this_rig() -> dict:
    """This process's `utils/logging.run_meta()`, with the card's power
    limit on a CUDA device."""
    from factorvae_tpu_torch.utils import logging as loglib

    meta = loglib.run_meta()
    if meta.get("platform") == "cuda":
        meta["power_limit"] = power_limit()
    return meta


def make_row(payload: dict, run_meta: Optional[dict] = None) -> dict:
    """One history row of a bench payload. Its rig is `run_meta` when
    given, else the payload's own (the measuring process's), else this
    process's (`this_rig`)."""
    if run_meta is None:
        run_meta = payload.get("run_meta") or this_rig()
    return {
        "ts": round(time.time(), 3),
        "metric": payload.get("metric"),
        "value": payload.get("value"),
        "unit": payload.get("unit"),
        "platform": payload.get("platform"),
        "vs_baseline": payload.get("vs_baseline"),
        "plan": payload.get("plan"),
        "run_meta": run_meta,
    }


def _trackable(payload: dict) -> Optional[Tuple[str, float]]:
    """(metric, value) when a payload belongs in the history, else None:
    `*_failed` metrics and non-positive or non-numeric values carry no
    throughput and would poison the median the next run is judged by."""
    metric = str(payload.get("metric") or "")
    try:
        value = float(payload.get("value"))
    except (TypeError, ValueError):
        return None
    if not metric or metric.endswith("_failed") or value <= 0:
        return None
    return metric, value


def append_row(payload: dict, path: Optional[str] = None,
               run_meta: Optional[dict] = None) -> Optional[str]:
    """Append one bench payload as a history row; an untrackable payload is
    skipped. Returns the path written, or None when skipped."""
    if _trackable(payload) is None:
        return None
    p = history_path(path)
    with open(p, "a") as fh:
        fh.write(json.dumps(make_row(payload, run_meta=run_meta)) + "\n")
    return p


def load_history(path: Optional[str] = None) -> List[dict]:
    """Rows in file order; unparseable lines are skipped (a kill mid-append
    may tear the last line)."""
    rows = []
    try:
        fh = open(history_path(path))
    except OSError:
        return rows
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("metric") is not None:
                rows.append(rec)
    return rows


def check(path: Optional[str] = None, threshold: float = DEFAULT_THRESHOLD,
          window: int = DEFAULT_WINDOW) -> Tuple[bool, dict]:
    """(ok, report). Each metric's latest row against the trailing median of
    up to `window` prior same-rig rows; `ok` is False when any metric
    regressed past the threshold. Other rigs' rows are counted as skipped.
    Backfilled rows sort ahead of tracked ones wherever they sit in the
    file, so a late backfill never demotes the latest tracked row."""
    rows = load_history(path)
    by_metric: dict = {}
    for r in rows:
        by_metric.setdefault(r["metric"], []).append(r)
    for metric, series in by_metric.items():
        by_metric[metric] = sorted(
            series, key=lambda r: 0 if (r.get("run_meta") or {}).get(
                "backfill_source") else 1)
    report: dict = {"path": history_path(path), "rows": len(rows),
                    "threshold": threshold, "window": window, "metrics": []}
    ok = True
    for metric in sorted(by_metric):
        series = by_metric[metric]
        latest = series[-1]
        prior = series[:-1]
        rig = rig_key(latest)
        same = [r for r in prior if rig_key(r) == rig]
        entry: dict = {
            "metric": metric,
            "unit": latest.get("unit"),
            "latest": latest.get("value"),
            "history": len(prior),
            "other_rig_skipped": len(prior) - len(same),
        }
        vals = []
        for r in same[-window:]:
            try:
                v = float(r.get("value"))
            except (TypeError, ValueError):
                continue
            if v > 0:
                vals.append(v)
        if not vals:
            entry["status"] = "no_comparable_history"
        else:
            med = median(vals)
            try:
                ratio = float(latest.get("value")) / med
            except (TypeError, ValueError, ZeroDivisionError):
                ratio = None
            entry["trailing_median"] = round(med, 3)
            entry["ratio_vs_median"] = (round(ratio, 4)
                                        if ratio is not None else None)
            if ratio is None or ratio < 1.0 - threshold:
                entry["status"] = "REGRESSION"
                ok = False
            elif ratio > 1.0 + threshold:
                entry["status"] = "improvement"
            else:
                entry["status"] = "ok"
        report["metrics"].append(entry)
    report["ok"] = ok
    return ok, report


def _payloads_from_artifact(fname: str) -> List[dict]:
    """Bench payloads in one artifact: a direct payload ({metric, value,
    unit}), or a driver wrapper whose `tail` holds the bench's JSON lines.
    Anything else yields nothing."""
    try:
        with open(fname) as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return []
    if not isinstance(data, dict):
        return []
    if {"metric", "value", "unit"} <= set(data):
        return [data]
    out = []
    for line in str(data.get("tail", "")).splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and {"metric", "value", "unit"} <= set(rec):
            out.append(rec)
    return out


def backfill(artifacts: List[str], path: Optional[str] = None) -> dict:
    """Extend the history from the bench artifacts named, in the order
    given; nothing is read or written when none is named. A (metric, value,
    source) already present is not added again, so backfill is idempotent.
    Backfilled rows carry `run_meta.backfill_source`, no env and a null
    `ts`: each artifact is a rig of its own (`rig_key`)."""
    p = history_path(path)
    if not artifacts:
        return {"path": p, "added": [], "skipped_artifacts": []}
    existing = {
        (r.get("metric"), r.get("value"),
         (r.get("run_meta") or {}).get("backfill_source"))
        for r in load_history(path)}
    added, skipped = [], []
    with open(p, "a") as fh:
        for fname in artifacts:
            payloads = _payloads_from_artifact(fname)
            src = os.path.basename(fname)
            if not payloads:
                skipped.append(src)
                continue
            for payload in payloads:
                tv = _trackable(payload)
                if tv is None:
                    continue
                metric, value = tv
                if (payload.get("metric"), payload.get("value"),
                        src) in existing:
                    continue
                row = make_row(payload, run_meta={"backfill_source": src})
                row["ts"] = None  # measurement time unknown; order known
                fh.write(json.dumps(row) + "\n")
                added.append({"metric": metric, "value": value,
                              "source": src})
    return {"path": p, "added": added, "skipped_artifacts": skipped}


def format_report(report: dict) -> str:
    lines = [f"perf ledger: {report['path']} ({report['rows']} rows, "
             f"threshold {report['threshold']:.0%}, "
             f"window {report['window']})"]
    if not report["metrics"]:
        lines.append("  (empty history — write rows with `obs.ledger.append_row` "
                     "or `python -m factorvae_tpu_torch.obs.ledger HISTORY "
                     "--backfill ARTIFACT...`)")
    for e in report["metrics"]:
        med = e.get("trailing_median")
        ratio = e.get("ratio_vs_median")
        detail = (f"latest {e['latest']:g} vs median {med:g} "
                  f"(x{ratio:g})" if med is not None
                  else f"latest {e['latest']:g} — {e['status']}")
        mark = {"REGRESSION": "!!", "improvement": "++"}.get(
            e["status"], "  ")
        skip = (f"  [{e['other_rig_skipped']} other-rig rows skipped]"
                if e.get("other_rig_skipped") else "")
        lines.append(f"{mark} {e['metric']}: {detail}{skip}")
    lines.append("OK" if report["ok"] else
                 "REGRESSION detected (exit 1)")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m factorvae_tpu_torch.obs.ledger",
        description="perf-regression check over the port's bench history "
                    "(latest row vs trailing same-rig median per metric)")
    ap.add_argument("history", nargs="?", default=None,
                    help=f"history path (default: ${HISTORY_ENV} or "
                         f"{os.path.basename(DEFAULT_HISTORY_PATH)} at "
                         "the repo root)")
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                    help="regression when latest < (1-threshold) x median")
    ap.add_argument("--window", type=int, default=DEFAULT_WINDOW,
                    help="trailing same-rig rows in the median")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--backfill", nargs="*", default=None, metavar="ARTIFACT",
                    help="append the bench payloads of these artifacts "
                         "(idempotent), then check; at least one is required")
    args = ap.parse_args(argv)
    if args.backfill is not None:
        if not args.backfill:
            print("error: --backfill reads only the artifacts it is given; "
                  "name at least one (nothing was written)")
            return 2
        res = backfill(args.backfill, path=args.history)
        if not args.json:
            print(f"backfilled {len(res['added'])} rows -> {res['path']}"
                  + (f" (no payload in: "
                     f"{', '.join(res['skipped_artifacts'])})"
                     if res["skipped_artifacts"] else ""))
    elif not os.path.exists(history_path(args.history)):
        print(f"error: no bench history at {history_path(args.history)} "
              "(write rows with obs.ledger.append_row, or --backfill ARTIFACT...)")
        return 2
    ok, report = check(path=args.history, threshold=args.threshold,
                       window=args.window)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(format_report(report))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
