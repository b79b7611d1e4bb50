"""Summarize a `torch.profiler` capture from the command line
(`factorvae_tpu/utils/trace_summary.py`, read from Kineto's traces).

    python -m factorvae_tpu_torch.utils.trace_summary DIR [--top 15]

prints the device-time breakdown of the Chrome traces under DIR
(`*.pt.trace.json[.gz]`, as `utils/profiling` and
`torch.profiler.tensorboard_trace_handler` write them): the total time on
the card and the kernels, copies and sets by accumulated duration.

Format notes. Kineto marks the card's events by their category (`cat`):
`kernel`, `gpu_memcpy` ("Memcpy HtoD", "Memcpy DtoH", "Memcpy DtoD") and
`gpu_memset`; there is no "/device:" process name as in a `jax.profiler`
trace. The hand-written kernels, launched through ctypes, appear under
their CUDA function names; the host rows name their launch through the
wrappers' `record_function`. `python_function` frames (a nested call stack)
and the capture's own `Trace` range are skipped, as the JAX reader skips
`$` frames, and so are `gpu_user_annotation` ranges, which repeat the host
annotations on the card's timeline. A capture with no card events (a CPU
run) takes every lane, as the JAX reader does for a host-only trace.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from collections import defaultdict
from typing import Optional

#: categories of the card's own work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: nested or wrapping ranges whose time other events already carry
_SKIP_CATS = ("python_function", "Trace", "gpu_user_annotation")


def find_trace_files(log_dir: str) -> list:
    """All .trace.json(.gz) files under a capture dir."""
    out: list = []
    for pat in ("*.trace.json.gz", "*.trace.json"):
        out.extend(glob.glob(os.path.join(log_dir, "**", pat), recursive=True))
    return sorted(out)


def _load_events(path: str) -> list:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as fh:
        data = json.load(fh)
    if isinstance(data, list):      # bare-array Chrome trace format
        return data
    return data.get("traceEvents", [])


_TRANSFER_MARKERS = ("memcpy",)
_H2D_MARKERS = ("htod", "h2d")
_D2H_MARKERS = ("dtoh", "d2h")


def _classify_transfer(name: str) -> Optional[str]:
    low = name.lower()
    if not any(m in low for m in _TRANSFER_MARKERS):
        return None
    if any(m in low for m in _H2D_MARKERS):
        return "h2d_us"
    if any(m in low for m in _D2H_MARKERS):
        return "d2h_us"
    return "other_us"


def summarize_trace(log_dir: str, device_only: bool = True, top: int = 15) -> dict:
    """{'files', 'device_pids', 'host_pids', 'num_lanes', 'total_us',
    'host_us', 'host_by_name', 'transfer', 'by_name': [(name, us, count)]}

    Complete ("X") event durations summed by name over every trace file:
    the card's events (`DEVICE_CATS`) into `by_name` / `total_us`, the host
    events into `host_by_name` / `host_us`, and the memcpy events of the
    card into `transfer` {h2d_us, d2h_us, other_us, count}. With
    device_only=False, or in a capture with no card events, every event
    counts in `by_name`."""
    files = find_trace_files(log_dir)
    device_pids: dict = {}
    host_pids: dict = {}
    durations: dict = defaultdict(float)
    counts: dict = defaultdict(int)
    host_durations: dict = defaultdict(float)
    host_counts: dict = defaultdict(int)
    transfer = {"h2d_us": 0.0, "d2h_us": 0.0, "other_us": 0.0, "count": 0}
    total = host_total = 0.0
    loaded = []
    any_device = False
    for f in files:
        events = _load_events(f)
        lanes = {}
        for ev in events:
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                lanes[ev.get("pid")] = (ev.get("args") or {}).get("name", "")
        dev = {ev.get("pid") for ev in events
               if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS}
        any_device = any_device or bool(dev)
        loaded.append((events, lanes, dev))
    restrict = device_only and any_device
    for events, lanes, dev in loaded:
        if restrict:
            device_pids.update({p: lanes.get(p, f"device {p}") for p in dev})
            host_pids.update({p: n for p, n in lanes.items() if p not in dev})
        else:
            device_pids.update(lanes)
        for ev in events:
            if ev.get("ph") != "X" or ev.get("cat") in _SKIP_CATS:
                continue
            name = ev.get("name", "?")
            dur = float(ev.get("dur", 0.0))
            on_card = ev.get("cat") in DEVICE_CATS
            kind = _classify_transfer(name) if on_card else None
            if kind is not None:
                transfer[kind] += dur
                transfer["count"] += 1
            if restrict and not on_card:
                host_durations[name] += dur
                host_counts[name] += 1
                host_total += dur
                continue
            durations[name] += dur
            counts[name] += 1
            total += dur
    by_name = sorted(((n, d, counts[n]) for n, d in durations.items()),
                     key=lambda t: -t[1])[: max(top, 0)]
    host_by_name = sorted(((n, d, host_counts[n]) for n, d in host_durations.items()),
                          key=lambda t: -t[1])[: max(top, 0)]
    return {
        "files": files,
        "device_pids": device_pids,
        "host_pids": host_pids,
        # durations are summed over every matched lane and stream, so
        # overlapping work counts once per lane and total_us can exceed wall
        "num_lanes": len(device_pids),
        "total_us": total,
        "host_us": host_total,
        "host_by_name": host_by_name,
        "transfer": transfer,
        "by_name": by_name,
    }


def format_summary(s: dict) -> str:
    lines = []
    if not s["files"]:
        return "no .trace.json(.gz) files found (did the trace capture run?)"
    lines.append(f"trace files : {len(s['files'])}")
    lanes = ", ".join(str(v) for v in s["device_pids"].values()) or "(none)"
    lines.append(f"device lanes: {lanes}")
    n_lanes = s.get("num_lanes", len(s["device_pids"]))
    qualifier = (f" (summed across {n_lanes} lanes; overlapping execution counts "
                 "once per lane, so this can exceed wall time)" if n_lanes > 1 else "")
    lines.append(f"device time : {s['total_us'] / 1e3:.3f} ms{qualifier}")
    if s.get("host_us"):
        n_host = len(s.get("host_pids", {}))
        lines.append(f"host time   : {s['host_us'] / 1e3:.3f} ms across {n_host} host "
                     "lane(s) (--all_lanes merges them into the breakdown)")
    tr = s.get("transfer") or {}
    if tr.get("count"):
        lines.append(f"transfer    : H2D {tr['h2d_us'] / 1e3:.3f} ms, "
                     f"D2H {tr['d2h_us'] / 1e3:.3f} ms, "
                     f"other {tr['other_us'] / 1e3:.3f} ms ({tr['count']} memcpy events)")
    if s["by_name"]:
        width = max(len(n) for n, _, _ in s["by_name"])
        lines.append(f"{'kernel/op':<{width}}  {'total':>10}  {'count':>6}  share")
        for name, us, cnt in s["by_name"]:
            share = us / s["total_us"] if s["total_us"] else 0.0
            lines.append(f"{name:<{width}}  {us / 1e3:>8.3f}ms  {cnt:>6}  {share:>5.1%}")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m factorvae_tpu_torch.utils.trace_summary",
        description="Device-time breakdown of a torch.profiler trace dir")
    ap.add_argument("log_dir")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--all_lanes", action="store_true",
                    help="include host lanes (default: the card's events only)")
    args = ap.parse_args(argv)
    s = summarize_trace(args.log_dir, device_only=not args.all_lanes, top=args.top)
    print(format_summary(s))
    return 0 if s["files"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
