"""One run of one cell: set-up, the measured window, the trace's reduction,
the check against the reference, and the result line."""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from benchmark.harness import cells
from benchmark.harness.trace import Capture, breakdown, reduce_events

FORBIDDEN = ("jax", "jaxlib", "flax", "factorvae_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (`factorvae_tpu_torch` is not `factorvae_tpu`)."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or ""."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return ""
    try:
        out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", spec: dict = None) -> tuple:
    """(result, checks): the result line's object without its "checks", and
    the checks {name: (value, limit)}."""
    spec = spec or cells.spec()
    w = cells.workload(spec, name)
    config, traffic, own = cells.config(w["config"]), cells.traffic(w["traffic"]), cells.cell(name)
    e2e = [e for e in spec["end_to_end"] if cells.reports(e, name, [])]
    layer = [e for e in spec["per_layer"] if cells.reports(e, name, spec["end_to_end"])]
    readers = {e["name"]: cells.metric_reader(e["name"]) for e in layer} if trace else {}
    counters, ranges, table = {}, set(), {}
    for r in readers.values():
        counters.update(getattr(r, "COUNTERS", {}))
        ranges.update(getattr(r, "RANGES", ()))
        table.update(getattr(r, "NAME_TABLE", {}))

    from benchmark.harness.common import read_counters

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    driver = cells.driver(traffic["kind"]).Driver(config, traffic, seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()     # set-up's objects stay out of the window's collections
    setup_s = time.perf_counter() - t_start
    before = read_counters(counters)
    capture = Capture(trace and device == "cuda")
    with capture.window():
        done = driver.window(seconds)
    after = read_counters(counters)
    gc.unfreeze()
    print(f"window {done['window_s']!r} s; " + "; ".join(
        f"{k} spans {[round(float(x), 4) for x in v]}" for k, v in done["spans"].items()),
        file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    shapes = driver.shapes()
    driver.release()

    result = {"correct": False, "attempted": done["attempted"], "failed": done["failed"]}
    metrics, extra = {}, {}
    if trace:
        capture.read()
        red = None
        if capture.device:
            red = reduce_events(capture.device, capture.host, ranges, table)
            extra["breakdown"] = breakdown(red)
        capture.host = capture.device = None
        ctx = SimpleNamespace(config=config, traffic=traffic, cell=w, shapes=shapes, reduced=red,
                      counts={k: after[k] - before[k] for k in counters}, **done)
        for e in layer:
            value = readers[e["name"]].read(ctx)
            if value is not None:
                metrics[e["name"]] = {"value": float(value), "unit": e["unit"]}
        dev_busy = (red.busy_s, red.window_s) if red is not None else None
    else:
        values = dict(done["rates"], setup_s=setup_s)
        for e in e2e:
            if e["name"] in values:
                metrics[e["name"]] = {"value": float(values[e["name"]]), "unit": e["unit"]}
        dev_busy = None

    numbers = driver.numbers()
    limits = own["limits"]
    checks = {k: (v, limits[k]) for k, v in numbers.items() if not k.startswith("_")}
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    correct = correct and done["failed"] == 0
    device_info = {"platform": "gpu" if device == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power_limit": power_limit() if device == "cuda" else ""}
    if dev_busy is not None:
        device_info["busy_s"], device_info["window_s"] = dev_busy
    result.update(correct=correct, metrics=metrics, device=device_info, **extra)
    result["notes"] = {k[1:]: v for k, v in numbers.items() if k.startswith("_")}
    return result, checks


def emit(result: dict, checks: dict) -> None:
    """stderr's last lines: each compared number beside its limit; stdout's
    last line: the result, its "checks" last."""
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result, checks={k: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                                for k, (v, lim) in checks.items()})
    print(json.dumps(line), flush=True)


def cache_dirs(root) -> dict:
    """The fixed directories, inside the checkout, of every build and kernel
    cache."""
    base = os.path.join(root, ".benchmark_cache")
    return {"build": os.path.join(base, "build"), "triton": os.path.join(base, "triton"),
            "torch_extensions": os.path.join(base, "torch_extensions")}
