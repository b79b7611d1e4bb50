#!/usr/bin/env python3
"""Time the port's host panel build, native panel ops against numpy.

    python3 scripts/torch_panel_build_times.py [--sizes 300x500,800x1250]
        [--features 158] [--reps 3] [--device cuda] [--out FILE]

For each size (stocks x trading days) a reference-schema frame of C
features and a label (`data.panel.panel_to_frame` of a dense synthetic
panel from --seed, each (day, stock) row dropped with probability 0.05) is
densified by `data.panel.build_panel` and its padded valid matrix goes
through `data.windows.compute_fill_maps`, with the native pass
(`factorvae_tpu_torch/native`) and with ``FACTORVAE_NATIVE=0`` (numpy), in
turns native, numpy, numpy, native per repetition. Also timed alone: the
scatter (`native.scatter_panel` against numpy's fancy assignment) on the
frame's own rows and columns, and, at the largest size, `extend_days` of
one day on a `PanelDataset` of every day before it, host-resident
("stream") and on the device ("hbm", the grown panel copied to the card),
which recomputes the fill maps over the whole history; the append goes
through `ScoringDaemon.extend_dataset`, as the walk-forward operator's
pickup makes it (under the daemon's tick lock). Every pair is
checked bitwise. Seconds are host wall (`time.perf_counter`; an "hbm"
append ends in `torch.cuda.synchronize()`), the median of --reps turns of
each path, every turn listed. `native.call_counts()` shows which path
served each call. The default device is the GPU, and without one the
script exits 1; `--device cpu` rehearses it on the host and says so.
Prints the card's `nvidia-smi` name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame(n_inst: int, n_days: int, n_feat: int, seed: int):
    from factorvae_tpu_torch.data.panel import panel_to_frame
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense

    panel = synthetic_panel_dense(n_days, n_inst, n_feat, seed=seed)
    panel.valid = np.random.default_rng(seed + 1).random(panel.valid.shape) > 0.05
    return panel_to_frame(panel)


def _turns(fns: dict, reps: int) -> dict:
    """Each of two paths `reps` times in turns A, B, B, A, ...; each fn
    returns (seconds, result): {path: {"s": median, "turns": [...]},
    "results": {path: last result}}."""
    a, b = list(fns)
    secs = {a: [], b: []}
    results = {}
    for r in range(reps):
        for name in ((a, b) if r % 2 == 0 else (b, a)):
            took, results[name] = fns[name]()
            secs[name].append(took)
    return {**{k: {"s": statistics.median(v), "turns": v} for k, v in secs.items()},
            "results": results}


def _timed(fn):
    def call():
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out
    return call


def _with_native(on: bool, fn):
    def call():
        if on:
            os.environ.pop("FACTORVAE_NATIVE", None)
        else:
            os.environ["FACTORVAE_NATIVE"] = "0"
        try:
            return fn()
        finally:
            os.environ.pop("FACTORVAE_NATIVE", None)
    return call


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _pair(fns: dict, reps: int, what: str) -> dict:
    """`_turns` of {"native": fn, "numpy": fn}, their results bitwise equal."""
    timed = _turns(fns, reps)
    got = timed.pop("results")
    if not _same(got["native"], got["numpy"]):
        raise RuntimeError(f"{what}: the native and the numpy results differ")
    timed["numpy_over_native"] = timed["numpy"]["s"] / timed["native"]["s"]
    timed["bitwise"] = True
    return timed


def _both(fn) -> dict:
    """`fn` with the native pass on and with FACTORVAE_NATIVE=0, each
    returning (seconds, result)."""
    return {"native": _with_native(True, fn), "numpy": _with_native(False, fn)}


def _size(n_inst, n_days, n_feat, reps, seed, device, extend: bool) -> dict:
    import torch

    from factorvae_tpu_torch import native
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.panel import build_panel
    from factorvae_tpu_torch.data.windows import compute_fill_maps
    from factorvae_tpu_torch.serve.daemon import ScoringDaemon
    from factorvae_tpu_torch.serve.registry import ModelRegistry

    t0 = time.perf_counter()
    df = _frame(n_inst, n_days, n_feat, seed)
    frame_s = time.perf_counter() - t0
    native.reset_call_counts()
    panel = build_panel(df)
    out = {"stocks": n_inst, "days": n_days, "features": n_feat, "rows": len(df),
           "dense_bytes": int(panel.values.nbytes), "frame_s": frame_s}
    out["build_panel"] = _pair(_both(_timed(lambda: (lambda p: (p.values, p.valid))(
        build_panel(df)))), reps, "build_panel")
    # the scatter alone, on the frame's own indices (as build_panel finds them)
    level0, level1 = df.index.get_level_values(0), df.index.get_level_values(1)
    rows = level0.unique().sort_values().get_indexer(level0).astype(np.int64)
    cols = level1.unique().sort_values().get_indexer(level1).astype(np.int64)
    data = df.to_numpy(dtype=np.float32)

    def numpy_scatter():
        values = np.full((n_inst, n_days, data.shape[1]), np.nan, np.float32)
        values[cols, rows] = data
        return values

    out["scatter"] = _pair({"native": _timed(lambda: native.scatter_panel(
        data, rows, cols, n_days, n_inst)), "numpy": _timed(numpy_scatter)}, reps, "scatter")
    n_max = -(-n_inst // 8) * 8
    valid = np.zeros((n_days, n_max), bool)
    valid[:, :n_inst] = panel.valid
    out["fill_maps"] = _pair(_both(_timed(lambda: compute_fill_maps(valid))), reps,
                             "fill_maps")
    out["fill_maps"]["shape"] = list(valid.shape)
    if extend:
        history, day = (panel.date_slice(None, str(panel.dates[-2])),
                        panel.date_slice(str(panel.dates[-1]), None))
        out["extend_days"] = {}
        for residency in ("stream", "hbm")[:2 if device == "cuda" else 1]:

            def grow(residency=residency):
                """The append alone, on a fresh dataset of the history, as
                the walk-forward operator's pickup makes it: through the
                serving daemon, under its tick lock."""
                ds = PanelDataset(history, seq_len=20, device=device, residency=residency)
                daemon = ScoringDaemon(ModelRegistry(device=device), ds)
                if device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                if not daemon.extend_dataset(day):
                    raise RuntimeError("extend_dataset added no day")
                if device == "cuda":
                    torch.cuda.synchronize()
                took = time.perf_counter() - t0
                return took, (ds.last_valid_np if residency == "stream"
                              else ds.last_valid.cpu().numpy())

            out["extend_days"][residency] = _pair(_both(grow), reps,
                                                  f"extend_days {residency}")
    out["call_counts"] = native.call_counts()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sizes", default="300x500,800x1250",
                   help="comma-separated STOCKSxDAYS; the last one also times extend_days")
    p.add_argument("--features", type=int, default=158)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default=None, help="also append the JSON line here")
    args = p.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_panel_build_times: no CUDA device (pass --device cpu to "
              "rehearse on the host)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from factorvae_tpu_torch import native

    card = None
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else None
        print(card, flush=True)
    t0 = time.perf_counter()
    lib = native.load()
    load_s = time.perf_counter() - t0
    if lib is None:
        print("torch_panel_build_times: the native library did not build", file=sys.stderr)
        return 1
    sizes = [tuple(int(x) for x in s.split("x")) for s in args.sizes.split(",")]
    result = {"script": "scripts/torch_panel_build_times.py", "device": args.device,
              "card": card, "cpu_count": os.cpu_count(), "library": native.library_path().name,
              "library_load_s": load_s, "reps": args.reps,
              "sizes": [_size(n, d, args.features, args.reps, args.seed, args.device,
                              extend=k == len(sizes) - 1)
                        for k, (n, d) in enumerate(sizes)]}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
