"""The readings a cell's correctness limits are set from, at the cell's own
size, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... [--control 3]

For every seed, the program's compared numbers (the run's set-up, and for a
backfill cell one pass of its window); for a training cell also each leaf's
readings (its reference gradient over the median leaf's, both sides'
gradient and change). For the first `--control` seeds also
the control: the reference put in the program's place and computed in TF32
(the precision below the configuration's float32), and the planted faults a
cell of its kind can have: for training, half of each batch's days left out
with the mean taken over the rest (a state left unchanged reads 1 by
construction); for a backfill, one answer altered where it is produced (two
stocks' scores swapped) and half of each chunk's days left unscored. Each
reading is one JSON line on stdout. The benchmark's runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def altered(chunks: list) -> list:
    """The chunks with the first two scored stocks of the first chunk's
    first day swapped."""
    import numpy as np

    out = [c.copy() for c in chunks]
    first = out[0][0]
    idx = np.flatnonzero(np.isfinite(first))[:2]
    first[idx] = first[idx[::-1]]
    return out


def halved(chunks: list) -> list:
    """The chunks with the second half of each chunk's days unscored."""
    out = [c.copy() for c in chunks]
    for c in out:
        c[c.shape[0] // 2:] = float("nan")
    return out


def readings(name: str, seed: int, control: bool, device: str = "cuda") -> dict:
    from benchmark.harness import cells, common

    spec = cells.spec()
    w = cells.workload(spec, name)
    config, traffic = cells.config(w["config"]), cells.traffic(w["traffic"])
    t0 = time.perf_counter()
    driver = cells.driver(traffic["kind"]).Driver(config, traffic, seed, device)
    out = {"cell": name, "seed": seed, "setup_s": time.perf_counter() - t0}
    if traffic["kind"] == "backfill":
        driver.window(0.0)
    driver.release()
    if traffic["kind"] == "train":
        ref = driver.reference_run("float32")
        out["program"] = driver.numbers(against=ref, leaves=True)
        if control:
            out["control"] = driver.numbers(prog=driver.reference_run("tf32"), against=ref)
            out["half_batch"] = driver.numbers(
                prog=driver.reference_run("float32", half_batch=True), against=ref)
    else:
        pairs = driver.sample()
        ref = driver.reference_scores(pairs, "float32")
        out["program"] = driver.numbers(against=ref)
        if control:
            out["control"] = driver.numbers(prog=driver.reference_scores(pairs, "tf32"),
                                            against=ref)
            out["answer_altered"] = driver.numbers(prog=altered(ref), against=ref)
            prog = [driver.outputs[p][c * driver.chunk:(c + 1) * driver.chunk]
                    for c, p in pairs]
            out["half_batch"] = driver.numbers(prog=halved(prog), against=ref)
    out["seconds"] = time.perf_counter() - t0
    common.free_device()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3,
                    help="how many of the seeds also read the control and the faults")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness.runner import cache_dirs

    os.environ["TRITON_CACHE_DIR"] = cache_dirs(ROOT)["triton"]
    import torch

    from factorvae_tpu_torch import _build

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    _build.set_build_dir(cache_dirs(ROOT)["build"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, i < args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
