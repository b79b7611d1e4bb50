"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. The last
line of standard output is the run's result (JSON); standard error ends
with each compared number beside its limit. See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the host threads of PyTorch's and OpenMP's pools: the window's host work
#: is one thread's launches, and idle pool threads only compete with it for
#: the host's shared cores
HOST_THREADS = 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from benchmark.harness.runner import cache_dirs

    caches = cache_dirs(ROOT)
    os.environ["TRITON_CACHE_DIR"] = caches["triton"]
    os.environ["TORCH_EXTENSIONS_DIR"] = caches["torch_extensions"]
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(HOST_THREADS)

    import torch

    torch.set_num_threads(HOST_THREADS)

    from benchmark.harness import cells

    spec = cells.spec()
    chips = cells.workload(spec, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        from factorvae_tpu_torch import _build
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout ({e})", file=sys.stderr)
        return 2
    _build.set_build_dir(caches["build"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from benchmark.harness.runner import emit, forbidden_modules, run_cell

    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              T_START, device="cuda", spec=spec)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of the JAX package or of JAX are loaded: {found}",
              file=sys.stderr)
        return 3
    emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
