"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, compiled for Hopper (`sm_90a`) into the build directory at first
use: `factorvae_tpu_torch/_build/`, or the directory `set_build_dir` names
(`plan.setup_compilation_cache`, the entry points' `--compile_cache DIR`,
so that every process given one DIR shares its libraries). The
library's file name carries a hash of its source, of the shared headers and
of the flags, so an edited source is rebuilt and a stale library is never
loaded. `build()` starts one nvcc per missing library, all at once, holding
an exclusive lock on the directory's `.build.lock` (`fcntl.flock`, released by the
kernel if the process dies) from the check to the rename: two processes
that miss the same library (a pool's workers joining at once) build it
once, and the second finds it built. `load` of a kernel library that is
not built yet builds every missing one of `KERNELS` in that one call, so a
process with an empty build directory waits for the slowest nvcc, not for
the sum of them one at a time.

No `--use_fast_math`: it would change `expf`/`tanhf` and widen every
tolerance against the plain PyTorch versions.

`compile_event_counts()` is this process's build taxonomy, the daemon's
`compile_total` metric: `compile` counts the libraries `build` compiled,
`compile_cached` those `load` found already built by an earlier process.
Each also writes one record of that name onto the installed timeline
(`utils/logging.timeline_compile`): `fn` the library, `wall_s` from nvcc's
start to its exit being seen (the builds run in parallel) or the ctypes load
of a cached library, and `cached`.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from factorvae_tpu_torch.utils.logging import timeline_compile

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent / "_build"
BUILD_DIR = DEFAULT_BUILD_DIR        # moved by set_build_dir
KERNELS = ("gru_fwd", "gru_bwd", "attention_fwd", "attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}
_compiled: set = set()        # libraries nvcc built in this process
_counts = {"compile": 0, "compile_cached": 0}
# the daemon's scheduler thread loads libraries too
_COUNTS_LOCK = threading.Lock()


def compile_event_counts() -> dict:
    """{"compile": n, "compile_cached": n} of this process's libraries."""
    with _COUNTS_LOCK:
        return dict(_counts)


def set_build_dir(path) -> Path:
    """Build and load the libraries in `path` from now on (a library this
    process already loaded stays loaded: its name pins its source)."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()
    return BUILD_DIR


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of factorvae_tpu_torch are built on the machine with the "
            "GPU")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _exclusive():
    """This process alone between a library's existence check and its
    rename into place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build(names=KERNELS) -> dict:
    """Compile every missing library in parallel, under the build lock;
    returns {name: ptxas log} (empty for a library that was already built).
    Raises on a failed build."""
    with _exclusive():
        return _build_missing(names)


def _build_missing(names) -> dict:
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a reader never sees half a file
            _compiled.add(name)
            with _COUNTS_LOCK:
                _counts["compile"] += 1
            timeline_compile(name, t0, time.perf_counter())
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build(KERNELS if name in KERNELS else (name,))
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(path))
        if name not in _compiled:     # built by an earlier or a concurrent process
            with _COUNTS_LOCK:
                _counts["compile_cached"] += 1
            timeline_compile(name, t0, time.perf_counter(), cached=True)
        _loaded[name] = lib
    return lib
