"""The native panel ops (`factorvae_tpu/native/`): a ctypes binding of
`panelops.cpp` with the numpy versions as the fallback.

    fill_maps(valid, fallback=None)                    -> (last_valid, next_valid)
    scatter_panel(values, rows, cols, d_total, n_inst, fallback=None)
                                                       -> (I, D, C) float32

Each runs the native pass when the library loads. When it does not (with
``FACTORVAE_NATIVE=0``, without `g++`, without the source, with a build
directory it cannot write, or after a failed build) it runs `fallback` on
the same arguments, or returns None when there is none.
`data/windows.compute_fill_maps` and `data/panel.build_panel` pass their
numpy code as the fallback. The results are the numpy versions' bit for
bit; of two rows with one (day, instrument) the scatter keeps the later
one, as `build_panel`'s numpy path does. The C ABI is the JAX file's, but
`scatter_panel` reads values through their strides: `df.to_numpy()` of a
frame is column-major, which the JAX binding copies to row-major first.

`load()` builds the library with ``g++ -O3 -shared -fPIC -std=c++17`` at
first use into the kernels' build directory (`_build.BUILD_DIR`, which
`_build.set_build_dir` and the entry points' ``--compile_cache`` move). The
file name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library never loads; the build runs under the
directory's ``.build.lock`` (`_build._exclusive`), so processes that start
together build it once. A library that cannot be built or loaded is
reported once, with the reason (g++'s output for a failed compile), as a
warning. The library is not one of `_build.KERNELS` and adds nothing to
`_build.compile_event_counts()`.

`call_counts()` says which path served each call: {"fill_maps": {"native":
n, "numpy": n}, "scatter_panel": {...}}; `reset_call_counts()` sets every
count to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from factorvae_tpu_torch import _build

SRC = Path(__file__).resolve().parent / "panelops.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
ENV = "FACTORVAE_NATIVE"
OPS = ("fill_maps", "scatter_panel")
PATHS = ("native", "numpy")

# one lock for the loaded libraries, the refused builds and the counts: the
# daemon's scheduler thread and an append can both reach the fill maps
_LOCK = threading.Lock()
_loaded: dict = {}          # library path -> CDLL
_refused: set = set()       # library paths (or SRC) that failed (reported once)
_counts = {op: dict.fromkeys(PATHS, 0) for op in OPS}


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return _build.BUILD_DIR / f"libpanelops-{h.hexdigest()[:16]}.so"


def _compile(path: Path) -> Optional[str]:
    """Build the library into `path`: None once it is there, else why not.
    OSError (an unwritable build directory, a failed exec) propagates."""
    cxx = shutil.which("g++")
    if cxx is None:
        return "g++ not found"
    with _build._exclusive():
        if path.exists():               # built by a concurrent process
            return None
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=120)
            if proc.returncode != 0:
                return (f"building {path.name} failed (g++ exited {proc.returncode}):\n"
                        f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)       # atomic: a reader never sees half a file
        except subprocess.TimeoutExpired as exc:
            return f"building {path.name} timed out after {exc.timeout} s"
        finally:
            tmp.unlink(missing_ok=True)
    return None


def _refuse(key, reason: str) -> None:
    """Report `reason` once for `key` (a library path, or SRC)."""
    if key not in _refused:
        _refused.add(key)
        warnings.warn(f"the native panel ops are off and numpy serves the fill maps "
                      f"and the panel scatter: {reason}", stacklevel=4)


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None when disabled by
    ``FACTORVAE_NATIVE=0`` or when it cannot be built or loaded."""
    if os.environ.get(ENV, "1") == "0":
        return None
    with _LOCK:
        try:
            path = library_path()
        except OSError as exc:          # an install that left the source out
            return _refuse(SRC, f"reading {SRC} failed ({exc})")
        lib = _loaded.get(path)
        if lib is not None or path in _refused:
            return lib
        try:
            failure = None if path.exists() else _compile(path)
            if failure is None:
                lib = ctypes.CDLL(str(path))
        except OSError as exc:          # no build directory or lock, no exec, no load
            failure = f"building or loading {path} failed ({exc})"
        if failure is not None:
            return _refuse(path, failure)
        lib.fill_maps.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.fill_maps.restype = None
        lib.scatter_panel.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]
        lib.scatter_panel.restype = None
        _loaded[path] = lib
        return lib


def _record(op: str, path: str) -> None:
    with _LOCK:
        _counts[op][path] += 1


def call_counts() -> dict:
    with _LOCK:
        return {op: dict(c) for op, c in _counts.items()}


def reset_call_counts() -> None:
    with _LOCK:
        for c in _counts.values():
            c.update(dict.fromkeys(PATHS, 0))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def fill_maps(valid: np.ndarray, fallback: Optional[Callable] = None):
    """(last_valid, next_valid), both (D, I) int32, of valid (D, I) (see
    `data/windows.compute_fill_maps`); `fallback(valid)` (or None) when the
    library is off."""
    lib = load()
    if lib is None:
        if fallback is None:
            return None
        out = fallback(valid)
        _record("fill_maps", "numpy")
        return out
    v = np.ascontiguousarray(np.asarray(valid, bool), dtype=np.uint8)
    d, i = v.shape
    last = np.empty((d, i), np.int32)
    nxt = np.empty((d, i), np.int32)
    lib.fill_maps(_ptr(v, ctypes.c_uint8), d, i,
                  _ptr(last, ctypes.c_int32), _ptr(nxt, ctypes.c_int32))
    _record("fill_maps", "native")
    return last, nxt


def scatter_panel(values: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                  d_total: int, n_inst: int, fallback: Optional[Callable] = None):
    """values (n_rows, C) to a dense (n_inst, d_total, C) float32 panel, NaN
    where no row lands, row k at (cols[k], rows[k]), the later of two rows
    with one cell; `fallback(values, rows, cols, d_total, n_inst)` (or None)
    when the library is off. Out-of-range indices raise IndexError, as
    numpy's do."""
    lib = load()
    if lib is None:
        if fallback is None:
            return None
        out = fallback(values, rows, cols, d_total, n_inst)
        _record("scatter_panel", "numpy")
        return out
    # any float32 layout: the library reads values through its strides
    values = np.asarray(values, dtype=np.float32)
    if values.ndim != 2 or any(st % values.itemsize for st in values.strides):
        values = np.ascontiguousarray(values)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    n_rows, c = values.shape
    if rows.shape != (n_rows,) or cols.shape != (n_rows,):
        raise ValueError(f"scatter_panel: {n_rows} rows of values but rows "
                         f"{rows.shape} and cols {cols.shape}")
    if n_rows and not (0 <= rows.min() and rows.max() < d_total
                       and 0 <= cols.min() and cols.max() < n_inst):
        raise IndexError(f"scatter_panel: an index lies outside the ({n_inst}, "
                         f"{d_total}) panel")
    out = np.full((n_inst, d_total, c), np.nan, np.float32)
    row_stride, col_stride = (st // values.itemsize for st in values.strides)
    lib.scatter_panel(_ptr(values, ctypes.c_float), row_stride, col_stride,
                      _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64), n_rows,
                      d_total, c, _ptr(out, ctypes.c_float))
    _record("scatter_panel", "native")
    return out
