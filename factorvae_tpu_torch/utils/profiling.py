"""Profiling on `torch.profiler` (`factorvae_tpu/utils/profiling.py`).

- `trace(log_dir)`: a capture around a block (the CLI's `--profile DIR`).
- `start_profile` / `stop_profile`: the explicit pair behind the daemon's
  `POST /profile`; `stop_profile` summarizes the capture through
  `utils/trace_summary.py`.
- `maybe_profile_epoch`: the trainers' epoch hook. A `PROFILE_REQUEST` file
  (empty, or JSON `{"log_dir": ...}`) dropped into the run directory runs
  the next train epoch under a capture; the poll is one `os.path.exists`
  per epoch, and only for runs with a metrics stream.
- `step_annotation(name)`: `torch.profiler.record_function`.
- `debug_nans()`: `torch.autograd` anomaly mode with `check_nan`. It is
  not JAX's `jax_debug_nans`: it raises when a backward function returns a
  NaN (the kernels' `autograd.Function`s included), not on a NaN in a
  forward value, and not on a NaN multiplied into the gradients after
  `backward()` (the chaos `nan_grads` poison).

Every capture records CPU activity on every thread (the daemon's capture
starts on an HTTP thread while its ticks run on the scheduler's) and, when
a card is present, CUDA activity, which CUPTI records for every thread. One
capture runs at a time in a process (`ProfilerError` otherwise). A trace is
written as `<host>_<pid>.<ms>.pt.trace.json` into the capture's directory,
the Chrome format `utils/trace_summary.py` reads.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import tempfile
import threading
import time
from typing import Iterator, Optional, Tuple

import torch

#: drop this file into a run directory to request an epoch capture
PROFILE_REQUEST_BASENAME = "PROFILE_REQUEST"


class ProfilerError(RuntimeError):
    """Capture state or backend failure, with a one-line message (the
    daemon's /profile answers it as {"ok": false})."""


_LOCK = threading.Lock()
_ACTIVE: dict = {"dir": None, "prof": None}


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _new_profiler():
    """A profiler over every thread where this torch offers it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        config = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):     # an older torch: the starting thread only
        config = None
    return torch.profiler.profile(activities=_activities(), experimental_config=config)


def _start(log_dir: str) -> str:
    """Start the process's one capture into `log_dir`."""
    with _LOCK:
        if _ACTIVE["prof"] is not None:
            raise ProfilerError(
                f"a profile capture is already running into {_ACTIVE['dir']}; "
                "POST {\"action\": \"stop\"} first")
        try:
            os.makedirs(log_dir, exist_ok=True)
            prof = _new_profiler()
            prof.start()
        except ProfilerError:
            raise
        except Exception as e:       # noqa: BLE001 - a one-line answer
            raise ProfilerError(f"torch.profiler failed to start: {e}") from e
        _ACTIVE.update(dir=log_dir, prof=prof)
        return log_dir


def _stop() -> str:
    """Stop the running capture and write its trace; returns its dir."""
    with _LOCK:
        prof, log_dir = _ACTIVE["prof"], _ACTIVE["dir"]
        if prof is None:
            raise ProfilerError(
                "no profile capture is running; POST {\"action\": \"start\"} first")
        _ACTIVE.update(dir=None, prof=None)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    try:
        prof.stop()
        name = f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1e3)}.pt.trace.json"
        prof.export_chrome_trace(os.path.join(log_dir, name))
    except Exception as e:           # noqa: BLE001 - a one-line answer
        raise ProfilerError(f"torch.profiler failed to stop: {e}") from e
    return log_dir


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture the block into `log_dir` (a no-op when None)."""
    if not log_dir:
        yield
        return
    _start(log_dir)
    try:
        yield
    finally:
        _stop()


def start_profile(log_dir: Optional[str] = None) -> str:
    """Begin an on-demand capture; returns its log dir (a fresh temporary
    directory when none is given)."""
    return _start(log_dir or tempfile.mkdtemp(prefix="factorvae_profile_"))


def stop_profile(top: int = 10) -> dict:
    """End the running capture and summarize it: {"log_dir", "files",
    "total_us", "host_us", "top": [[name, us, count], ...]}."""
    log_dir = _stop()
    return {"log_dir": log_dir, **summarize_capture(log_dir, top=top)}


def summarize_capture(log_dir: str, top: int = 10) -> dict:
    """The `trace_summary` digest of a capture dir; an unreadable trace
    gives an `error` field, never an exception on the serving or training
    path."""
    from factorvae_tpu_torch.utils.trace_summary import summarize_trace

    try:
        s = summarize_trace(log_dir, top=top)
    except Exception as e:           # noqa: BLE001 - telemetry degrades to a field
        return {"files": 0, "error": str(e)}
    return {
        "files": len(s["files"]),
        "total_us": round(s["total_us"], 3),
        "host_us": round(s.get("host_us", 0.0), 3),
        "top": [[name, round(us, 3), count] for name, us, count in s["by_name"]],
    }


def poll_profile_request(run_dir: Optional[str]) -> Optional[dict]:
    """Consume a PROFILE_REQUEST from `run_dir`: its JSON body ({} for an
    empty or garbled file: the request still counts), the file removed; or
    None when there is none."""
    if not run_dir:
        return None
    path = os.path.join(run_dir, PROFILE_REQUEST_BASENAME)
    if not os.path.exists(path):
        return None
    req: dict = {}
    try:
        with open(path) as fh:
            body = fh.read().strip()
        if body:
            parsed = json.loads(body)
            if isinstance(parsed, dict):
                req = parsed
    except (OSError, ValueError):
        req = {}
    with contextlib.suppress(OSError):   # consumed by a sibling: capture anyway
        os.remove(path)
    return req


@contextlib.contextmanager
def maybe_profile_epoch(run_dir: Optional[str],
                        epoch: int) -> Iterator[Tuple[bool, Optional[str]]]:
    """With a PROFILE_REQUEST in `run_dir`, run the block under a capture
    into the request's `log_dir` (default `<run_dir>/profile_epoch<e>`) and
    yield (True, log_dir); otherwise (False, None). A capture that cannot
    start (another one running, an unwritable dir) yields (False, "<error>")
    and the epoch runs without it: telemetry never stops the epoch loop."""
    req = poll_profile_request(run_dir)
    if req is None:
        yield False, None
        return
    log_dir = str(req.get("log_dir") or os.path.join(run_dir, f"profile_epoch{int(epoch)}"))
    try:
        _start(log_dir)
    except ProfilerError as e:
        yield False, f"profile capture failed to start: {e}"
        return
    try:
        yield True, log_dir
    finally:
        # a failed stop leaves no trace file: summarize_capture then says
        # files=0, which is how the failure shows
        with contextlib.suppress(ProfilerError):
            _stop()


def step_annotation(name: str):
    """A named range on the profiler's host timeline."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Raise where a backward function returns a NaN while active (see the
    module docstring for how this differs from `jax_debug_nans`)."""
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield
