"""The structured metrics stream (`factorvae_tpu/utils/logging.py`).

`MetricsLogger` writes one JSON line per event to a JSONL file and echoes
it as `[event] k=v, ...` on stdout. A file-backed stream opens with a
`run_meta` record (torch, its CUDA version, the card, the git sha, the
config hash), so a RUN.jsonl says what produced it. `use_wandb` degrades
to JSONL only, with one line on stderr, when wandb cannot be imported or
started.

`Timeline` is the span/event half: spans on `time.perf_counter` relative to
the timeline's origin, written as `span` / `mark` records into the same
stream, with the JAX package's keys (`name`, `cat`, `resource`, `t0`, `t1`,
`dur`, `thread` / `t`), so the JAX `obs.timeline` renderer reads a port
RUN.jsonl unchanged. Producers deep in the stack (the stream's worker, the
daemon, the registry) reach the installed timeline through
`install_timeline` and the helpers `timeline_span`, `timeline_event`,
`timeline_span_at`: each is a no-op when no timeline is installed. A span
that one thread opens and another closes (a queued request) uses the
`timeline_span_begin` / `timeline_span_end` token pair. Spans may carry
trace identity (`trace`, `span`, `parent`; `obs/trace.py`) as extra fields.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Iterator, Optional

import torch

from factorvae_tpu_torch.config import config_hash

__all__ = ["MetricsLogger", "Timeline", "backend_env", "config_hash", "current_timeline",
           "install_timeline", "run_meta", "timeline_event", "timeline_now",
           "timeline_span", "timeline_span_at", "timeline_span_begin", "timeline_span_end"]


def _git_sha() -> Optional[str]:
    try:
        r = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))))
    except (OSError, subprocess.SubprocessError):
        return None
    return (r.stdout.strip() or None) if r.returncode == 0 else None


def backend_env() -> dict:
    """The settings torch's numbers depend on: the visible cards, whether
    float32 products may round through TF32, whether bfloat16 products may
    reduce in bfloat16 (XLA's accumulate in float32), and the CPU thread
    count."""
    return {
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "matmul_allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "torch_num_threads": torch.get_num_threads(),
    }


def run_meta(config: Optional[dict] = None, run_name: Optional[str] = None,
             device_name: bool = True) -> dict:
    """Header fields for the first record of a metrics stream. Reading the
    card's name makes a CUDA context: a process that must not make one (the
    router) passes device_name=False and the header's `device` is None."""
    cuda = torch.cuda.is_available()
    meta: dict = {"run_name": run_name, "git_sha": _git_sha(), "env": backend_env(),
                  "torch": torch.__version__, "cuda": torch.version.cuda,
                  "platform": "cuda" if cuda else "cpu",
                  "device": torch.cuda.get_device_name(0) if cuda and device_name else None,
                  "device_count": torch.cuda.device_count() if cuda else 0}
    if config is not None:
        meta["config_hash"] = config_hash(config)
    return meta


class MetricsLogger:
    """JSONL metric stream; a context manager; thread-safe writes."""

    def __init__(self, jsonl_path: Optional[str] = None, use_wandb: bool = False,
                 wandb_project: str = "factorvae-tpu", run_name: Optional[str] = None,
                 config: Optional[dict] = None, echo: bool = True, echo_to: Any = None,
                 device_name: bool = True):
        self.jsonl_path = jsonl_path
        self.echo = echo
        self._echo_to = echo_to
        self._lock = threading.Lock()
        self._fh = None
        self._wandb = None
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)), exist_ok=True)
            self._fh = open(jsonl_path, "a")
            self.log("run_meta", _echo=False, **run_meta(config, run_name=run_name,
                                                         device_name=device_name))
        if use_wandb:
            try:
                import wandb  # type: ignore

                self._wandb = wandb
                wandb.init(project=wandb_project, name=run_name, config=config or {})
            except Exception as e:  # wandb absent or offline: JSONL only
                print(f"[metrics] wandb unavailable ({e}); JSONL only", file=sys.stderr)
                self._wandb = None

    def log(self, event: str, _echo: Optional[bool] = None, **fields: Any) -> None:
        rec = {"ts": time.time(), "event": event, **fields}
        with self._lock:
            if self._fh:
                self._fh.write(json.dumps(rec) + "\n")
                self._fh.flush()
        wandb = self._wandb
        if wandb is not None and event == "epoch":
            wandb.log({k: v for k, v in fields.items() if isinstance(v, (int, float))})
        if self.echo if _echo is None else _echo:
            shown = ", ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                              for k, v in fields.items())
            print(f"[{event}] {shown}", file=self._echo_to)

    def finish(self, **fields: Any) -> None:
        if fields:
            self.log("final", **fields)
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
        with self._lock:
            if self._fh:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.finish()


class Timeline:
    """Span/event emitter over a MetricsLogger stream. Record shapes:

        {"event": "span", "name", "cat", "resource", "t0", "t1", "dur", "thread", ...}
        {"event": "mark", "name", "cat", "resource", "t", ...}

    `resource` is the lane the Gantt renderer groups by ("device", "serve",
    "stream", ...); `cat` is the subsystem."""

    _clock = staticmethod(time.perf_counter)

    def __init__(self, logger: MetricsLogger, origin: Optional[float] = None):
        self.logger = logger
        self.origin = self._clock() if origin is None else origin

    def rel(self, mono: float) -> float:
        return mono - self.origin

    def event(self, name: str, cat: str = "host", resource: str = "host",
              **fields: Any) -> None:
        self.logger.log("mark", _echo=False, name=name, cat=cat, resource=resource,
                        t=round(self.rel(self._clock()), 6), **fields)

    def span_at(self, name: str, t0: float, t1: float, cat: str = "host",
                resource: str = "host", **fields: Any) -> None:
        """A span from already-measured perf_counter endpoints."""
        self.logger.log("span", _echo=False, name=name, cat=cat, resource=resource,
                        t0=round(self.rel(t0), 6), t1=round(self.rel(t1), 6),
                        dur=round(t1 - t0, 6), thread=threading.current_thread().name,
                        **fields)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host", resource: str = "host",
             **fields: Any) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            self.span_at(name, t0, self._clock(), cat=cat, resource=resource, **fields)


# a module global, not a contextvar: worker threads must see it too
_TIMELINE: Optional[Timeline] = None


def install_timeline(tl: Optional[Timeline]) -> Optional[Timeline]:
    """Install the process-wide timeline; returns the previous one."""
    global _TIMELINE
    prev, _TIMELINE = _TIMELINE, tl
    return prev


def current_timeline() -> Optional[Timeline]:
    return _TIMELINE


@contextlib.contextmanager
def timeline_span(name: str, cat: str = "host", resource: str = "host",
                  **fields: Any) -> Iterator[None]:
    """`Timeline.span` on the installed timeline; a no-op without one."""
    tl = _TIMELINE
    if tl is None:
        yield
        return
    with tl.span(name, cat=cat, resource=resource, **fields):
        yield


def timeline_event(name: str, cat: str = "host", resource: str = "host",
                   **fields: Any) -> None:
    tl = _TIMELINE
    if tl is not None:
        tl.event(name, cat=cat, resource=resource, **fields)


def timeline_span_at(name: str, t0: float, t1: float, cat: str = "host",
                     resource: str = "host", **fields: Any) -> None:
    tl = _TIMELINE
    if tl is not None:
        tl.span_at(name, t0, t1, cat=cat, resource=resource, **fields)


def timeline_now() -> Optional[float]:
    """Seconds since the installed timeline's origin, or None without one."""
    tl = _TIMELINE
    return None if tl is None else round(tl.rel(tl._clock()), 6)


def timeline_span_begin(name: str, cat: str = "host", resource: str = "host",
                        **fields: Any) -> Optional[dict]:
    """Open a span that another thread closes with `timeline_span_end`:
    an opaque token, or None without a timeline. Within one function use
    `timeline_span`, which cannot leak the span on an exception."""
    tl = _TIMELINE
    if tl is None:
        return None
    return {"name": name, "cat": cat, "resource": resource, "t0": tl._clock(),
            "fields": dict(fields)}


def timeline_span_end(token: Optional[dict], **extra: Any) -> None:
    """Close a `timeline_span_begin` span (a no-op on None), with `extra`
    fields over the begin-time ones, on the timeline installed now."""
    if token is None:
        return
    tl = _TIMELINE
    if tl is None:
        return
    tl.span_at(token["name"], token["t0"], tl._clock(), cat=token["cat"],
               resource=token["resource"], **{**token["fields"], **extra})


def timeline_compile(fn: str, t0: float, t1: float, cached: bool = False) -> None:
    """The record of one program build, in the schema the JAX package's
    jit watchdog writes (`factorvae_tpu/obs/watchdog.py`): a `compile`
    record (`compile_cached` when an earlier process had built it) with
    `fn`, `wall_s` and `cached`, and a span on the "compile" lane. The port
    has no jit: its builds are the kernel libraries' nvcc runs (`_build.py`)
    and `torch.export` (`eval/export_aot.py`). The program bill that JAX
    reads from XLA has no source here, so `flops`, `peak_bytes`, `lower_s`
    and `compile_s` are null, as JAX's guarded accessors give them where
    the API is missing. A no-op without a timeline."""
    tl = _TIMELINE
    if tl is None:
        return
    tl.span_at(f"build:{fn}", t0, t1, cat="compile", resource="compile", cached=cached)
    tl.logger.log("compile_cached" if cached else "compile", _echo=False, fn=fn,
                  wall_s=round(t1 - t0, 6), cached=cached, compiles=1, flops=None,
                  peak_bytes=None, lower_s=None, compile_s=None)
