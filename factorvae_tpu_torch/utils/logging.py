"""The structured metrics stream (`factorvae_tpu/utils/logging.py`).

`MetricsLogger` writes one JSON line per event to a JSONL file and echoes
it as `[event] k=v, ...` on stdout. A file-backed stream opens with a
`run_meta` record (torch, its CUDA version, the card, the git sha, the
config hash), so a RUN.jsonl says what produced it. `use_wandb` degrades
to JSONL only, with one line on stderr, when wandb cannot be imported or
started. The JAX package's host `Timeline` is not ported (ROADMAP Queue 1
item 11).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Optional

import torch

from factorvae_tpu_torch.config import config_hash

__all__ = ["MetricsLogger", "backend_env", "config_hash", "run_meta"]


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


def run_meta(config: Optional[dict] = None, run_name: Optional[str] = None) -> dict:
    """Header fields for the first record of a metrics stream."""
    cuda = torch.cuda.is_available()
    meta: dict = {"run_name": run_name, "git_sha": _git_sha(), "env": backend_env(),
                  "torch": torch.__version__, "cuda": torch.version.cuda,
                  "device": torch.cuda.get_device_name(0) if cuda else None,
                  "device_count": torch.cuda.device_count() if cuda else 0}
    if config is not None:
        meta["config_hash"] = config_hash(config)
    return meta


class MetricsLogger:
    """JSONL metric stream; a context manager; thread-safe writes."""

    def __init__(self, jsonl_path: Optional[str] = None, use_wandb: bool = False,
                 wandb_project: str = "factorvae-tpu", run_name: Optional[str] = None,
                 config: Optional[dict] = None, echo: bool = True, echo_to: Any = None):
        self.jsonl_path = jsonl_path
        self.echo = echo
        self._echo_to = echo_to
        self._lock = threading.Lock()
        self._fh = None
        self._wandb = None
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)), exist_ok=True)
            self._fh = open(jsonl_path, "a")
            self.log("run_meta", _echo=False, **run_meta(config, run_name=run_name))
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
