"""The scoring service (`factorvae_tpu/serve/`): the registry of resident
models (weights or AOT artifacts) and the scoring daemon with its stdin,
batch-file and HTTP front ends; the worker pool with its AOT store, the
sticky router, remote workers and the autoscaler.

    python -m factorvae_tpu_torch.serve --model DIR --dataset panel.pkl [--http PORT --scheduler]
    python -m factorvae_tpu_torch.serve --model DIR ... --workers 2 --router_port 8800
"""

from factorvae_tpu_torch.serve.autoscale import AutoScaler
from factorvae_tpu_torch.serve.daemon import (
    ScoringDaemon,
    TickScheduler,
    serve_batch_file,
    serve_http,
    serve_stdin,
)
from factorvae_tpu_torch.serve.registry import (
    Entry,
    ModelRegistry,
    RegistryError,
    checkpoint_config,
    precision_config,
)
from factorvae_tpu_torch.serve.pool import AotStore, WorkerPool
from factorvae_tpu_torch.serve.router import Router, rendezvous_order

__all__ = [
    "AotStore",
    "AutoScaler",
    "Entry",
    "ModelRegistry",
    "RegistryError",
    "Router",
    "ScoringDaemon",
    "TickScheduler",
    "WorkerPool",
    "checkpoint_config",
    "precision_config",
    "rendezvous_order",
    "serve_batch_file",
    "serve_http",
    "serve_stdin",
]
