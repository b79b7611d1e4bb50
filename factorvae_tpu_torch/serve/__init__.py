"""The scoring service (`factorvae_tpu/serve/`, its single-process half):
the registry of resident models and the scoring daemon with its stdin,
batch-file and HTTP front ends.

    python -m factorvae_tpu_torch.serve --model DIR --dataset panel.pkl [--http PORT --scheduler]

The worker pool, the router and remote workers are ROADMAP Queue 1 item 6.
"""

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

__all__ = [
    "Entry",
    "ModelRegistry",
    "RegistryError",
    "ScoringDaemon",
    "TickScheduler",
    "checkpoint_config",
    "precision_config",
    "serve_batch_file",
    "serve_http",
    "serve_stdin",
]
