"""Full-state checkpoints of a training run (the port's own format).

One file per saved epoch, `<directory>/epoch_<n>.pt`, written to a temporary
name and renamed, so a reader never sees half a file. It holds what a resumed
run needs to continue exactly: the model's and the optimizer's state_dicts,
the scheduler's position, the train step count, the noise generator's state,
a mixed run's loss scale and finite-step count (absent on float32 runs),
and a `meta` dict (epoch, best validation loss, config, and `clean`: no bad
signal at that epoch, so it may anchor a rollback). The newest `keep`
files stay; an epoch replayed after a rollback replaces its file.
Best-validation weights go through `params.save_weights` instead; they are
the float32 masters whatever the training dtype. The JAX
package's orbax checkpoints, manifests and quarantine are not ported.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from factorvae_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = max(1, int(keep))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"epoch_{step}.pt")

    def all_steps(self) -> list:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, meta: dict) -> str:
        os.makedirs(self.directory, exist_ok=True)
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "generator": state.generator.get_state(),
            "step": state.step,
            "meta": meta,
        }
        if state.loss_scale is not None:
            payload["loss_scale"] = float(state.loss_scale)     # a float32 value
            payload["good_steps"] = int(state.good_steps)
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.keep]:
            os.remove(self._path(old))
        return path

    def restore(self, state: TrainState, step: Optional[int] = None) -> dict:
        """Load checkpoint `step` (the newest by default) into `state` in
        place; returns its meta."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.scheduler.load_state_dict(payload["scheduler"])
        state.generator.set_state(payload["generator"])
        state.step = int(payload["step"])
        if "loss_scale" in payload:
            state.loss_scale = np.float32(payload["loss_scale"])
            state.good_steps = int(payload["good_steps"])
        return payload["meta"]

