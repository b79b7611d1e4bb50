"""Registry of resident scoring models (`factorvae_tpu/serve/registry.py`,
minimal).

An entry is keyed by the canonical hash of its Config (`config.config_hash`)
and may carry an alias. `admit` takes an in-memory model with its Config, or
a weights directory written by `params.save_weights`. The precision ladder,
AOT artifacts, byte budgets, eviction and cold starts of the JAX registry
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from factorvae_tpu_torch.config import Config, config_hash


class RegistryError(ValueError):
    """Admission or lookup failure with a one-line message."""


@dataclasses.dataclass
class Entry:
    key: str
    config: Config
    model: torch.nn.Module
    alias: Optional[str] = None
    source: str = "params"               # params | weights
    nbytes: int = 0
    requests: int = 0

    def describe(self) -> dict:
        m = self.config.model
        return {"key": self.key, "alias": self.alias, "source": self.source,
                "nbytes": self.nbytes, "requests": self.requests,
                "arch": {"c": m.num_features, "t": m.seq_len, "h": m.hidden_size,
                         "k": m.num_factors, "m": m.num_portfolios}}


class ModelRegistry:
    """Models that a daemon scores with, loaded onto `device`."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._entries: dict = {}
        self._aliases: dict = {}
        self.hits = 0
        self.misses = 0

    def admit(self, source, config: Optional[Config] = None,
              alias: Optional[str] = None) -> str:
        """Admit a model (with its `config`) or a weights directory; returns
        the key. Re-admitting a key replaces its entry."""
        from factorvae_tpu_torch.models.factorvae import load_model
        from factorvae_tpu_torch.params import read_config

        if isinstance(source, torch.nn.Module):
            if config is None:
                raise RegistryError("an in-memory model needs its Config")
            model, kind = source, "params"
        else:
            path = os.path.abspath(str(source))
            if not os.path.isdir(path):
                raise RegistryError(f"no weights directory at {path}")
            config = config or read_config(path)
            model = load_model(config, checkpoint_path=path, device=self.device)
            kind = "weights"
            alias = alias or os.path.basename(path)
        key = config_hash(config.to_dict())
        nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
        self._entries[key] = Entry(key=key, config=config, model=model.eval(),
                                   alias=alias, source=kind, nbytes=int(nbytes))
        if alias:
            self._aliases[alias] = key
        return key

    def resolve_key(self, name: str) -> str:
        if name in self._entries:
            return name
        if name in self._aliases:
            return self._aliases[name]
        known = sorted(set(self._entries) | set(self._aliases))
        raise RegistryError(
            f"unknown model {name!r} (known: {', '.join(known) or 'none'})")

    def get(self, name: str) -> Entry:
        try:
            key = self.resolve_key(name)
        except RegistryError:
            self.misses += 1
            raise
        self.hits += 1
        return self._entries[key]

    def keys(self) -> list:
        return list(self._entries)

    def stats(self) -> dict:
        return {
            "models": len(self._entries),
            "bytes": sum(e.nbytes for e in self._entries.values()),
            "hits": self.hits,
            "misses": self.misses,
            "aliases": dict(sorted(self._aliases.items())),
            "entries": [e.describe() for e in self._entries.values()],
        }

    def score(self, entry: Entry, dataset, days: np.ndarray,
              stochastic: Optional[bool] = False, seed: int = 0) -> np.ndarray:
        """(len(days), N_max) scores of one entry: `eval.predict.predict_panel`."""
        from factorvae_tpu_torch.eval.predict import predict_panel

        out = predict_panel(entry.model, entry.config, dataset, days,
                            stochastic=stochastic, seed=seed)
        entry.requests += 1
        return out
