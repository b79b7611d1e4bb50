"""Registry of resident scoring models (`factorvae_tpu/serve/registry.py`,
minimal).

An entry is keyed by the canonical hash of its Config (`config.config_hash`),
suffixed `:{precision}` below float32, and may carry an alias. `admit` takes
an in-memory model with its Config, or a weights directory written by
`params.save_weights`, at one rung of the precision ladder: float32,
bfloat16 (float32 weights, the extractor computing in bfloat16) or int8
(weights quantized once at admission, `ops/quant.py`, dequantized for each
scoring call; float32 activations). An int8 entry keeps only the quantized
weights resident. AOT artifacts, byte budgets, eviction and cold starts of
the JAX registry are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from factorvae_tpu_torch.config import Config, config_hash
from factorvae_tpu_torch.ops.kernels import hidden_refusal
from factorvae_tpu_torch.ops.quant import ensure_quantized, tree_nbytes

PRECISIONS = ("float32", "bfloat16", "int8")


class RegistryError(ValueError):
    """Admission or lookup failure with a one-line message."""


def precision_config(config: Config, precision: str) -> Config:
    """The Config an entry scores under at one rung: float32 and bfloat16
    set the activations' compute dtype; int8 keeps float32 activations (the
    quantization is on the weights)."""
    if precision not in PRECISIONS:
        raise RegistryError(f"precision must be one of {PRECISIONS}; got {precision!r}")
    dtype = "float32" if precision == "int8" else precision
    return dataclasses.replace(config, model=dataclasses.replace(config.model,
                                                                 compute_dtype=dtype))


@dataclasses.dataclass
class Entry:
    key: str
    config: Config
    model: torch.nn.Module               # int8: the structure, on the meta device
    alias: Optional[str] = None
    source: str = "params"               # params | weights
    nbytes: int = 0
    requests: int = 0
    precision: str = "float32"
    score_config: Optional[Config] = None
    qparams: Optional[dict] = None       # int8: the quantized weights

    def describe(self) -> dict:
        m = self.config.model
        return {"key": self.key, "alias": self.alias, "source": self.source,
                "precision": self.precision, "nbytes": self.nbytes,
                "requests": self.requests,
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
              alias: Optional[str] = None, precision: str = "float32") -> str:
        """Admit a model (with its `config`) or a weights directory at
        `precision` (one of PRECISIONS); returns the key. Re-admitting a key
        replaces its entry. On a CUDA device a hidden size above the
        kernels' maximum is refused before any weights are read."""
        from factorvae_tpu_torch.models.factorvae import (
            FactorVAE,
            load_model,
            with_compute_dtype,
        )
        from factorvae_tpu_torch.params import read_config

        if precision not in PRECISIONS:
            raise RegistryError(f"precision must be one of {PRECISIONS}; got {precision!r}")
        if isinstance(source, torch.nn.Module):
            if config is None:
                raise RegistryError("an in-memory model needs its Config")
            refused = hidden_refusal(config.model.hidden_size, self.device)
            if refused:
                raise RegistryError(refused)
            model, kind = source, "params"
        else:
            path = os.path.abspath(str(source))
            if not os.path.isdir(path):
                raise RegistryError(f"no weights directory at {path}")
            config = config or read_config(path)
            refused = hidden_refusal(config.model.hidden_size, self.device)
            if refused:
                raise RegistryError(refused)
            model = load_model(config, checkpoint_path=path, device=self.device)
            kind = "weights"
            alias = alias or os.path.basename(path)
        key = config_hash(config.to_dict())
        if precision != "float32":
            key = f"{key}:{precision}"
        score_config = precision_config(config, precision)
        qparams = None
        if precision == "int8":
            qparams = ensure_quantized(model)
            with torch.device("meta"):       # the structure only, no weights
                model = FactorVAE(score_config.model)
        else:               # shares the weights; computes in the rung's dtype
            model = with_compute_dtype(model, score_config.model.compute_dtype)
        nbytes = tree_nbytes(qparams if qparams is not None else model)
        self._entries[key] = Entry(key=key, config=config, model=model.eval(),
                                   alias=alias, source=kind, nbytes=int(nbytes),
                                   precision=precision, score_config=score_config,
                                   qparams=qparams)
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

        out = predict_panel(entry.model, entry.score_config, dataset, days,
                            stochastic=stochastic, seed=seed,
                            int8=entry.precision == "int8", params=entry.qparams)
        entry.requests += 1
        return out
