"""Registry of resident scoring models (`factorvae_tpu/serve/registry.py`).

- **Keying.** An entry is keyed by the canonical hash of its Config
  (`config.config_hash`), suffixed `:{precision}` below float32, and may
  carry an alias.
- **Sources.** `register_params` admits an in-memory model (or its
  state_dict) with its Config; `register_checkpoint` a weights directory
  written by `params.save_weights` (Config from its `serve_config.json`),
  after `train.checkpoint.verify_params_dir` checks it against its sibling
  manifest: a directory that fails is refused with a `serve_quarantine`
  mark (a cold start goes through the same check), one without a manifest
  admits unverified.
  `admit` is the thin front over both. `register_artifact` admits an AOT
  artifact (`eval/export_aot.py`, a `torch.export` program) keyed by its
  header's config hash; its sha256 gate runs before anything is
  deserialized. An artifact entry scores day by day, one exported call per
  day (`_score_artifact`), and never joins a fused dispatch.
- **Precision ladder.** float32, bfloat16 (float32 weights, the extractor
  computing in bfloat16) or int8 (weights quantized once at admission,
  `ops/quant.py`, dequantized for each scoring call; float32 activations).
  An int8 entry keeps only the quantized weights resident. The rung is the
  caller's choice, else the matched plan row's `serve` block for the
  entry's shape, the panel width given as `n_stocks` and this registry's
  device (`plan.py`; `plan_table=` a list of rows in place of the port's
  table), else float32.
- **Budget.** Eviction is LRU by parameter bytes against `budget_bytes` (0:
  unbounded). An evicted entry from a weights directory or an artifact file
  leaves a tombstone, and the next `get` cold-starts it from disk, retrying `COLD_RETRIES`
  times with exponential backoff; a failed cold start answers every later
  request with a RegistryError and keeps its tombstone. In-memory entries
  are gone when evicted, and their aliases with them.
- **Identity.** `digest` is the sha256 of the serving weights. Re-admitting
  other bytes under a key bumps its `generation` and retires (tombstones)
  its sibling rungs, which were made from the old bytes; the same bytes
  refresh the entry in place. `version` moves on every admission,
  eviction, retirement and alias flip (the daemon's stacked-weights cache
  keys on it).
- **Warmth.** `compiled` / `compile_s` mark an entry's first scoring call,
  which pays the kernels' first load; `warmup` makes that call up front.

The chaos hooks: `serve_stall` in `score`, `serve_cold_fail` in a cold
start.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import Mapping, Optional, Union

import numpy as np
import torch

from factorvae_tpu_torch.chaos import fault as chaos_fault
from factorvae_tpu_torch.config import Config, config_hash
from factorvae_tpu_torch.ops.kernels import hidden_refusal
from factorvae_tpu_torch.ops.quant import QTensor, ensure_quantized, tree_nbytes
from factorvae_tpu_torch.utils.logging import timeline_event, timeline_span

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


def checkpoint_config(path: str) -> Config:
    """The Config of a weights directory (its `serve_config.json`)."""
    from factorvae_tpu_torch.params import CONFIG_FILE, read_config

    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, CONFIG_FILE)):
        raise RegistryError(
            f"cannot resolve the Config for weights directory {path}: no "
            f"{CONFIG_FILE} (params.save_weights writes one beside the weights)")
    return read_config(path)


def _digest(tree: Mapping) -> str:
    """sha256 over the serving tree's tensors in name order."""
    h = hashlib.sha256()
    for name in sorted(tree):
        v = tree[name]
        for t in ((v.q, v.s) if isinstance(v, QTensor) else (v,)):
            arr = t.detach().cpu().contiguous()
            h.update(name.encode() + str(arr.dtype).encode() + str(tuple(arr.shape)).encode())
            h.update(arr.view(torch.uint8).numpy().tobytes() if arr.numel() else b"")
    return h.hexdigest()


@dataclasses.dataclass
class Entry:
    """One resident model: `model` computes in the rung's dtype (int8: the
    structure alone, on the meta device, beside `qparams`); `score_config`
    carries the rung's compute dtype."""

    key: str
    config: Optional[Config]              # None for an artifact
    model: Optional[torch.nn.Module]      # None for an artifact
    alias: Optional[str] = None
    source: str = "params"                # params | checkpoint | artifact
    source_path: Optional[str] = None     # reload origin of a cold start
    nbytes: int = 0
    requests: int = 0
    precision: str = "float32"
    score_config: Optional[Config] = None
    qparams: Optional[dict] = None        # int8: the quantized weights
    compiled: bool = False                # first scoring call made
    compile_s: Optional[float] = None
    digest: Optional[str] = None
    generation: int = 1
    artifact: Optional[object] = None     # eval.export_aot.LoadedArtifact

    @property
    def int8(self) -> bool:
        return self.precision == "int8"

    @property
    def params(self) -> dict:
        """The serving tree: name -> tensor, QTensors for int8."""
        if self.qparams is not None:
            return self.qparams
        return {n: t.detach() for n, t in self.model.state_dict().items()}

    def describe(self) -> dict:
        if self.artifact is not None:     # the header knows the call's shape only
            h = self.artifact.header
            arch = {"c": h["num_features"], "t": h["seq_len"], "n_max": h["n_max"]}
        else:
            m = self.config.model
            arch = {"c": m.num_features, "t": m.seq_len, "h": m.hidden_size,
                    "k": m.num_factors, "m": m.num_portfolios}
        return {"key": self.key, "alias": self.alias, "precision": self.precision,
                "source": self.source, "nbytes": self.nbytes, "compiled": self.compiled,
                "compile_s": self.compile_s, "requests": self.requests,
                "generation": self.generation, "arch": arch}


class ModelRegistry:
    """LRU-by-bytes registry of the models a daemon scores with, on `device`."""

    COLD_RETRIES = 2
    COLD_BACKOFF_S = 0.05

    def __init__(self, device="cuda", budget_bytes: int = 0, plan_table=None):
        self.device = torch.device(device)
        self.budget_bytes = int(budget_bytes)
        self._plan_table = plan_table
        # admission, lookup, eviction and the tallies; re-entrant because a
        # cold start's register_checkpoint re-enters through _admit. Disk
        # reloads and backoff sleeps run outside it.
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, Entry]" = OrderedDict()
        self._aliases: dict = {}
        self._tombstones: dict = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.cold_starts = 0
        self.readmissions = 0
        self.version = 0

    # ---- admission -------------------------------------------------------

    def _admit(self, entry: Entry) -> str:
        with self._lock:
            self.version += 1
            prev = self._entries.get(entry.key)
            if prev is not None:
                if prev.digest != entry.digest:
                    # other bytes under the same key: a new generation, and
                    # the sibling rungs made from the old bytes retire
                    entry.generation = prev.generation + 1
                    self.readmissions += 1
                    stale = self._retire_siblings_locked(entry.key)
                    timeline_event("registry_readmit", cat="serve", resource="serve",
                                   model=entry.key, generation=entry.generation,
                                   stale_siblings=stale)
                else:
                    entry.generation = prev.generation
            self._entries[entry.key] = entry
            self._entries.move_to_end(entry.key)
            self._tombstones.pop(entry.key, None)
            if entry.alias:
                self._aliases[entry.alias] = entry.key
            self._evict_to_budget()
            return entry.key

    def _retire_siblings_locked(self, key: str) -> list:
        base = key.split(":", 1)[0]
        stale = [k for k in self._entries if k != key and k.split(":", 1)[0] == base]
        for k in stale:
            self.version += 1
            self._tombstone_or_drop(k, self._entries.pop(k))
        return stale

    def _tombstone_or_drop(self, key: str, entry: Entry) -> None:
        """After `entry` left `_entries`: a weights-directory source leaves a
        tombstone; an in-memory one takes its aliases with it."""
        if entry.source_path:
            self._tombstones[key] = {"source": entry.source,
                                     "source_path": entry.source_path,
                                     "precision": entry.precision,
                                     "config": entry.config, "alias": entry.alias}
        else:
            for alias, k in list(self._aliases.items()):
                if k == key:
                    del self._aliases[alias]

    def _resolve_precision(self, config: Config, precision: Optional[str],
                           n_stocks: Optional[int]) -> str:
        """Explicit choice > the plan row's serve block > float32 (the only
        honest answer without a width to look the row up at)."""
        if precision is not None:
            if precision not in PRECISIONS:
                raise RegistryError(f"precision must be one of {PRECISIONS}; "
                                    f"got {precision!r}")
            return precision
        if n_stocks:
            from factorvae_tpu_torch import plan as planlib

            return planlib.plan_for_config(config, int(n_stocks), platform=self.device.type,
                                           table=self._plan_table).serve_precision
        return "float32"

    def register_params(self, params: Union[torch.nn.Module, Mapping], config: Config,
                        precision: Optional[str] = None, n_stocks: Optional[int] = None,
                        alias: Optional[str] = None, source: str = "params",
                        source_path: Optional[str] = None) -> str:
        """Admit an in-memory model (a FactorVAE on this registry's device,
        or a state_dict loaded into one) with its Config; returns the key.
        The rung is `precision`, else the plan row's at width `n_stocks`,
        else float32. On a CUDA device a hidden size above the kernels'
        maximum is refused."""
        from factorvae_tpu_torch.models.factorvae import FactorVAE, with_compute_dtype

        if config is None:
            raise RegistryError("an in-memory model needs its Config")
        precision = self._resolve_precision(config, precision, n_stocks)
        refused = hidden_refusal(config.model.hidden_size, self.device)
        if refused:
            raise RegistryError(refused)
        if isinstance(params, torch.nn.Module):
            model = params
        else:
            model = FactorVAE(config.model)
            model.load_state_dict(params)
            model = model.to(self.device)
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
        model = model.eval()
        entry = Entry(key=key, config=config, model=model, alias=alias, source=source,
                      source_path=source_path, precision=precision,
                      score_config=score_config, qparams=qparams)
        entry.nbytes = int(tree_nbytes(qparams if qparams is not None else model))
        entry.digest = _digest(entry.params)
        return self._admit(entry)

    def register_checkpoint(self, path: str, config: Optional[Config] = None,
                            precision: Optional[str] = None,
                            n_stocks: Optional[int] = None,
                            alias: Optional[str] = None) -> str:
        """Admit a weights directory (`params.save_weights` layout); alias
        defaults to the directory's name. The manifest check and the
        hidden-size refusal come before any weights are loaded."""
        from factorvae_tpu_torch.models.factorvae import load_model

        from factorvae_tpu_torch.train.checkpoint import verify_params_dir

        path = os.path.abspath(str(path))
        if not os.path.isdir(path):
            raise RegistryError(f"no weights directory at {path}")
        bad = verify_params_dir(path)
        if bad is not None:
            timeline_event("serve_quarantine", cat="recovery", resource="serve",
                           path=path, reason=bad)
            raise RegistryError(
                f"checkpoint {path} failed manifest verification ({bad}) — the weights "
                "on disk are not the bytes save_params wrote; re-export from the "
                "full-state checkpoint or retrain")
        config = config or checkpoint_config(path)
        refused = hidden_refusal(config.model.hidden_size, self.device)
        if refused:
            raise RegistryError(refused)
        model = load_model(config, checkpoint_path=path, device=self.device)
        return self.register_params(model, config, precision=precision, n_stocks=n_stocks,
                                    alias=alias or os.path.basename(path),
                                    source="checkpoint", source_path=path)

    def register_artifact(self, path_or_blob, alias: Optional[str] = None,
                          expected_sha256: Optional[str] = None) -> str:
        """Admit an AOT artifact (a file, or its bytes) through
        `export_aot.load_exported`, moved to this registry's device; the key
        is the header's config hash (`:int8` for an int8 artifact), the alias
        defaults to the file's name. With `expected_sha256` (a remote worker
        passes the artifact service's content address), bytes that hash to
        anything else are refused before they are deserialized."""
        from factorvae_tpu_torch.eval.export_aot import ArtifactError, load_exported

        path = None
        if isinstance(path_or_blob, (bytes, bytearray)):
            blob = bytes(path_or_blob)
        else:
            path = os.path.abspath(str(path_or_blob))
            with open(path, "rb") as fh:
                blob = fh.read()
        digest = hashlib.sha256(blob).hexdigest()
        if expected_sha256 is not None and digest != expected_sha256:
            timeline_event("serve_quarantine", cat="recovery", resource="serve",
                           path=path or "<bytes>", reason="artifact sha256 mismatch")
            raise RegistryError(
                f"artifact {path or '<bytes>'} hashes to {digest[:12]}… but the store "
                f"advertised {expected_sha256[:12]}…: the bytes are corrupt; re-fetch "
                "from the artifact service (GET /artifact/<sha256>)")
        try:
            art = load_exported(blob, device=self.device)
        except ArtifactError as e:
            raise RegistryError(str(e)) from None
        precision = "int8" if art.header.get("int8") else "float32"
        key = str(art.header["config_hash"])
        if precision != "float32":
            key = f"{key}:{precision}"
        entry = Entry(key=key, config=None, model=None, precision=precision,
                      artifact=art, nbytes=len(blob), source="artifact", source_path=path,
                      alias=alias or (os.path.basename(path) if path else None),
                      digest=digest)
        return self._admit(entry)

    def admit(self, source, config: Optional[Config] = None, alias: Optional[str] = None,
              precision: str = "float32") -> str:
        """`register_params` for a model, `register_checkpoint` for a path."""
        if isinstance(source, (torch.nn.Module, Mapping)):
            return self.register_params(source, config, precision=precision, alias=alias)
        return self.register_checkpoint(source, config=config, precision=precision,
                                        alias=alias)

    # ---- lookup / eviction ----------------------------------------------

    def resolve_key(self, name: str) -> str:
        with self._lock:
            if name in self._entries or name in self._tombstones:
                return name
            if name in self._aliases:
                return self._aliases[name]
            known = sorted(set(self._entries) | set(self._aliases) | set(self._tombstones))
        raise RegistryError(
            f"unknown model {name!r} (known: {', '.join(known) or 'none'})")

    def get(self, name: str) -> Entry:
        """Entry by key or alias, LRU-touched. An evicted weights-directory
        entry cold-starts back in (a miss); an unknown name is a miss and a
        RegistryError."""
        with self._lock:
            try:
                key = self.resolve_key(name)
            except RegistryError:
                self.misses += 1
                raise
            entry = self._entries.get(key)
            if entry is not None:
                self.hits += 1
                self._entries.move_to_end(key)
                return entry
            stone = self._tombstones[key]
            self.misses += 1
        for attempt in range(self.COLD_RETRIES + 1):
            try:
                if chaos_fault("serve_cold_fail") is not None:
                    raise RuntimeError("chaos: injected cold-start reload failure")
                if stone["source"] == "artifact":
                    self.register_artifact(stone["source_path"], alias=stone["alias"])
                else:
                    self.register_checkpoint(stone["source_path"], config=stone["config"],
                                             precision=stone["precision"],
                                             alias=stone["alias"])
                break
            except RegistryError:
                raise           # deterministic: a retry cannot heal it
            except Exception as e:      # noqa: BLE001 - retried, then a RegistryError
                if attempt == self.COLD_RETRIES:
                    raise RegistryError(
                        f"cold-start of evicted model {name!r} from {stone['source']} "
                        f"{stone['source_path']} failed after {attempt + 1} attempts: "
                        f"{e}") from e
                timeline_event("cold_start_retry", cat="recovery", resource="serve",
                               model=key, attempt=attempt + 1, error=str(e))
                time.sleep(self.COLD_BACKOFF_S * (2 ** attempt))
        with self._lock:
            self.cold_starts += 1
            self._tombstones.pop(key, None)
            entry = self._entries.get(key)
        if entry is None:
            raise RegistryError(
                f"cold-started model {name!r} was evicted by a concurrent admission "
                "before it could serve; retry")
        return entry

    def _evict_to_budget(self) -> None:
        if self.budget_bytes <= 0:
            return
        while (len(self._entries) > 1
               and sum(e.nbytes for e in self._entries.values()) > self.budget_bytes):
            key, entry = self._entries.popitem(last=False)
            self.version += 1
            self.evictions += 1
            self._tombstone_or_drop(key, entry)

    def set_alias(self, alias: str, name: str) -> str:
        """Point `alias` at an entry (a promotion's flip); returns its key."""
        with self._lock:
            key = self.resolve_key(name)
            self._aliases[str(alias)] = key
            self.version += 1
            return key

    def retire(self, name: str) -> bool:
        """Remove an entry from the warm set (tombstoned when it has a
        source on disk). False, and nothing done, for a name already gone."""
        with self._lock:
            try:
                key = self.resolve_key(name)
            except RegistryError:
                return False
            entry = self._entries.pop(key, None)
            if entry is None:
                return False
            self.version += 1
            self._tombstone_or_drop(key, entry)
        timeline_event("registry_retire", cat="serve", resource="serve", model=key)
        return True

    def total_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"models": len(self._entries), "bytes": self.total_bytes(),
                    "budget_bytes": self.budget_bytes, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "cold_starts": self.cold_starts, "readmissions": self.readmissions,
                    "aliases": dict(sorted(self._aliases.items())),
                    "entries": [e.describe() for e in self._entries.values()]}

    # ---- scoring ---------------------------------------------------------

    def score(self, name, dataset, days: np.ndarray, stochastic: Optional[bool] = False,
              seed: int = 0, chunk: Optional[int] = None,
              entry: Optional[Entry] = None) -> np.ndarray:
        """(len(days), N_max) scores of one entry (by name, or the Entry
        itself): `eval.predict.predict_panel`, so the float32 rung is
        bitwise that path; an artifact entry calls its program day by day."""
        from factorvae_tpu_torch.eval.predict import predict_panel

        if isinstance(name, Entry):
            entry = name
        if entry is None:
            entry = self.get(name)
        stall = chaos_fault("serve_stall")
        if stall is not None:
            time.sleep(stall.delay_s)
        t0 = time.perf_counter()
        first = not entry.compiled
        kw = {} if chunk is None else {"chunk": int(chunk)}
        with timeline_span(f"serve_score:{entry.key}", cat="serve", resource="device",
                           model=entry.key, n_days=int(len(days))):
            if entry.artifact is not None:
                out = self._score_artifact(entry, dataset, days)
            else:
                out = predict_panel(entry.model, entry.score_config, dataset, days,
                                    stochastic=stochastic, seed=seed, int8=entry.int8,
                                    params=entry.qparams, **kw)
        if first:
            entry.compiled = True
            entry.compile_s = round(time.perf_counter() - t0, 6)
        entry.requests += 1
        return out

    @staticmethod
    def _score_artifact(entry: Entry, dataset, days: np.ndarray) -> np.ndarray:
        """One exported call per day (D = 1), on the dataset's windows (a
        stream dataset's one-day mini-panels)."""
        from factorvae_tpu_torch.eval.predict import _score_chunks

        n_max = int(entry.artifact.header["n_max"])
        if n_max != int(dataset.n_max):
            raise RegistryError(
                f"artifact {entry.alias or entry.key} was exported for n_max={n_max} "
                f"but the serving panel pads to {dataset.n_max}; re-export at this "
                "width or align --max_stocks")
        out = np.full((len(days), n_max), np.nan, np.float32)
        for c0, _, ds, day_idx in _score_chunks(dataset, np.asarray(days, np.int64), 1):
            x, _, mask = ds.gather(day_idx)
            out[c0] = entry.artifact.call(x, mask)[0].cpu().numpy()
        return out

    def warmup(self, dataset, names: Optional[list] = None,
               stochastic: Optional[bool] = False) -> dict:
        """One one-day scoring call for every (or each named) entry not yet
        warm; returns {key: compile_s}."""
        days = dataset.split_days(None, None)[:1]
        walls = {}
        with self._lock:
            keys = list(names or self._entries)
        for key in keys:
            entry = self.get(key)
            if entry.compiled:
                continue
            self.score(key, dataset, days, stochastic=stochastic)
            walls[entry.key] = entry.compile_s
        return walls
