"""Weights carried across from the JAX package, and the port's own files.

`flax_to_torch` maps a Flax parameter tree (numpy leaves, with or without
the outer `{'params': {'model': ...}}` levels that the JAX `load_model`
returns) to the `state_dict` of `models.factorvae.FactorVAE`;
`torch_to_flax` is its inverse. The leaf map:

  .../<dense>/Dense_0/kernel (in, out)   <-> <dense>.weight (out, in)
  .../<dense>/Dense_0/bias               <-> <dense>.bias
  feature_extractor/LayerNorm_0/scale    <-> feature_extractor.layer_norm.weight
  feature_extractor/LayerNorm_0/bias     <-> feature_extractor.layer_norm.bias
  every other leaf (GRU hidden_kernel/hidden_bias with their [r|z|n] gate
  blocks, the predictor's stacked (K,H,H)/(K,H) leaves)  <-> same name

A stacked GRU's nested levels (`feature_extractor/gru/layer_{i}/...`) map
level for level to `feature_extractor.gru.layer_{i}....`.

Every leaf is used exactly once: two leaves that map to one key raise here,
and a tree that does not cover the model's state_dict exactly is refused by
the strict `load_state_dict`.

`save_weights` writes `weights.pt` and `serve_config.json` (the drop-in
name the JAX serving registry also reads) into one directory, then the
sibling manifest `<dir>.manifest.json` (sha256 of both files) that
`train.checkpoint.verify_params_dir` checks before the registry loads them.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping

import numpy as np
import torch

from factorvae_tpu_torch.config import Config

WEIGHTS_FILE = "weights.pt"
CONFIG_FILE = "serve_config.json"
_OUTER = ("params", "model")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _strip_outer(tree):
    for level in _OUTER:
        if isinstance(tree, Mapping) and set(tree) == {level}:
            tree = tree[level]
    return tree


def flax_to_torch(tree) -> dict:
    """Flax parameter tree -> FactorVAE state_dict (CPU float32 tensors)."""
    out = {}
    for path, leaf in _flatten(_strip_outer(tree)):
        arr = np.asarray(leaf, dtype=np.float32)
        path = list(path)
        if len(path) >= 2 and path[-2] == "Dense_0":
            if path[-1] == "kernel":
                arr = arr.T
                path[-1] = "weight"
            del path[-2]
        elif len(path) >= 2 and path[-2] == "LayerNorm_0":
            path[-2] = "layer_norm"
            if path[-1] == "scale":
                path[-1] = "weight"
        key = ".".join(path)
        if key in out:
            raise ValueError(f"two Flax leaves map to {key!r}")
        out[key] = torch.from_numpy(np.array(arr, order="C"))   # a writable copy
    return out


def torch_to_flax(state_dict, outer=_OUTER) -> dict:
    """FactorVAE state_dict -> Flax tree of numpy arrays, wrapped in the
    `outer` levels ({'params': {'model': ...}} by default)."""
    tree: dict = {}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        path = key.split(".")
        if path[-2] == "layer_norm":
            path[-2] = "LayerNorm_0"
            if path[-1] == "weight":
                path[-1] = "scale"
        elif path[-1] in ("weight", "bias"):
            if path[-1] == "weight":
                arr = arr.T
                path[-1] = "kernel"
            path.insert(len(path) - 1, "Dense_0")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    for level in reversed(outer):
        tree = {level: tree}
    return tree


def save_weights(model: torch.nn.Module, config: Config, path: str) -> str:
    os.makedirs(path, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(path, WEIGHTS_FILE))
    with open(os.path.join(path, CONFIG_FILE), "w") as fh:
        json.dump(config.to_dict(), fh, indent=1)
    from factorvae_tpu_torch.train.checkpoint import write_params_manifest

    write_params_manifest(path)
    return path


def read_state_dict(path: str) -> dict:
    return torch.load(os.path.join(path, WEIGHTS_FILE), map_location="cpu",
                      weights_only=True)


def read_config(path: str) -> Config:
    with open(os.path.join(path, CONFIG_FILE)) as fh:
        return Config.from_dict(json.load(fh))
