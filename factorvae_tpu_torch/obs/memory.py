"""Device-memory watermarks and the static shard balance (`factorvae_tpu/obs/memory.py`).

`device_memory_stats` reads the caching allocator of every visible card
(`torch.cuda.memory_stats`: `allocated_bytes.all.current` as
`bytes_in_use`, `allocated_bytes.all.peak` as `peak_bytes_in_use`, the
card's total memory as `bytes_limit`). `watermark_event` writes one
`memory` mark with them onto the installed timeline; the trainers call it
once per epoch. On the CPU, or without a timeline, both are no-ops, as in
the JAX package. Observation only.

The static shard balance (`shard_balance`, `shard_balance_block`) is the
rule tables' per-rank byte bill (`parallel/partition.device_bytes`): the
train state's and the panel's bytes on each rank of a mesh and their
imbalance, read from shapes alone; the trainers log it once as their
`shard_balance` record.
"""

from __future__ import annotations

from typing import Optional

import torch

from factorvae_tpu_torch.utils.logging import current_timeline

__all__ = ["device_memory_stats", "shard_balance", "shard_balance_block",
           "watermark_event"]


def shard_balance(mesh, specs, tree) -> dict:
    """Per-rank byte bill of `tree` placed per `specs`:
    {total_bytes, min/max/mean bytes_per_device, imbalance_frac}."""
    import numpy as np

    from factorvae_tpu_torch.parallel.partition import device_bytes

    per = device_bytes(mesh, specs, tree).reshape(-1)
    hi = int(per.max()) if per.size else 0
    lo = int(per.min()) if per.size else 0
    return {
        "total_bytes": int(per.sum()),
        "bytes_per_device_max": hi,
        "bytes_per_device_min": lo,
        "bytes_per_device_mean": float(np.mean(per)) if per.size else 0.0,
        "imbalance_frac": round((hi - lo) / hi, 4) if hi else 0.0,
    }


def _panel_tree(dataset) -> Optional[dict]:
    """The whole (n_max-row) {values, last_valid, next_valid} of a
    PanelDataset, as shapes and dtypes (whatever the residency, and before
    or after `shard_dataset` kept this rank's rows)."""
    import numpy as np

    if dataset.residency == "stream":
        arrs = [dataset.values_np, dataset.last_valid_np, dataset.next_valid_np]
        return dict(zip(("values", "last_valid", "next_valid"), arrs))
    v, lv = dataset.values, dataset.last_valid
    n = dataset.n_max
    return {"values": np.empty((n,) + tuple(v.shape[1:]), np.float32),
            "last_valid": np.empty((lv.shape[0], n), np.int64),
            "next_valid": np.empty((lv.shape[0], n), np.int64)}


def shard_balance_block(mesh, state=None, dataset=None, stacked: bool = False) -> dict:
    """The one JSON-ready block the trainers log: a `state` bill from
    TRAIN_STATE_RULES / FLEET_STATE_RULES (a `partition.state_tree`) and a
    `panel` bill from PANEL_RULES, per rank. A stream-resident dataset's
    panel never lives on the card; its bill carries `residency`."""
    from factorvae_tpu_torch.parallel import partition

    block: dict = {
        "mesh": {str(n): int(s) for n, s in mesh.shape.items()},
        "devices": int(mesh.devices.size),
    }
    if state is not None:
        specs = partition.state_partition_specs(state, stacked=stacked)
        block["state"] = shard_balance(mesh, specs, state)
    if dataset is not None:
        tree = _panel_tree(dataset)
        specs = dict(zip(("values", "last_valid", "next_valid"),
                         partition.panel_partition_specs()))
        block["panel"] = shard_balance(mesh, specs, tree)
        block["panel"]["residency"] = dataset.residency
    return block


def device_memory_stats() -> Optional[list]:
    """[{device, bytes_in_use, peak_bytes_in_use, bytes_limit}, ...] of the
    visible cards, or None without one. Never raises."""
    try:
        if not torch.cuda.is_available():
            return None
        out = []
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out.append({
                "device": f"cuda:{i}",
                "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
            })
        return out or None
    except Exception:       # noqa: BLE001 - observation never fails the caller
        return None


def watermark_event(**fields) -> bool:
    """One `memory` mark with the cards' watermarks on the installed
    timeline; False (and nothing written) without a timeline or a card."""
    tl = current_timeline()
    if tl is None:
        return False
    stats = device_memory_stats()
    if stats is None:
        return False
    peak = max((s.get("peak_bytes_in_use") or 0) for s in stats)
    tl.event("memory", cat="memory", resource="memory", devices=stats,
             peak_bytes_in_use=peak, **fields)
    return True
