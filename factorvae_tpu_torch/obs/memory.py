"""Device-memory watermarks (`factorvae_tpu/obs/memory.py`, in part).

`device_memory_stats` reads the caching allocator of every visible card
(`torch.cuda.memory_stats`: `allocated_bytes.all.current` as
`bytes_in_use`, `allocated_bytes.all.peak` as `peak_bytes_in_use`, the
card's total memory as `bytes_limit`). `watermark_event` writes one
`memory` mark with them onto the installed timeline; the trainers call it
once per epoch. On the CPU, or without a timeline, both are no-ops, as in
the JAX package. Observation only.

The JAX module's static shard balance (`shard_balance`,
`shard_balance_block`) reads the mesh's partition rules, which come with
the parallelism of ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

from typing import Optional

import torch

from factorvae_tpu_torch.utils.logging import current_timeline

__all__ = ["device_memory_stats", "watermark_event"]


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
