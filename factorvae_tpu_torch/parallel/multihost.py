"""Process wiring (`factorvae_tpu/parallel/multihost.py`).

One process per device: `torchrun` (`python -m torch.distributed.run`)
starts the ranks and sets `RANK`, `WORLD_SIZE`, `LOCAL_RANK` and
`MASTER_ADDR`/`MASTER_PORT`; `maybe_initialize` then joins them into one
process group, after which `mesh.make_mesh` spans the world. Every rank
builds the same host panel and derives the same day order from the seed,
then keeps its own slice (`global_put`), so no input pipeline diverges.

The backend is the caller's or the device's: NCCL where each rank has its
own card, gloo on the CPU. Gloo on CUDA tensors (several ranks sharing one
card, which NCCL refuses) is used only when the caller names it, and then
the collectives of `collective_ops.py` keep to what gloo does on CUDA
(all-reduce and broadcast). No backend is chosen by catching another's
failure.

Usage:
    from factorvae_tpu_torch.parallel.multihost import maybe_initialize
    maybe_initialize()            # no-op without torchrun's environment
    # ... build the mesh as usual
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def in_multihost_env() -> bool:
    """True when a torchrun-style environment (`RANK`, `WORLD_SIZE` and
    `MASTER_ADDR`) is present."""
    return all(os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def default_backend(device) -> str:
    """NCCL for a CUDA device (one card per rank), gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device) -> torch.device:
    """This rank's device: under NCCL `cuda:LOCAL_RANK`, else `device` as
    given (gloo ranks may share one card)."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def maybe_initialize(backend: Optional[str] = None, device="cuda",
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> bool:
    """Initialize the default process group when configured; returns True
    if it ran (or had run). With no arguments and no torchrun environment
    it is a no-op, safe to call unconditionally. `backend` defaults to
    `default_backend(device)`; under NCCL the rank's card is set current."""
    if dist.is_initialized():
        return True
    if init_method is None and not in_multihost_env():
        return False
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: choose from {BACKENDS}")
    kwargs = {"backend": backend}
    if init_method is not None:
        kwargs["init_method"] = init_method
    if world_size is not None:
        kwargs["world_size"] = int(world_size)
    if rank is not None:
        kwargs["rank"] = int(rank)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0)))
    dist.init_process_group(**kwargs)
    return True


def _slice_of(dim: int, k: int, i: int) -> slice:
    """Shard i of k of a dimension of `dim`: ceil(dim / k) rows each, the
    tail what is left (`partition._dim_shard_sizes`)."""
    per = -(-dim // k)
    lo = min(dim, i * per)
    return slice(lo, min(dim, lo + per))


def global_put(x, mesh, spec):
    """This rank's slice of `x`, identical host (or device) data on every
    rank, per `spec` (`partition.P`): each dimension named with mesh axes
    keeps this rank's shard along them, the rest stays whole. A tensor
    stays a tensor (a view), a numpy array a numpy array."""
    index = []
    for d in range(len(getattr(x, "shape", ()))):
        axes = spec[d] if d < len(spec) else None
        if axes is None:
            index.append(slice(None))
            continue
        names = axes if isinstance(axes, (tuple, list)) else (axes,)
        k, li = 1, 0
        for nm in names:
            pos = mesh.axis_names.index(nm)
            k *= mesh.devices.shape[pos]
            li = li * mesh.devices.shape[pos] + mesh.coords[pos]
        index.append(_slice_of(int(x.shape[d]), k, li))
    return x[tuple(index)] if index else x


def process_info() -> dict:
    """Rank layout for logging."""
    init = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if init else 0,
        "process_count": dist.get_world_size() if init else 1,
        "local_devices": 1,
        "global_devices": dist.get_world_size() if init else 1,
        "backend": dist.get_backend() if init else None,
        "local_rank": int(os.environ.get("LOCAL_RANK", "0")),
    }


def host_array(x) -> np.ndarray:
    """`x` as host numpy."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
