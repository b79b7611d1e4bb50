"""Rank meshes over `torch.distributed` (`factorvae_tpu/parallel/mesh.py`).

A mesh is a grid of ranks, one process per device, with a process group
for each axis:

- 'data'  — trading days: each rank takes a slice of every update's day
  batch, and the gradients are averaged over the world
  (`train/loop.py`); a fleet lays its seed lanes over it instead.
- 'stock' — the cross-section: each rank holds N / sp rows of the panel
  and of every per-stock activation; the cross-stock reductions (the
  portfolio softmax and matvec, the loss means) and the predictor's
  gather are the explicit collectives of `collective_ops.py`.
- 'host'  — the outer axis of a hierarchical mesh: ranks of one host stay
  in one row, so the 'stock' groups never leave a host.

Where the JAX package lets GSPMD insert its collectives, the port writes
every one itself, over the groups this module makes. Every rank builds the
same mesh: `dist.new_group` is collective, so each rank creates every
group of every axis in the same order and keeps the ones it belongs to.
Without an initialized process group the mesh is 1 x 1 over rank 0 and
has no groups: every collective is the identity.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

from factorvae_tpu_torch.config import MeshConfig

DATA_AXIS = "data"
STOCK_AXIS = "stock"
HOST_AXIS = "host"


class Axis:
    """One axis (or a product of axes) of a mesh as this rank sees it: its
    `name`, `size`, this rank's `index` along it, the world ranks of this
    rank's group (`ranks`, in index order) and the process `group` (None
    when the axis has one rank, or the world is not initialized)."""

    def __init__(self, name: str, ranks: Sequence[int], index: int, group):
        self.name = name
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = int(index)
        self.group = group

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"


def _world() -> tuple:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A grid of world ranks (`devices`, the JAX mesh's device array) with
    `axis_names` and `shape` (name -> size, in axis order), this rank's
    `coords`, and an `Axis` for each axis, for the batch axes together
    (`axis(name)`, `batch_axis()`), for every rank (`axis("world")`) and
    for any product of axes (`axes(*names)`)."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"a {ranks.ndim}-d rank grid needs {ranks.ndim} axis names; "
                             f"got {tuple(axis_names)}")
        self.devices = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in ranks.shape)))
        self.rank, world = _world()
        if sorted(ranks.reshape(-1).tolist()) != list(range(world)):
            raise ValueError(f"a mesh of {ranks.size} ranks over a world of {world}: "
                             "every rank of the world must sit in the mesh once")
        self.coords = tuple(int(c) for c in np.argwhere(ranks == self.rank)[0])
        # an Axis for every product of axes, made in one order on every rank
        self._by_dims = {dims: self._make_axis(dims)
                         for k in range(1, ranks.ndim + 1)
                         for dims in itertools.combinations(range(ranks.ndim), k)}
        axes = {name: self._by_dims[(i,)] for i, name in enumerate(self.axis_names)}
        axes["batch"] = self.axes(*batch_axes(self))
        axes["world"] = self._by_dims[tuple(range(ranks.ndim))]
        self._axes = axes       # read-only once built

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _make_axis(self, dims: tuple) -> Axis:
        """The Axis over `dims` (mesh dimensions, in order) that holds this
        rank, creating every group of that product on every rank."""
        moved = np.moveaxis(self.devices, dims, tuple(range(-len(dims), 0)))
        k = int(np.prod([self.devices.shape[d] for d in dims]))
        lines = moved.reshape(-1, k)
        mine = next(line for line in lines if self.rank in line)
        group = None
        if k > 1:
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    group = g
        name = "/".join(self.axis_names[d] for d in dims)
        return Axis(name, mine.tolist(), mine.tolist().index(self.rank), group)

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    def axes(self, *names: str) -> Axis:
        """The Axis over the product of the named axes (in mesh order,
        named like "host/stock")."""
        return self._by_dims[tuple(sorted(self.axis_names.index(n) for n in names))]

    def batch_axis(self) -> Axis:
        """The axes that shard the day batch together (`batch_axes`)."""
        return self._axes["batch"]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def make_mesh(cfg: Optional[MeshConfig] = None, devices: Optional[Sequence] = None) -> Mesh:
    """The ('data', 'stock') mesh of `cfg` over `devices` (world ranks;
    default every rank of the world, in order)."""
    cfg = cfg or MeshConfig()
    devices = list(devices if devices is not None else range(_world()[1]))
    shape = cfg.shape(len(devices))
    return Mesh(np.asarray(devices).reshape(shape), (DATA_AXIS, STOCK_AXIS))


def single_device_mesh() -> Mesh:
    """The 1 x 1 mesh of a world of one rank."""
    return Mesh(np.zeros((1, 1), np.int64), (DATA_AXIS, STOCK_AXIS))


def make_hierarchical_mesh(
    cfg: Optional[MeshConfig] = None,
    devices: Optional[Sequence] = None,
    num_hosts: Optional[int] = None,
) -> Mesh:
    """3-axis ('host', 'data', 'stock') mesh: each host's ranks stay
    contiguous in one row, so a 'stock' group never leaves a host while the
    gradient's all-reduce over ('host', 'data') crosses them.

    `num_hosts` defaults to the world size over torchrun's
    `LOCAL_WORLD_SIZE` (ranks per host); pass it to simulate host
    boundaries in a test."""
    import os

    cfg = cfg or MeshConfig()
    devices = list(devices if devices is not None else range(_world()[1]))
    if num_hosts is None:
        per = int(os.environ.get("LOCAL_WORLD_SIZE", len(devices)) or len(devices))
        num_hosts = max(1, len(devices) // max(1, per))
    if len(devices) % num_hosts:
        raise ValueError(
            f"{len(devices)} devices not divisible by num_hosts={num_hosts}"
        )
    per_host = len(devices) // num_hosts
    sp = cfg.stock_axis
    if per_host % sp:
        raise ValueError(
            f"per-host device count {per_host} not divisible by "
            f"stock_axis={sp}; the 'stock' groups must fit inside one "
            f"host's ICI domain"
        )
    if cfg.data_axis > 0 and cfg.data_axis != num_hosts * (per_host // sp):
        raise ValueError(
            f"MeshConfig.data_axis={cfg.data_axis} conflicts with the "
            f"derived total data parallelism "
            f"{num_hosts} hosts x {per_host // sp} = "
            f"{num_hosts * (per_host // sp)}; leave it at -1 or match it"
        )
    arr = np.asarray(sorted(devices)).reshape(num_hosts, per_host // sp, sp)
    return Mesh(arr, (HOST_AXIS, DATA_AXIS, STOCK_AXIS))


def batch_axes(mesh) -> tuple:
    """The mesh axes that jointly shard the day-batch dimension:
    ('host', 'data') on a hierarchical mesh, ('data',) otherwise."""
    if HOST_AXIS in mesh.axis_names:
        return (HOST_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


def data_parallel_size(mesh) -> int:
    """Total day-level data parallelism (product of the batch axes)."""
    return int(np.prod([mesh.shape[a] for a in batch_axes(mesh)]))


class AbstractMesh:
    """A mesh's layout without its groups (`devices`, `axis_names`,
    `shape`): what `compose.validate`, `partition.device_bytes` and the
    shard-balance bill read, made without a process group (the planner's
    and the tests' meshes of a world this process is not part of)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str] = (DATA_AXIS,
                                                                          STOCK_AXIS)):
        self.devices = np.arange(int(np.prod(shape))).reshape(tuple(shape))
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return int(self.devices.size)
