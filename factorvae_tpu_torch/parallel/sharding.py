"""Placement on a mesh (`factorvae_tpu/parallel/sharding.py`).

Both placements come from the PANEL_RULES table of `partition.py`:

    panel values (N, D, C+1)   -> P('stock', None, None)   this rank's rows
    fill maps    (D, N)        -> P(None, 'stock')         this rank's columns

The day orders stay whole on every rank: the train step takes its rank's
days of each update (`train/loop.MeshStep`), and the parameters and the
optimizer state are replicated. Where GSPMD would then insert the
collectives, the port's steps call them (`collective_ops.py`).
"""

from __future__ import annotations

from typing import Callable

from factorvae_tpu_torch.parallel.multihost import global_put
from factorvae_tpu_torch.parallel.partition import panel_partition_specs, stock_slice


def shard_dataset(mesh, dataset) -> None:
    """Keep only this rank's stock rows of a PanelDataset's device panel, in
    place (`global_put` of the PANEL_RULES specs); `dataset.n_max` stays the
    whole cross-section and `dataset.stock_rows` records the slice.

    A stream-resident dataset holds no device panel: a no-op, and each
    prefetched mini-panel is sliced instead (`chunk_placement`)."""
    if dataset.residency == "stream" or getattr(dataset, "stock_rows", None) is not None:
        return
    v_s, lv_s, nv_s = panel_partition_specs()
    rows = stock_slice(mesh, dataset.values.shape[0])
    dataset.values = global_put(dataset.values, mesh, v_s).contiguous()
    dataset.last_valid = global_put(dataset.last_valid, mesh, lv_s).contiguous()
    dataset.next_valid = global_put(dataset.next_valid, mesh, nv_s).contiguous()
    dataset.stock_rows = rows


def chunk_placement(mesh) -> Callable:
    """Placement for the stream's mini-panels under a mesh: a function
    (values (N, D, C+1), last_valid (D, N), next_valid (D, N)) -> this rank's
    rows and columns of the three host arrays (views), applied before a
    chunk is gathered, so each rank builds and ships only its slice of every
    mini-panel (a fleet's stacked lanes too: they share the panel)."""
    v_s, lv_s, nv_s = panel_partition_specs()

    def place(values, last_valid, next_valid):
        return (global_put(values, mesh, v_s), global_put(last_valid, mesh, lv_s),
                global_put(next_valid, mesh, nv_s))

    return place
