"""Parallelism on `torch.distributed` (`factorvae_tpu/parallel/`): rank
meshes, partition rules, explicit collectives with their adjoints, ring
attention, placement helpers and the composition validator. Nothing here
imports JAX; `torch.distributed` is the backend (NCCL across cards, gloo
on the CPU or, when asked, several ranks sharing one card)."""

from factorvae_tpu_torch.parallel.compose import CompositionError, validate
from factorvae_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    HOST_AXIS,
    STOCK_AXIS,
    Axis,
    Mesh,
    batch_axes,
    data_parallel_size,
    make_hierarchical_mesh,
    make_mesh,
    single_device_mesh,
)
from factorvae_tpu_torch.parallel.multihost import (
    in_multihost_env,
    maybe_initialize,
    process_info,
)
from factorvae_tpu_torch.parallel.partition import (
    FLEET_STATE_RULES,
    PANEL_RULES,
    SEED_AXIS,
    TRAIN_STATE_RULES,
    P,
    gather_tree,
    make_shard_and_gather_fns,
    match_partition_rules,
    named_tree_map,
    panel_partition_specs,
    shard_tree,
    state_partition_specs,
)
from factorvae_tpu_torch.parallel.ring import ring_cross_section_attention
from factorvae_tpu_torch.parallel.sharding import chunk_placement, shard_dataset

__all__ = [
    "Axis",
    "CompositionError",
    "DATA_AXIS",
    "FLEET_STATE_RULES",
    "HOST_AXIS",
    "Mesh",
    "P",
    "PANEL_RULES",
    "SEED_AXIS",
    "STOCK_AXIS",
    "TRAIN_STATE_RULES",
    "batch_axes",
    "chunk_placement",
    "data_parallel_size",
    "gather_tree",
    "in_multihost_env",
    "make_hierarchical_mesh",
    "make_mesh",
    "make_shard_and_gather_fns",
    "match_partition_rules",
    "maybe_initialize",
    "named_tree_map",
    "panel_partition_specs",
    "process_info",
    "ring_cross_section_attention",
    "shard_dataset",
    "shard_tree",
    "single_device_mesh",
    "state_partition_specs",
    "validate",
]
