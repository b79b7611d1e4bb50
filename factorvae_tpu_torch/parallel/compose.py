"""One validator for the mesh x fleet x stream composition matrix
(`factorvae_tpu/parallel/compose.py`, copied: the port imports nothing of
the JAX package).

The axes compose (partition.py). What remains are genuine shape
constraints (divisibility of the sharded dimensions), and this module is
the single place they are stated, with one error-message format, so every
caller (CLI, Trainer, FleetTrainer) fails identically and the matrix is
unit-testable in one place (tests/test_torch_parallel.py).

Composition matrix (docs/sharding.md):

    axes enabled            constraint
    --------------------    ------------------------------------------
    mesh (serial)           days_per_step % data_parallel_size == 0
    mesh x fleet            num_seeds % mesh['data'] == 0 (seed lanes)
    mesh x stream           none beyond the serial-mesh constraint
    mesh x fleet x stream   the fleet constraint
    fleet / stream alone    none (validated by their own constructors)
    any mesh, n_stocks      n_stocks % mesh['stock'] == 0 (the port adds
                            this row: each 'stock' rank holds as many
                            rows; GSPMD would pad the tail shard instead)
"""

from __future__ import annotations

from typing import Optional

from factorvae_tpu_torch.parallel.mesh import DATA_AXIS, STOCK_AXIS, data_parallel_size
from factorvae_tpu_torch.parallel.partition import (
    SEED_AXIS,
    day_batch_axes,
    seed_parallel_size,
)


class CompositionError(ValueError):
    """Invalid mesh x fleet x stream composition (one message format:
    'invalid parallel composition [<axes>]: <detail>')."""


def _fail(axes: str, detail: str) -> None:
    raise CompositionError(
        f"invalid parallel composition [{axes}]: {detail}")


def mesh_shape_candidates(n_devices: int) -> list:
    """(data, stock) factorizations of `n_devices`, plus the
    single-device (1, 1) baseline — ONE enumeration shared by
    `bench.py --mesh` and `autotune_plan.py --mesh` so the two grids
    can never drift apart."""
    shapes = [(1, 1)]
    for sp in range(1, n_devices + 1):
        if n_devices % sp == 0:
            dp = n_devices // sp
            if (dp, sp) not in shapes:
                shapes.append((dp, sp))
    return shapes


def compatible_days_per_step(days_per_step: int, data_parallel: int) -> int:
    """Smallest days_per_step >= the requested one that the serial
    day-dp constraint accepts (days_per_step % dp == 0) — the ONE
    scaling rule the mesh bench/race apply to serial cells. Changing a
    run's dps changes its gradient-averaging semantics, so callers must
    REPORT the scaled value (and persist it next to any mesh winner it
    produced — plan rows carry it in the mesh block)."""
    dps = max(1, int(days_per_step))
    dp = max(1, int(data_parallel))
    if dps % dp:
        return dp * dps
    return dps


def validate(
    mesh: Optional[object] = None,
    num_seeds: int = 1,
    residency: str = "hbm",
    days_per_step: int = 1,
    stream_chunk_days: int = 32,
    hyper: bool = False,
    n_stocks: Optional[int] = None,
) -> None:
    """Raise CompositionError if the requested axis composition cannot
    ship; a silent pass means Trainer/FleetTrainer/ChunkStream will
    compose these axes in one program.

    ``hyper=True`` labels the lane axis as a hyper-fleet CONFIG axis
    (ISSUE 12): the constraint is the same — lanes ride '{SEED_AXIS}'
    — but the one-line error names the hyper grid, so a grid whose lane
    count doesn't divide the mesh fails at construction (CLI exit 2)
    instead of as a mid-fit stacking error.

    `n_stocks` (the padded cross-section) must split evenly over the
    'stock' axis: the port splits it into equal slices, with no
    padding on one rank only (`config.stock_pad_multiple` pads to fit)."""
    if residency not in ("hbm", "stream"):
        _fail("stream", f"panel_residency must be 'hbm' or 'stream'; "
                        f"got {residency!r}")
    if num_seeds < 1:
        _fail("fleet", f"need at least one seed; got {num_seeds}")
    if residency == "stream" and stream_chunk_days < 1:
        _fail("stream", f"stream_chunk_days must be >= 1; "
                        f"got {stream_chunk_days}")
    if mesh is None:
        return
    sp = int(mesh.shape.get(STOCK_AXIS, 1))
    if n_stocks is not None and n_stocks % sp:
        _fail(
            "mesh",
            f"the cross-section of {n_stocks} stocks not divisible by the "
            f"'{STOCK_AXIS}' axis ({sp}; mesh {dict(mesh.shape)}); pad it "
            f"to a multiple of {sp} (pad_multiple / max_stocks) or shrink "
            f"the '{STOCK_AXIS}' axis",
        )
    if num_seeds == 1:
        # Serial runs: day-level data parallelism over the batch axes —
        # every device must take an equal slice of each update's days.
        dp = data_parallel_size(mesh)
        if days_per_step % dp:
            _fail(
                "mesh",
                f"days_per_step={days_per_step} not divisible by the "
                f"data-parallel size {dp} (mesh "
                f"{dict(mesh.shape)}); raise days_per_step or shrink "
                f"the '{DATA_AXIS}' axis",
            )
        return
    # Fleet runs: seed (or hyper-config) lanes ride SEED_AXIS ('data');
    # day-batches shard over the 'host' axis when the mesh has one.
    axes = "mesh x hyper" if hyper else "mesh x fleet"
    lanes = "config lanes" if hyper else "seeds"
    seed_ways = seed_parallel_size(mesh)
    if num_seeds % seed_ways:
        _fail(
            axes,
            f"{'hyper grid' if hyper else 'fleet'} of {num_seeds} "
            f"{lanes} not divisible by the "
            f"'{SEED_AXIS}' mesh axis ({seed_ways} lanes; mesh "
            f"{dict(mesh.shape)}); pick a lane count that is a "
            f"multiple of {seed_ways} or reshape the mesh",
        )
    day = day_batch_axes(mesh, stacked=True)
    if day:
        dp = int(mesh.shape[day[0]])
        if days_per_step % dp:
            _fail(
                axes,
                f"days_per_step={days_per_step} not divisible by the "
                f"'{day[0]}' axis ({dp}) that day-batches shard over "
                f"on a hierarchical mesh (mesh {dict(mesh.shape)})",
            )
