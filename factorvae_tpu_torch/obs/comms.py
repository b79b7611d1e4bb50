"""The collective-communication bill of a mesh run (`factorvae_tpu/obs/comms.py`).

The JAX module reads the collectives GSPMD inserted from the compiled HLO
text. The port has no HLO to scan: every collective is an explicit call of
`parallel/collective_ops.py` (and the ring's `collective-permute`), each of
which counts its calls and payload bytes per kind and mesh axis as it runs.
`comms_block` turns two snapshots of those counters into the JAX block's
keys, by kind, by axis, per step and per program (the program being the run
between the snapshots):

- `collective_ops` and `ops_by_kind`: collective calls (forward and
  backward; kinds `all-reduce`, `all-gather`, `collective-permute`,
  `broadcast`);
- `payload_bytes_per_program`: payload bytes over the run (what each op
  hands the collective, not wire bytes; a gather counts its output);
- `bytes_per_epoch`, `bytes_by_axis` (per epoch), `steps_per_epoch`,
  and the port's `calls_per_step` / `bytes_per_step`.

An axis of one rank runs no collective and counts nothing, so a 1 x 1 mesh's
block is zero, as the JAX scan drops degenerate groups. The axes are the
mesh's names: `data`, `stock`, `host`, their product `host/data` (the
batch axes) and `data/stock` (the world, the gradient's all-reduce).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["comms_block", "counts_delta"]


def counts_delta(now: dict, base: Optional[dict] = None) -> dict:
    """{(kind, axis): {"calls", "bytes"}} of `now` less `base`."""
    base = base or {}
    out = {}
    for key, c in now.items():
        b = base.get(key, {"calls": 0, "bytes": 0})
        calls, nbytes = c["calls"] - b["calls"], c["bytes"] - b["bytes"]
        if calls:
            out[key] = {"calls": calls, "bytes": nbytes}
    return out


def comms_block(now: dict, base: Optional[dict] = None, mesh=None, steps: int = 1,
                steps_per_epoch: int = 1) -> dict:
    """The comms bill of the run between the counter snapshots `base` and
    `now` (`collective_ops.comm_counts`), which took `steps` train steps of
    `steps_per_epoch` an epoch: the JAX block's keys."""
    delta = counts_delta(now, base)
    by_kind: dict = {}
    by_axis: dict = {}
    calls = total = 0
    for (kind, axis), c in sorted(delta.items()):
        by_kind[kind] = by_kind.get(kind, 0) + c["calls"]
        by_axis[axis] = by_axis.get(axis, 0) + c["bytes"]
        calls += c["calls"]
        total += c["bytes"]
    steps = max(1, int(steps))
    epochs = steps / max(1, int(steps_per_epoch))
    block = {
        "collective_ops": calls,
        "ops_by_kind": by_kind,
        "payload_bytes_per_program": total,
        "bytes_per_epoch": total / epochs,
        "bytes_by_axis": {a: b / epochs for a, b in by_axis.items()},
        "steps_per_epoch": int(steps_per_epoch),
        "calls_per_step": calls / steps,
        "bytes_per_step": total / steps,
    }
    if mesh is not None:
        block["mesh"] = {str(n): int(s) for n, s in mesh.shape.items()}
    return block
