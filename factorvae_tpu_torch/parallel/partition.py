"""Named-regex partition rules -> partition specs (`factorvae_tpu/parallel/partition.py`).

One table of (regex, spec) rules, matched against the '/'-joined names of
a tree's leaves, places every tensor the training program touches: the
serial or stacked (fleet) train state, the panel and the stream's
mini-panels. A spec `P(...)` names, per dimension, the mesh axis (or
axes) that dimension is split over, or None for whole.

Axis semantics (`mesh.py`):

- 'data'  — serial runs: each rank takes a slice of every update's days.
  Fleet runs: seed lanes (no collective crosses them).
- 'stock' — the cross-section: panel rows and per-stock activations.
- 'host'  — hierarchical meshes: day batches across hosts.

The port's state tree (`state_tree`) names the leaves as the JAX
package's does: `step`, `rng` (the noise generator's state), `params/...`
(the module path, '.' -> '/'), `opt_state/mu/...`, `opt_state/nu/...` and
`opt_state/count` (Adam's moments and its update count), and on a mixed
run `loss_scale` and `good_steps`; a fleet's with a leading lane axis.
`make_shard_and_gather_fns` gives per-leaf functions: a shard takes this
rank's slice of identical data (`multihost.global_put`), a gather brings
the whole to host numpy on every rank (the checkpoint path: rank 0 writes
from host tensors). `device_bytes` is the rule table's byte bill per rank.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch

from factorvae_tpu_torch.parallel.mesh import DATA_AXIS, HOST_AXIS, STOCK_AXIS

# Seed lanes of a stacked (S, ...) fleet state ride the 'data' mesh axis.
SEED_AXIS = DATA_AXIS


class P(tuple):
    """A partition spec: per dimension a mesh axis name, a tuple of them, or
    None (whole); missing trailing dimensions are whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


# ---------------------------------------------------------------------------
# Path naming + rule matching
# ---------------------------------------------------------------------------


def _items(tree):
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def named_tree_map(fn: Callable[[str, Any], Any], tree, *rest, prefix: str = ""):
    """Map `fn(name, leaf, *other leaves)` over nested dicts/lists/tuples,
    `name` the '/'-joined path; the structure is kept (tuples and lists as
    lists of the same type, specs as leaves)."""
    items = _items(tree)
    if items is None:
        return fn(prefix, tree, *rest)
    out = []
    for i, (k, v) in enumerate(items):
        others = [r[k] if isinstance(r, dict) else r[i] for r in rest]
        out.append(named_tree_map(fn, v, *others, prefix=f"{prefix}/{k}" if prefix else k))
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), out))
    return type(tree)(out)


def tree_leaves(tree) -> list:
    """The leaves of `tree` in `named_tree_map` order, as (name, leaf)."""
    out = []
    named_tree_map(lambda n, x: out.append((n, x)), tree)
    return out


def match_partition_rules(rules: Sequence[Tuple[str, P]], tree):
    """Tree of specs resolved from (regex, spec) rules.

    First matching rule wins (`re.search` against the '/'-joined path
    name), so put specific rules before general ones. Scalar and
    single-element leaves are never partitioned (P()). A leaf no rule
    matches is a hard error: silently replicating a new state field would
    un-shard it on every path at once; the failure names the path so the
    rule table gets extended deliberately.
    """

    def get_spec(name, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or int(np.prod(shape)) <= 1:
            return P()
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                return spec
        raise ValueError(
            f"no partition rule matches leaf '{name}' "
            f"(shape {shape}); extend the rule table"
        )

    return named_tree_map(get_spec, tree)


def make_shard_and_gather_fns(mesh, specs):
    """(shard_fns, gather_fns) trees of per-leaf callables.

    shard_fn(x) keeps this rank's slice of identical data per its spec
    (`multihost.global_put`); gather_fn(x) brings a rank's slice back to
    the whole as host numpy, on every rank: the all-gather of each split
    dimension over its mesh axes (one all-reduce into zero-filled slots,
    `collective_ops`), nothing for a whole (replicated) leaf."""
    from factorvae_tpu_torch.parallel.multihost import global_put, host_array

    def make_shard(name, spec):
        return lambda x: global_put(x, mesh, spec)

    def make_gather(name, spec):
        def gather_fn(x):
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
            for d, axes in enumerate(spec):
                if axes is None:
                    continue
                t = _gather_dim(mesh, t, d, axes)
            return host_array(t)

        return gather_fn

    return named_tree_map(make_shard, specs), named_tree_map(make_gather, specs)


def _gather_dim(mesh, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """The whole of dimension `dim` of `t`, split over `axes` (one name or a
    tuple, major first), as the even split of `global_put` left it."""
    from factorvae_tpu_torch.parallel.collective_ops import all_gather_stocks

    names = axes if isinstance(axes, (tuple, list)) else (axes,)
    for nm in reversed(names):
        t = all_gather_stocks(t, mesh.axis(nm), dim=dim)
    return t.detach()


def shard_tree(mesh, specs, tree):
    """Apply `make_shard_and_gather_fns`' shard side to a whole tree."""
    shard_fns, _ = make_shard_and_gather_fns(mesh, specs)
    return named_tree_map(lambda n, fn, x: fn(x), shard_fns, tree)


def gather_tree(mesh, specs, tree):
    """Apply the gather side: sharded tree -> host-numpy tree."""
    _, gather_fns = make_shard_and_gather_fns(mesh, specs)
    return named_tree_map(lambda n, fn, x: fn(x), gather_fns, tree)


# ---------------------------------------------------------------------------
# The rule tables: the serial and the stacked (fleet) table name the same
# paths; the stacked one lays the leading seed axis over SEED_AXIS.
# ---------------------------------------------------------------------------

# Serial train state: replicated. The parameter tree is small (~3.5 MB at
# flagship shapes); the axes that pay are days and the cross-section.
TRAIN_STATE_RULES: list = [
    (r"^step$", P()),
    (r"^rng$", P()),
    (r"^(loss_scale|good_steps)$", P()),
    (r"^params/", P()),
    (r"^opt_state/", P()),
]

# Stacked (S, ...) fleet state: the leading seed axis over SEED_AXIS.
FLEET_STATE_RULES: list = [
    (r"^step$", P(SEED_AXIS)),
    (r"^rng$", P(SEED_AXIS)),
    (r"^(loss_scale|good_steps)$", P(SEED_AXIS)),
    (r"^params/", P(SEED_AXIS)),
    (r"^opt_state/", P(SEED_AXIS)),
]

# Panel arrays (PanelDataset and the stream's mini-panels):
#   values     (N, D, C+1) -> rows over 'stock'
#   last_valid (D, N)      -> columns over 'stock'
#   next_valid (D, N)      -> columns over 'stock'
PANEL_RULES: list = [
    (r"(^|/)values$", P(STOCK_AXIS, None, None)),
    (r"(^|/)(last_valid|next_valid)$", P(None, STOCK_AXIS)),
]


def _nest(named: dict) -> dict:
    """{'a.b.c': x} -> {'a': {'b': {'c': x}}}."""
    out: dict = {}
    for name, x in named.items():
        node = out
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = x
    return out


def state_tree(state) -> dict:
    """The '/'-named tree of a `TrainState` or a `FleetState` (module
    docstring): tensors where the state holds them, else arrays of the
    right shape (Adam's moments before its first update)."""
    if hasattr(state, "model"):
        params = dict(state.model.named_parameters())
        opt = state.optimizer.state
        mu = {n: opt.get(p, {}).get("exp_avg", p.detach()) for n, p in params.items()}
        nu = {n: opt.get(p, {}).get("exp_avg_sq", p.detach()) for n, p in params.items()}
        first = opt.get(next(iter(params.values())), {}) if params else {}
        tree = {
            "step": np.asarray(state.step, np.int64),
            "rng": state.generator.get_state().numpy(),
            "params": _nest(params),
            "opt_state": {"count": np.asarray(float(first.get("step", 0)), np.float32),
                          "mu": _nest(mu), "nu": _nest(nu)},
        }
        if state.loss_scale is not None:
            tree["loss_scale"] = np.asarray(state.loss_scale, np.float32)
            tree["good_steps"] = np.asarray(state.good_steps, np.int64)
        return tree
    tree = {
        "step": np.asarray(state.steps, np.int64),
        "rng": np.stack([g.get_state().numpy() for g in state.generators]),
        "params": _nest(state.params),
        "opt_state": {"count": np.asarray(state.counts, np.int64),
                      "mu": _nest(state.exp_avg), "nu": _nest(state.exp_avg_sq)},
    }
    if state.loss_scale is not None:
        tree["loss_scale"] = np.asarray(state.loss_scale, np.float32)
        tree["good_steps"] = np.asarray(state.good_steps, np.int64)
    return tree


def abstract_state_tree(model_cfg, device, mixed: bool, lanes=None) -> dict:
    """`state_tree` of a fresh state of `model_cfg` (of `lanes` stacked
    models when given) on `device`, with meta tensors for the parameters
    and moments: shapes and dtypes only, nothing allocated on the card."""
    from factorvae_tpu_torch.models.factorvae import FactorVAE

    with torch.device("meta"):
        model = FactorVAE(model_cfg)
    lead = () if lanes is None else (int(lanes),)
    params = {n: torch.empty(lead + tuple(p.shape), dtype=torch.float32, device="meta")
              for n, p in model.named_parameters()}
    rng = torch.Generator(device=device).get_state().numpy()
    tree = {
        "step": np.zeros(lead, np.int64),
        "rng": np.zeros(lead + rng.shape, rng.dtype),
        "params": _nest(params),
        "opt_state": {"count": np.zeros(lead, np.int64 if lanes else np.float32),
                      "mu": _nest(params), "nu": _nest(params)},
    }
    if mixed:
        tree["loss_scale"] = np.zeros(lead, np.float32)
        tree["good_steps"] = np.zeros(lead, np.int64)
    return tree


def state_partition_specs(state, stacked: bool = False):
    """Spec tree for a state tree (`state_tree`) or a bare params tree,
    serial or stacked. Only shapes are read."""
    return match_partition_rules(
        FLEET_STATE_RULES if stacked else TRAIN_STATE_RULES, state
    )


def panel_partition_specs(stacked: bool = False):
    """(values, last_valid, next_valid) specs, matching the panel rule
    table. `stacked=True` prepends the seed axis."""
    d = {"values": np.zeros((2, 2, 2)),
         "last_valid": np.zeros((2, 2)), "next_valid": np.zeros((2, 2))}
    specs = match_partition_rules(PANEL_RULES, d)
    out = (specs["values"], specs["last_valid"], specs["next_valid"])
    if stacked:
        out = tuple(P(SEED_AXIS, *s) for s in out)
    return out


def day_batch_axes(mesh, stacked: bool = False) -> tuple:
    """Mesh axes that shard the day-batch (B) dimension. Serial runs use
    `mesh.batch_axes`; fleet runs cede 'data' to the seed axis, so day
    batches shard over 'host' when the mesh has one and are whole
    otherwise. `train/loop.MeshStep` takes a step's days over these axes
    and reduces its gradients over them and 'stock'."""
    if not stacked:
        from factorvae_tpu_torch.parallel.mesh import batch_axes

        return batch_axes(mesh)
    return (HOST_AXIS,) if HOST_AXIS in mesh.axis_names else ()


def seed_parallel_size(mesh) -> int:
    """How many ways the seed axis splits on this mesh (1 = no mesh)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(SEED_AXIS, 1))


def _dim_shard_sizes(dim: int, k: int) -> list:
    """The split of one dimension over k shards: every shard gets
    ceil(dim/k) rows except the tail, which gets what is left (possibly
    zero; an uneven split is dead memory on the ranks that pad)."""
    per = -(-dim // k)
    return [max(0, min(per, dim - i * per)) for i in range(k)]


def _itemsize(leaf) -> int:
    dtype = getattr(leaf, "dtype", np.float32)
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def device_bytes(mesh, specs, tree) -> np.ndarray:
    """Per-rank real bytes of `tree` placed per `specs` on `mesh`, shaped
    like `mesh.devices`: the bytes of data (padding excluded) each rank
    holds. Only shapes and dtypes are read."""
    shape = tuple(int(s) for s in np.asarray(mesh.devices).shape)
    out = np.zeros(shape, dtype=np.int64)

    def add_leaf(name, spec, leaf):
        lshape = tuple(getattr(leaf, "shape", ()))
        itemsize = _itemsize(leaf)
        per_dim = []
        entries = list(spec) if spec is not None else []
        for d, dim in enumerate(lshape):
            axes = entries[d] if d < len(entries) else None
            if axes is None:
                per_dim.append((None, [dim]))
                continue
            names = axes if isinstance(axes, (tuple, list)) else (axes,)
            k = 1
            idxs = []
            for nm in names:
                k *= int(mesh.shape[nm])
                idxs.append(mesh.axis_names.index(nm))
            per_dim.append((tuple(idxs), _dim_shard_sizes(int(dim), k)))
        for coord in np.ndindex(*shape):
            b = itemsize
            for idxs, sizes in per_dim:
                if idxs is None:
                    b *= sizes[0]
                else:
                    li = 0
                    for i in idxs:
                        li = li * shape[i] + coord[i]
                    b *= sizes[li]
            out[coord] += b

    named_tree_map(add_leaf, specs, tree)
    return out


def stock_slice(mesh, n: int) -> slice:
    """This rank's rows of an n-row cross-section (the 'stock' split)."""
    from factorvae_tpu_torch.parallel.multihost import _slice_of

    if mesh is None or STOCK_AXIS not in mesh.axis_names:
        return slice(0, n)
    ax = mesh.axis(STOCK_AXIS)
    return _slice_of(n, ax.size, ax.index)


def seed_slice(mesh, s: int) -> slice:
    """This rank's lanes of an s-lane fleet (the seed split)."""
    from factorvae_tpu_torch.parallel.multihost import _slice_of

    if mesh is None:
        return slice(0, s)
    ax = mesh.axis(SEED_AXIS)
    return _slice_of(s, ax.size, ax.index)


__all__ = [
    "FLEET_STATE_RULES", "P", "PANEL_RULES", "SEED_AXIS", "TRAIN_STATE_RULES",
    "abstract_state_tree", "day_batch_axes", "device_bytes", "gather_tree",
    "make_shard_and_gather_fns", "match_partition_rules", "named_tree_map",
    "panel_partition_specs", "seed_parallel_size", "seed_slice", "shard_tree",
    "state_partition_specs", "state_tree", "stock_slice", "tree_leaves",
]
