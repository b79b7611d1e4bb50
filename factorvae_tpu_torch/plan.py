"""The execution planner (`factorvae_tpu/plan.py`): per (platform, shape), the
training, scoring, fleet, residency, serving and memory knobs from a table of
measured rows, and a conservative default elsewhere.

A row matches a platform, a model shape (C, T, H, K, M) and a real
cross-section width inside its mandatory [n_min, n_max] envelope; the first
matching row wins. Every block of a row is optional and an absent (or null)
block resolves to its no-schema-break default: serial fleets, the hbm
residency, probes off, float32 serving, no training-precision or remat
verdict, no scheduler, SLO, hedge or mesh row, no budgets. A measured
`tick_ms` or `hedge_ms` of 0 survives. `save_rows` merges rows into the
table: a new row supersedes every older row of its platform and shape whose
envelope overlaps it. A missing, corrupt or mis-shaped table file reads as
empty. `python -m factorvae_tpu_torch.autotune` races the candidates on the
card and writes the rows.

Where the port differs from the JAX module:

- **Its own table.** `PLAN_TABLE_TORCH.json` at the repo root, or the file
  named by `FACTORVAE_TORCH_PLAN_TABLE`. The repo's `PLAN_TABLE.json` holds
  the JAX package's measurements and is never read here.
- **No builtin rows and no TPU default.** A row is a measurement of the
  port; unmatched shapes get the reference-faithful default (days_per_step
  1, float32) on both of the port's platforms.
- **The platform is the run's device.** `platform_kind` maps a `cuda`
  device (or `gpu`) to "gpu" and anything else to "cpu"; it never asks
  whether a card is present, so a `--device cpu` run resolves "cpu" rows.
  `platform=None` means the entry points' default device, the card.
- **No kernel switch.** On CUDA the kernels always run, so `Plan` has no
  `use_pallas_*` or `kernel_*` fields, a row's `kernels` block is ignored,
  and `describe` reports the route that runs (`"cuda"` or `"plain"`).
- **The pad quantum is 4** on both platforms (the JAX package's off-TPU
  quantum), times the stock-shard count.
- **The compilation cache is the kernels' build directory.**
  `setup_compilation_cache(DIR)` builds and loads the CUDA libraries there
  (`_build.set_build_dir`), so a second process given the same DIR loads
  every library as `compile_cached` and compiles none.

The port always runs the day-batched (flattened) layout; `flatten_days`
rides along as a recorded knob.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class ShapeKey:
    """The shape coordinates a row is keyed on; `n_stocks` is the real
    (unpadded) cross-section width."""

    num_features: int   # C
    seq_len: int        # T
    hidden_size: int    # H
    num_factors: int    # K
    num_portfolios: int  # M
    n_stocks: int       # N (real)


@dataclass(frozen=True)
class Plan:
    """One resolved plan: the JAX `Plan`'s fields without the kernel switch.

    Training: `flatten_days`, `days_per_step`, `compute_dtype`,
    `train_compute_dtype` ("" = no verdict), `train_remat` ("" = no
    verdict). Scoring: `score_flatten_days`, `score_compute_dtype`. Fleets:
    `seeds_per_program` (1 = serial), `lanes_per_program` (0 = no hyper
    row). Residency: `panel_residency`, `stream_chunk_days`. `obs_probes`.
    Serving: `serve_precision`, `serve_tick_ms` (-1 = no row),
    `serve_max_tick_batch` (0 = no row), `serve_slo_ms` (0 = none),
    `serve_hedge_ms` (-1 = no row). Mesh: `mesh_data_axis`,
    `mesh_stock_axis` (0/0 = no row) and the `mesh_days_per_step` the shape
    was raced at. Budgets: `budget_*` (0 = no envelope). `provenance` is
    "measured" or "default"; `source` says where the row came from."""

    flatten_days: bool
    days_per_step: int
    compute_dtype: str
    score_flatten_days: bool
    score_compute_dtype: str
    pad_target: int
    provenance: str
    source: str
    seeds_per_program: int = 1
    lanes_per_program: int = 0
    panel_residency: str = "hbm"
    stream_chunk_days: int = 32
    obs_probes: bool = False
    serve_precision: str = "float32"
    train_compute_dtype: str = ""
    train_remat: str = ""
    serve_tick_ms: float = -1.0
    serve_max_tick_batch: int = 0
    serve_slo_ms: float = 0.0
    serve_hedge_ms: float = -1.0
    mesh_data_axis: int = 0
    mesh_stock_axis: int = 0
    mesh_days_per_step: int = 0
    budget_compile_s: float = 0.0
    budget_peak_hbm_bytes: int = 0
    budget_comm_bytes_per_epoch: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def describe(self, shape: Optional[ShapeKey] = None,
                 platform: Optional[str] = None,
                 forced: Optional[dict] = None) -> dict:
        """The JSON-ready `plan` record: the knobs and provenance, with the
        kernels' route on `platform` when a shape is given."""
        d = self.to_dict()
        if shape is not None:
            route = "cuda" if platform_kind(platform) == "gpu" else "plain"
            d["kernels_resolved"] = {"attention": route, "gru": route}
        if forced:
            d["forced"] = {k: v for k, v in forced.items() if v}
        return d


def pad_target_policy(n_stocks: int, platform: Optional[str] = None,
                      shard: int = 1) -> int:
    """Cross-section pad target for a real width of `n_stocks`: a multiple
    of 4 (on either platform) and of the stock-shard count."""
    q = math.lcm(4, max(1, shard))
    return ((n_stocks + q - 1) // q) * q


def platform_kind(platform: Optional[str] = None) -> str:
    """A device or platform label ('cuda', 'cuda:0', 'gpu', 'cpu', a
    torch.device) to the table's key: 'gpu' or 'cpu'. None is the entry
    points' default device, the card."""
    p = "cuda" if platform is None else str(platform).lower()
    return "gpu" if p.startswith(("cuda", "gpu")) else "cpu"


PLAN_TABLE_ENV = "FACTORVAE_TORCH_PLAN_TABLE"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_TABLE_PATH = os.path.join(_REPO_ROOT, "PLAN_TABLE_TORCH.json")


def table_path(path: Optional[str] = None) -> str:
    return path or os.environ.get(PLAN_TABLE_ENV) or DEFAULT_TABLE_PATH


def _read_rows(path: str) -> list:
    """A table file's dict rows; [] for a missing, corrupt or mis-shaped
    file."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return []
    rows = data.get("rows", []) if isinstance(data, dict) else data
    if not isinstance(rows, list):
        return []
    return [r for r in rows if isinstance(r, dict)]


def load_table(path: Optional[str] = None) -> list:
    """The table file's rows (there are no builtin rows)."""
    return _read_rows(table_path(path))


def _row_key(row: dict) -> tuple:
    s = row.get("shape", {})
    return (row.get("platform"), s.get("c"), s.get("t"), s.get("h"),
            s.get("k"), s.get("m"), row.get("n_min"), row.get("n_max"))


def _envelopes_overlap(a: dict, b: dict) -> bool:
    """Two rows of one (platform, shape) whose width envelopes intersect."""
    if (a.get("platform"), a.get("shape")) != (b.get("platform"), b.get("shape")):
        return False
    try:
        return a["n_min"] <= b["n_max"] and b["n_min"] <= a["n_max"]
    except (KeyError, TypeError):
        return False


def save_rows(new_rows: Sequence[dict], path: Optional[str] = None) -> str:
    """Merge `new_rows` into the table file and return its path. An older
    row whose envelope overlaps a new row's is dropped (a stale merged
    [300, 356] row must not shadow fresh per-width rows); the others stay.
    The file is the JAX `save_rows`' bytes for the same rows."""
    p = table_path(path)
    existing = _read_rows(p)
    merged = {_row_key(r): r for r in existing
              if not any(_envelopes_overlap(r, n) for n in new_rows)}
    for r in new_rows:
        merged[_row_key(r)] = r
    with open(p, "w") as f:
        json.dump({"rows": sorted(merged.values(), key=lambda r: json.dumps(_row_key(r)))},
                  f, indent=1, sort_keys=True)
        f.write("\n")
    return p


def _match(row: dict, shape: ShapeKey, platform: str) -> bool:
    if row.get("platform") != platform:
        return False
    s = row.get("shape", {})
    if (s.get("c"), s.get("t"), s.get("h"), s.get("k"), s.get("m")) != (
            shape.num_features, shape.seq_len, shape.hidden_size,
            shape.num_factors, shape.num_portfolios):
        return False
    # the envelope is mandatory: a row without one matches no width
    if "n_min" not in row or "n_max" not in row:
        return False
    return row["n_min"] <= shape.n_stocks <= row["n_max"]


_DEFAULT = {"flatten_days": False, "days_per_step": 1, "compute_dtype": "float32"}
_DEFAULT_SOURCE = ("per-backend default: reference-faithful CPU path (dps=1, "
                   "un-flattened, float32)")


def _present(block: dict, key: str, absent: float) -> float:
    """A block's value that may legitimately be 0 (a measured winner), else
    `absent`."""
    return float(block[key]) if block.get(key) is not None else absent


def plan_for(shape: ShapeKey, platform: Optional[str] = None,
             table: Optional[Sequence[dict]] = None, shard: int = 1,
             table_path_: Optional[str] = None) -> Plan:
    """The plan for (platform, shape): the first matching row inside its
    envelope, else the default. Deterministic."""
    plat = platform_kind(platform)
    rows = list(table) if table is not None else load_table(table_path_)
    for row in rows:
        if not _match(row, shape, plat):
            continue
        train = row.get("train", {})
        score = row.get("score", train)
        fleet = row.get("fleet") or {}
        hyper = row.get("hyper") or {}
        stream = row.get("stream") or {}
        serve = row.get("serve") or {}
        mesh = row.get("mesh") or {}
        budgets = row.get("budgets") or {}
        return Plan(
            flatten_days=bool(train.get("flatten_days", False)),
            days_per_step=int(train.get("days_per_step", 1)),
            compute_dtype=str(train.get("compute_dtype", "float32")),
            score_flatten_days=bool(score.get("flatten_days",
                                              train.get("flatten_days", False))),
            score_compute_dtype=str(score.get("compute_dtype",
                                              train.get("compute_dtype", "float32"))),
            # a row's pad was measured at shard 1: re-align it to this run's
            pad_target=pad_target_policy(
                max(shape.n_stocks, int(row.get("pad_target") or 0)), plat, shard),
            provenance="measured",
            source=str(row.get("source", "plan table")),
            seeds_per_program=int(fleet.get("seeds_per_program") or 1),
            lanes_per_program=int(hyper.get("lanes_per_program") or 0),
            panel_residency=str(stream.get("panel_residency") or "hbm"),
            stream_chunk_days=int(stream.get("chunk_days") or 32),
            obs_probes=bool((row.get("obs") or {}).get("probes", False)),
            serve_precision=str(serve.get("precision") or "float32"),
            train_compute_dtype=str((row.get("train_precision") or {}).get("precision")
                                    or ""),
            train_remat=str((row.get("train_remat") or {}).get("remat") or ""),
            serve_tick_ms=_present(serve, "tick_ms", -1.0),
            serve_max_tick_batch=int(serve.get("max_tick_batch") or 0),
            serve_slo_ms=float(serve.get("slo_ms") or 0.0),
            serve_hedge_ms=_present(serve, "hedge_ms", -1.0),
            mesh_data_axis=int(mesh.get("data_axis") or 0),
            mesh_stock_axis=int(mesh.get("stock_axis") or 0),
            mesh_days_per_step=int(mesh.get("days_per_step") or 0),
            budget_compile_s=float(budgets.get("compile_seconds") or 0.0),
            budget_peak_hbm_bytes=int(budgets.get("peak_hbm_bytes") or 0),
            budget_comm_bytes_per_epoch=int(budgets.get("comm_bytes_per_epoch") or 0),
        )
    return Plan(
        flatten_days=_DEFAULT["flatten_days"],
        days_per_step=_DEFAULT["days_per_step"],
        compute_dtype=_DEFAULT["compute_dtype"],
        score_flatten_days=_DEFAULT["flatten_days"],
        score_compute_dtype=_DEFAULT["compute_dtype"],
        pad_target=pad_target_policy(shape.n_stocks, plat, shard),
        provenance="default",
        source=_DEFAULT_SOURCE,
    )


def shape_of(config, n_stocks: int) -> ShapeKey:
    """ShapeKey of a Config (or ModelConfig) at a real cross-section width."""
    m = getattr(config, "model", config)
    return ShapeKey(num_features=m.num_features, seq_len=m.seq_len,
                    hidden_size=m.hidden_size, num_factors=m.num_factors,
                    num_portfolios=m.num_portfolios, n_stocks=int(n_stocks))


def plan_for_config(config, n_stocks: int, platform: Optional[str] = None,
                    shard: int = 1, table: Optional[Sequence[dict]] = None) -> Plan:
    return plan_for(shape_of(config, n_stocks), platform=platform, table=table,
                    shard=shard)


def apply_plan(config, plan: Plan, *, keep_days_per_step: bool = False,
               keep_dtype: bool = False, keep_layout: bool = False,
               keep_pad: bool = False, keep_residency: bool = False,
               keep_obs: bool = False, keep_mesh: bool = False,
               keep_remat: bool = False):
    """The Config with the plan's training knobs applied; each `keep_*`
    leaves a knob the user set explicitly alone. A mesh row's shape comes
    with the days_per_step it was raced at."""
    model_kw: dict = {}
    if not keep_dtype:
        model_kw["compute_dtype"] = plan.compute_dtype
    if not keep_layout:
        model_kw["flatten_days"] = plan.flatten_days
    model = dataclasses.replace(config.model, **model_kw) if model_kw else config.model
    apply_mesh = not keep_mesh and plan.mesh_data_axis > 0 and plan.mesh_stock_axis > 0
    train_kw: dict = {}
    if not keep_days_per_step:
        train_kw["days_per_step"] = (plan.mesh_days_per_step
                                     if apply_mesh and plan.mesh_days_per_step > 0
                                     else plan.days_per_step)
    if not keep_dtype and plan.train_compute_dtype:
        train_kw["compute_dtype"] = plan.train_compute_dtype
    if not keep_remat and plan.train_remat:
        train_kw["remat"] = plan.train_remat
    if not keep_obs:
        train_kw["obs_probes"] = plan.obs_probes
    train = dataclasses.replace(config.train, **train_kw) if train_kw else config.train
    data_kw: dict = {}
    if not keep_pad:
        data_kw["max_stocks"] = plan.pad_target
    if not keep_residency:
        data_kw["panel_residency"] = plan.panel_residency
        data_kw["stream_chunk_days"] = plan.stream_chunk_days
    data = dataclasses.replace(config.data, **data_kw) if data_kw else config.data
    mesh = config.mesh
    if apply_mesh:
        mesh = dataclasses.replace(config.mesh, data_axis=plan.mesh_data_axis,
                                   stock_axis=plan.mesh_stock_axis)
    return dataclasses.replace(config, model=model, train=train, data=data, mesh=mesh)


def score_model_config(model_cfg, plan: Plan):
    """ModelConfig with the plan's scoring knobs (the same weights serve
    either: compute_dtype casts activations only)."""
    return dataclasses.replace(model_cfg, compute_dtype=plan.score_compute_dtype,
                               flatten_days=plan.score_flatten_days)


COMPILE_CACHE_ENV = "FACTORVAE_COMPILE_CACHE"


def setup_compilation_cache(path: Optional[str] = None) -> Optional[str]:
    """Build and load the CUDA kernels' libraries in a persistent directory:
    `path` > `$FACTORVAE_COMPILE_CACHE` > off (None; `"off"` turns it off
    even when the variable is set). Returns the absolute directory, or
    None, and puts the build back in the checkout's
    `factorvae_tpu_torch/_build/` when off, whatever an earlier call in
    this process chose."""
    from factorvae_tpu_torch import _build

    p = path or os.environ.get(COMPILE_CACHE_ENV)
    if not p or p == "off":
        _build.set_build_dir(_build.DEFAULT_BUILD_DIR)
        return None
    p = os.path.abspath(p)
    os.makedirs(p, exist_ok=True)
    _build.set_build_dir(p)
    return p
