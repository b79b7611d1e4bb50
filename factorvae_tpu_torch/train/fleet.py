"""Fleets of models: S independent trainings in lockstep
(`factorvae_tpu/train/fleet.py`).

The paper's evaluation needs many independent trainings (statistical
parity across seeds, `eval/sweep.py`), and a hyperparameter race needs one
per grid point. A flagship training step is bound by the host: its four
kernels take a small share of its wall and autograd's and Adam's small
launches the rest. A fleet carries S models through each launch: the
parameters and Adam's moments are stacked on a leading lane axis
(`train/state.FleetState`), the forward is `torch.func.vmap` of the model
over them, and each CUDA kernel launches once per step for all lanes
(`ops/kernels`, whose lane axis is the grid's y).

Semantics, as the JAX package's:

- Each lane is its solo run: its own init (`train.seed`), its own train
  noise generator (drawn outside the model and passed in, so lane i draws
  what its solo run draws), its own shuffled day order, its own validation
  noise. S > 1 lanes match their solo runs at f32 tolerance (vmap batches
  the products), not bitwise.
- S = 1 runs the serial `Trainer`'s step and epoch functions on a
  `TrainState` and equals `Trainer.fit` bitwise.
- Per lane, only `train.{lr, seed, run_name, save_dir}` and
  `model.kl_weight` may differ (`validate_lane_configs`); a shape or
  compute-dtype variant goes into its own shape bucket
  (`eval/sweep.grid_sweep`). Lanes whose (lr, kl_weight) are all the same
  fold to the seed fleet: the scalars are baked into the base config, so a
  homogeneous hyper-fleet is bitwise the seed fleet. A hyper-fleet reads
  lr and kl_weight per lane at run time (`set_lane_scalars` changes them
  between fits, as population-based training does, `train/pbt.py`).
- Best-validation selection runs per lane (`select_best`, a strict `<` as
  the serial trainer's), and each improved lane's best weights are saved
  under its own `checkpoint_name()`, which a serial `--score_only` loads.
- Full-state checkpoints are written per lane in lockstep, in the serial
  `Checkpointer`'s format (asynchronously under
  `train.async_checkpointing`, drained before `fit` returns), so a serial
  `Trainer` resumes any member; `fit(resume=True)` restores the whole group
  at the largest epoch every member has verified against its manifest (a
  corrupt member step is quarantined, and the group settles below it).
- A lane with `recover_after` bad epochs in a row (a non-finite train loss,
  skipped steps, or with `train.obs_probes` on float32 a non-finite
  gradient element) rolls back alone to its last checkpoint saved at a
  clean epoch; the others go on, and no lr changes (`_rollback_lanes`).

- A stream-resident dataset (`PanelDataset(residency="stream")`) is
  taken in chunks of `steps_per_chunk` steps, as the serial trainer's: a
  train chunk stacks each lane's mini-panel of its own shuffled days, the
  shared validation order gets one mini-panel per chunk
  (`data/stream.stream_epoch_batches`); bitwise the "hbm" fleet.

- Observability as the serial trainer's: `train.obs_probes` lifts each
  lane's probes into the `fleet_epoch` record as per-lane lists, each
  epoch runs in `train_epoch_{e}` / `val_epoch_{e}` spans, rewrites the
  installed textfile, marks the watermarks, and answers a
  `PROFILE_REQUEST` with a `profile_capture` record.

`train.remat` recomputes each fleet step's forward in its backward, the
checkpoint around the vmapped `lane_day_loss` (`train/loop.py`); like the
serial step's, it lowers no peak memory. Refused in `__init__`: on a CUDA
device a hidden size above the kernels' maximum.

- On a mesh (`mesh=`, or `use_mesh=True` for `config.mesh`'s over the
  world) the lanes lie over 'data': each rank trains its slice of them
  (`parallel/partition.seed_slice`), with no collective between lanes, and
  holds its 'stock' rows of the panel, the stock collectives and the
  gradient's reduction running within its 'stock' group
  (`train/loop.MeshStep(stacked=True)`). `compose.validate` checks the
  lane count against the 'data' axis. The records and `fit`'s `best_val`
  and `best_params` are the whole fleet's (all-gathered over 'data'); the
  returned state holds this rank's lanes (`lanes`, their global indices).
  The 'stock'-index-0 rank of each row writes its lanes' checkpoints and
  best weights, and every rank of the row reads them on a resume or a
  rollback; rank 0 alone logs. A hyper-fleet needs two lanes or more on
  every 'data' rank (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from factorvae_tpu_torch import chaos
from factorvae_tpu_torch.config import Config, config_hash
from factorvae_tpu_torch.data.stream import epoch_chunks
from factorvae_tpu_torch.models.factorvae import model_from_params
from factorvae_tpu_torch.obs.memory import watermark_event
from factorvae_tpu_torch.obs.metrics import export_epoch_metrics
from factorvae_tpu_torch.obs.probes import EVAL_PROBE_KEYS, TRAIN_PROBE_KEYS
from factorvae_tpu_torch.ops.kernels import hidden_refusal
from factorvae_tpu_torch.params import read_state_dict, save_weights
from factorvae_tpu_torch.train.checkpoint import Checkpointer, CheckpointIntegrityError
from factorvae_tpu_torch.train.loop import (
    check_remat,
    eval_epoch,
    lane_eval_epoch,
    lane_train_epoch,
    train_epoch,
)
from factorvae_tpu_torch.train.state import (
    FleetState,
    TrainState,
    learning_rate_at,
    make_optimizer,
    resolve_train_dtype,
    set_lr_scale,
)
from factorvae_tpu_torch.train.trainer import (
    eval_generator,
    init_train_state,
    log_profile_capture,
    profile_run_dir,
)
from factorvae_tpu_torch.utils.logging import MetricsLogger, timeline_event, timeline_span
from factorvae_tpu_torch.utils.profiling import maybe_profile_epoch

#: the per-lane Config fields a fleet may vary: lr and kl_weight as run-time
#: scalars, the seed as the lane's identity, run_name and save_dir for its
#: artifacts
LANE_TRAIN_FIELDS = frozenset({"lr", "seed", "run_name", "save_dir"})
LANE_MODEL_FIELDS = frozenset({"kl_weight"})


def validate_lane_configs(base: Config, lane_configs: Sequence[Config]) -> None:
    """Refuse lanes one fleet cannot carry: every field outside the lane
    fields must equal the base config's (a shape or compute dtype belongs in
    another shape bucket), and every lane must write its own artifacts."""
    for i, c in enumerate(lane_configs):
        for f in dataclasses.fields(c.model):
            if (f.name not in LANE_MODEL_FIELDS
                    and getattr(c.model, f.name) != getattr(base.model, f.name)):
                raise ValueError(
                    f"lane {i} varies model.{f.name}: shape and architecture fields "
                    "cannot ride the lane axis of one fleet; bucket per shape "
                    "(eval.sweep.grid_sweep) instead")
        for f in dataclasses.fields(c.train):
            if (f.name not in LANE_TRAIN_FIELDS
                    and getattr(c.train, f.name) != getattr(base.train, f.name)):
                if f.name == "compute_dtype":
                    raise ValueError(
                        f"lane {i} varies train.compute_dtype: the compute dtype "
                        "changes the step (the casts and the loss scale), so it "
                        "buckets like a shape (eval.sweep.grid_sweep), not a lane")
                raise ValueError(f"lane {i} varies train.{f.name}: only "
                                 f"{sorted(LANE_TRAIN_FIELDS)} may differ per lane")
        if c.data != base.data or c.mesh != base.mesh:
            raise ValueError(f"lane {i} varies the data or mesh config: lanes share "
                             "one panel and its splits")
    names = [(c.train.save_dir, c.checkpoint_name()) for c in lane_configs]
    dup = sorted({n for n in names if names.count(n) > 1})
    if dup:
        raise ValueError(
            f"lane checkpoint paths collide (same save_dir, run_name and seed): {dup}; "
            "tag each lane's run_name or save_dir (grid_sweep tags run_name per point)")


def lane_label(cfg: Config, hyper: bool) -> str:
    """A lane's label in the fleet's records: the seed, and on a hyper-fleet
    its scalars and a hash of its config."""
    if not hyper:
        return f"seed={cfg.train.seed}"
    return (f"seed={cfg.train.seed} lr={cfg.train.lr:g} klw={cfg.model.kl_weight:g} "
            f"cfg={config_hash(cfg.to_dict())[:8]}")


def stack_states(states: Sequence[TrainState]) -> FleetState:
    """S solo `TrainState`s as one `FleetState` (copies; the generators are
    shared)."""
    names = [n for n, _ in states[0].model.named_parameters()]
    per = [dict(st.model.named_parameters()) for st in states]
    opt = [{n: st.optimizer.state.get(p, {}) for n, p in d.items()}
           for st, d in zip(states, per)]

    def moment(key):
        return {n: torch.stack([o[n][key] if key in o[n] else torch.zeros_like(d[n])
                                for o, d in zip(opt, per)]).detach().clone()
                for n in names}

    params = {n: torch.stack([d[n].detach() for d in per]).clone().requires_grad_()
              for n in names}
    mixed = states[0].loss_scale is not None
    return FleetState(
        params=params, exp_avg=moment("exp_avg"), exp_avg_sq=moment("exp_avg_sq"),
        counts=np.asarray([st.scheduler.last_epoch for st in states], np.int64),
        generators=[st.generator for st in states],
        steps=np.asarray([st.step for st in states], np.int64),
        loss_scale=(np.asarray([st.loss_scale for st in states], np.float32)
                    if mixed else None),
        good_steps=(np.asarray([st.good_steps for st in states], np.int64)
                    if mixed else None))


def unstack_state(fleet: FleetState, i: int, model_cfg, train_cfg,
                  total_steps: int) -> TrainState:
    """Lane i of `fleet` as the solo `TrainState` of its run (copies; the
    generator is shared): the model, Adam (moments and step count) and the
    schedule at the lane's applied updates, the lane's peak lr
    `train_cfg.lr`."""
    model = model_from_params(model_cfg, fleet.params, i)
    optimizer, scheduler = make_optimizer(model.parameters(), train_cfg, total_steps)
    count = int(fleet.counts[i])
    if count:
        for n, p in model.named_parameters():
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": fleet.exp_avg[n][i].detach().clone(),
                "exp_avg_sq": fleet.exp_avg_sq[n][i].detach().clone()}
    scheduler.last_epoch = count
    scheduler._step_count = count + 1
    state = TrainState(model, optimizer, scheduler, fleet.generators[i],
                       step=int(fleet.steps[i]))
    if fleet.loss_scale is not None:
        state.loss_scale = np.float32(fleet.loss_scale[i])
        state.good_steps = int(fleet.good_steps[i])
    set_lr_scale(state, train_cfg, 1.0)
    return state


def set_lane(fleet: FleetState, i: int, state: TrainState) -> None:
    """Put the solo `state` into lane i of `fleet` in place (a rollback's or
    an exploit's splice)."""
    with torch.no_grad():
        params = dict(state.model.named_parameters())
        for n, p in fleet.params.items():
            p[i] = params[n].detach()
            st = state.optimizer.state.get(params[n], {})
            for key, store in (("exp_avg", fleet.exp_avg), ("exp_avg_sq", fleet.exp_avg_sq)):
                store[n][i] = st[key] if key in st else 0.0
    fleet.counts[i] = state.scheduler.last_epoch
    fleet.generators[i] = state.generator
    fleet.steps[i] = state.step
    if fleet.loss_scale is not None:
        fleet.loss_scale[i] = state.loss_scale
        fleet.good_steps[i] = state.good_steps


@torch.no_grad()
def select_best(best_params: dict, best_val: torch.Tensor, params: dict,
                selection: torch.Tensor):
    """The per-lane best-validation snapshot, on the device: where lane i
    improved (selection[i] < best_val[i], the serial trainer's strict `<`),
    its current parameters replace its best ones. A pure select. Returns
    (best_params, best_val)."""
    improved = selection < best_val
    new_best = {}
    for n, b in best_params.items():
        lane = improved.to(b.device).view((-1,) + (1,) * (b.ndim - 1))
        new_best[n] = torch.where(lane, params[n].detach(), b)
    return new_best, torch.where(improved, selection, best_val)


class FleetTrainer:
    """Train S models of one Config in lockstep.

        trainer = FleetTrainer(config, dataset, seeds=[0, 1, 2, 3], device="cuda")
        state, out = trainer.fit()      # out: history, best_val (S,), best_params

    `seeds` names a seed fleet (every lane is `config` at that seed);
    `lane_configs` (instead) a hyper-fleet, one Config per lane
    (`validate_lane_configs`). `force_hyper` keeps the run-time scalars even
    for homogeneous lanes (population-based training changes them between
    fits)."""

    def __init__(self, config: Config, dataset, seeds: Optional[Sequence[int]] = None,
                 device="cuda", logger: Optional[MetricsLogger] = None,
                 lane_configs: Optional[Sequence[Config]] = None,
                 force_hyper: bool = False, mesh=None, use_mesh: bool = False):
        from factorvae_tpu_torch.parallel import compose
        from factorvae_tpu_torch.train.loop import MeshStep
        from factorvae_tpu_torch.train.trainer import build_mesh, is_rank_zero

        if lane_configs is not None:
            if seeds is not None:
                raise ValueError("pass seeds or lane_configs, not both (lane configs "
                                 "carry their own train.seed)")
            lane_cfgs = list(lane_configs)
            if not lane_cfgs:
                raise ValueError("empty fleet: need at least one lane")
            validate_lane_configs(config, lane_cfgs)
        else:
            if not seeds:
                raise ValueError("empty fleet: need at least one seed")
            if len({int(s) for s in seeds}) != len(seeds):
                raise ValueError(f"duplicate seeds in fleet: {list(seeds)}")
            lane_cfgs = [dataclasses.replace(config, train=dataclasses.replace(
                config.train, seed=int(s))) for s in seeds]
        scalars = {(c.train.lr, c.model.kl_weight) for c in lane_cfgs}
        self.hyper = len(lane_cfgs) > 1 and (len(scalars) > 1 or bool(force_hyper))
        if not self.hyper and lane_configs is not None:
            # homogeneous lanes fold: the one scalar pair is baked into the
            # base config, so the fleet is the seed fleet
            lr, klw = next(iter(scalars))
            config = dataclasses.replace(
                config, model=dataclasses.replace(config.model, kl_weight=klw),
                train=dataclasses.replace(config.train, lr=lr))
        self.cfg = config
        self.ds = dataset
        self.device = torch.device(device)
        self.mesh = build_mesh(config, mesh, use_mesh)
        self.all_seeds = [int(c.train.seed) for c in lane_cfgs]
        self.logger = (logger or MetricsLogger(echo=False)) if is_rank_zero(self.mesh) \
            else MetricsLogger(echo=False)
        refused = hidden_refusal(config.model.hidden_size, self.device)
        if refused:
            raise ValueError(refused)
        if dataset.device.type != self.device.type:
            raise ValueError(f"the dataset lives on {dataset.device}, the fleet runs "
                             f"on {self.device}")
        compose.validate(mesh=self.mesh, num_seeds=len(lane_cfgs),
                         residency=dataset.residency,
                         days_per_step=max(1, config.train.days_per_step),
                         stream_chunk_days=config.data.stream_chunk_days, hyper=self.hyper,
                         n_stocks=dataset.n_max)
        self.mesh_step, self.lanes, self._writer = None, slice(0, len(lane_cfgs)), True
        if self.mesh is not None:
            from factorvae_tpu_torch.parallel.partition import seed_slice
            from factorvae_tpu_torch.parallel.sharding import shard_dataset

            self.mesh_step = MeshStep(self.mesh, stacked=True)
            self.lanes = seed_slice(self.mesh, len(lane_cfgs))
            self._writer = self.mesh_step.stock.index == 0
            if self.hyper and self.lanes.stop - self.lanes.start < 2:
                raise NotImplementedError(
                    "a hyper-fleet on a mesh needs two lanes or more on every 'data' "
                    "rank; not ported to factorvae_tpu_torch (ROADMAP Queue 1 item 16)")
            shard_dataset(self.mesh, dataset)
        self.lane_cfgs = lane_cfgs[self.lanes]
        self.seeds = [int(c.train.seed) for c in self.lane_cfgs]
        self.num_seeds = len(self.lane_cfgs)
        check_remat(config.train.remat)
        self.train_dtype = resolve_train_dtype(config.train, config.model)
        self.mixed = self.train_dtype != "float32"
        self.model_cfg = dataclasses.replace(config.model, compute_dtype=self.train_dtype)
        t = config.train
        self.loss_scale_cfg = (t.loss_scale_growth, t.loss_scale_backoff,
                               t.loss_scale_growth_interval, t.loss_scale_floor)
        self.model = model_from_params(self.model_cfg, None)
        self.train_days = dataset.split_days(config.data.start_time,
                                             config.data.fit_end_time)
        self.val_days = dataset.split_days(config.data.val_start_time,
                                           config.data.val_end_time)
        if len(self.train_days) == 0:
            raise ValueError("empty training split")
        self.batch_days = max(1, config.train.days_per_step)
        self.steps_per_epoch = -(-len(self.train_days) // self.batch_days)
        self.total_steps = self.steps_per_epoch * config.train.num_epochs
        self.stream = dataset.residency == "stream"
        self.steps_per_chunk = max(1, config.data.stream_chunk_days // self.batch_days)
        self.last_stream_stats = None
        self._ckpts: dict = {}
        self.logger.log(
            "fleet_execution_layout", seeds=self.all_seeds, seeds_per_program=self.num_seeds,
            hyper=self.hyper, lane_labels=self.lane_labels(),
            flatten_days=config.model.flatten_days, days_per_step=self.batch_days,
            compute_dtype=self.train_dtype, model_compute_dtype=config.model.compute_dtype,
            mixed_precision=self.mixed,
            checkpoint_saves="async" if config.train.async_checkpointing else "synchronous",
            n_real=dataset.n_real, n_padded=dataset.n_max,
            obs_probes=config.train.obs_probes, device=str(self.device),
            panel_residency="stream" if self.stream else "hbm",
            steps_per_chunk=self.steps_per_chunk if self.stream else None)
        if self.mesh is not None:
            from factorvae_tpu_torch.obs.memory import shard_balance_block
            from factorvae_tpu_torch.parallel.partition import abstract_state_tree

            self.logger.log("shard_balance", **shard_balance_block(
                self.mesh, state=abstract_state_tree(self.model_cfg, self.device, self.mixed,
                                                     lanes=len(self.all_seeds)),
                dataset=dataset, stacked=True))

    # ---- the mesh --------------------------------------------------------

    def _gather_lanes(self, values):
        """A per-lane list (or (S_local, ...) tensor) of this rank's lanes ->
        the whole fleet's, all-gathered over 'data' (itself without a
        mesh). Lists come back as lists of floats."""
        if self.mesh is None:
            return values
        from factorvae_tpu_torch.parallel.collective_ops import all_gather_stocks
        from factorvae_tpu_torch.parallel.mesh import DATA_AXIS

        axis = self.mesh.axis(DATA_AXIS)
        if isinstance(values, torch.Tensor):
            return all_gather_stocks(values.detach(), axis, dim=0)
        t = torch.as_tensor(np.asarray(values, np.float64), device=self.device)
        return all_gather_stocks(t, axis, dim=0).cpu().tolist()

    def _full_record(self, rec: dict) -> dict:
        """`rec` with each per-lane list gathered to the whole fleet's."""
        if self.mesh is None:
            return rec
        return {k: (self._gather_lanes(v) if isinstance(v, list)
                    and len(v) == self.num_seeds and k != "lane_labels" else v)
                for k, v in rec.items()}

    def _barrier(self) -> None:
        from factorvae_tpu_torch.train.trainer import barrier

        barrier(self.mesh)

    # ---- lanes -----------------------------------------------------------

    def lane_labels(self) -> list:
        return [lane_label(c, self.hyper) for c in self.lane_cfgs]

    def all_lane_labels(self) -> list:
        """Every lane's label, this rank's or not (a mesh splits the lanes)."""
        labels = self.lane_labels()
        if self.mesh is None:
            return labels
        import torch.distributed as dist

        from factorvae_tpu_torch.parallel.mesh import DATA_AXIS

        axis = self.mesh.axis(DATA_AXIS)
        if axis.group is None:
            return labels
        rows = [None] * axis.size
        dist.all_gather_object(rows, labels, group=axis.group)
        return [x for row in rows for x in row]

    def set_lane_scalars(self, lane: int, lr: Optional[float] = None,
                         kl_weight: Optional[float] = None) -> None:
        """Replace one lane's lr and kl_weight (run-time values of a
        hyper-fleet: the next epoch reads them). Its artifacts keep their
        names."""
        if not self.hyper:
            raise ValueError("set_lane_scalars needs a hyper-fleet (lane_configs, and "
                             "force_hyper=True for an initially homogeneous population)")
        c = self.lane_cfgs[lane]
        self.lane_cfgs[lane] = dataclasses.replace(
            c, model=dataclasses.replace(
                c.model, kl_weight=c.model.kl_weight if kl_weight is None else float(kl_weight)),
            train=dataclasses.replace(c.train, lr=c.train.lr if lr is None else float(lr)))

    def _lane_train_cfg(self, i: int):
        """Lane i's TrainConfig: the fleet's, with the lane's seed and lr."""
        c = self.lane_cfgs[i].train
        return dataclasses.replace(self.cfg.train, seed=c.seed, lr=c.lr)

    def _kl_weight(self) -> Optional[torch.Tensor]:
        if not self.hyper:
            return None
        return torch.tensor([c.model.kl_weight for c in self.lane_cfgs],
                            dtype=torch.float32, device=self.device)

    # ---- state -----------------------------------------------------------

    def init_lane_state(self, i: int) -> TrainState:
        """Lane i's solo first state (`Trainer.init_state` at its config)."""
        return init_train_state(self.model_cfg, self._lane_train_cfg(i), self.total_steps,
                                self.device)

    def init_fleet_state(self):
        """Each lane's solo first state (`Trainer.init_state` at its
        config): a `TrainState` at S = 1, their `FleetState` else."""
        states = [self.init_lane_state(i) for i in range(self.num_seeds)]
        return states[0] if self.num_seeds == 1 else stack_states(states)

    def _lane_state(self, run, i: int) -> TrainState:
        if self.num_seeds == 1:
            return run
        return unstack_state(run, i, self.model_cfg, self._lane_train_cfg(i),
                             self.total_steps)

    def _params(self, run) -> dict:
        """The run's parameters as stacked (S, ...) tensors."""
        if self.num_seeds == 1:
            return {n: p.detach()[None] for n, p in run.model.named_parameters()}
        return run.params

    def _stacked(self, run) -> FleetState:
        return stack_states([run]) if self.num_seeds == 1 else run

    def _epoch_orders(self, epoch: int) -> np.ndarray:
        """(S, steps, B): each lane's day order, shuffled with its own seed,
        as its solo run's epoch."""
        orders = [self.ds.epoch_order(self.train_days, shuffle=True, seed=s, epoch=epoch,
                                      pad_to=self.batch_days).reshape(-1, self.batch_days)
                  for s in self.seeds]
        return np.stack(orders).astype(np.int64)

    def _val_order(self) -> Optional[np.ndarray]:
        if len(self.val_days) == 0:
            return None
        order = self.ds.epoch_order(self.val_days, shuffle=False, seed=0, epoch=0,
                                    pad_to=self.batch_days)
        return order.reshape(-1, self.batch_days).astype(np.int64)

    def _chunks(self, order: np.ndarray):
        placement = None
        if self.mesh is not None:
            from factorvae_tpu_torch.parallel.sharding import chunk_placement

            placement = chunk_placement(self.mesh)
        return epoch_chunks(self.ds, order, self.steps_per_chunk, placement)

    def _eval_generators(self, epoch: int) -> list:
        return [eval_generator(s, epoch, self.device) for s in self.seeds]

    def _poison(self, epoch: int) -> np.ndarray:
        """(S,) bools: the lanes a `nan_grads` fault poisons this epoch."""
        return np.asarray([chaos.fault("nan_grads", epoch=epoch,
                                       lane=self.lanes.start + i) is not None
                           for i in range(self.num_seeds)])

    def _run_train_epoch(self, run, epoch: int) -> dict:
        orders = self._epoch_orders(epoch)
        poison = self._poison(epoch)
        guard = self.cfg.train.finite_guard
        probes = self.cfg.train.obs_probes
        dtype = self.model_cfg.dtype
        if self.num_seeds == 1:
            chunks = self._chunks(orders[0])
            m = train_epoch(run, chunks, guard=guard, poison=bool(poison[0]),
                            compute_dtype=dtype, loss_scale_cfg=self.loss_scale_cfg,
                            probes=probes, remat=self.cfg.train.remat, mesh=self.mesh_step)
            m = {k: [v] for k, v in m.items()}
        else:
            chunks = self._chunks(orders)
            m = lane_train_epoch(
                self.model, run, chunks, peaks=[c.train.lr for c in self.lane_cfgs],
                train_cfg=self.cfg.train, total_steps=self.total_steps, guard=guard,
                poison=poison, compute_dtype=dtype, loss_scale_cfg=self.loss_scale_cfg,
                kl_weight=self._kl_weight(), probes=probes, remat=self.cfg.train.remat,
                mesh=self.mesh_step)
        if self.stream:
            self.last_stream_stats = chunks
        return m

    def _run_eval_epoch(self, run, val_order: np.ndarray, epoch: int) -> dict:
        generators = self._eval_generators(epoch)
        dtype = self.model_cfg.dtype
        probes = self.cfg.train.obs_probes
        if self.num_seeds == 1:
            m = eval_epoch(run.model, self._chunks(val_order), generators[0], dtype,
                           probes=probes, mesh=self.mesh_step)
            return {k: [v] for k, v in m.items()}
        return lane_eval_epoch(self.model, run.params, self._chunks(val_order), generators,
                               dtype, self._kl_weight(), probes=probes, mesh=self.mesh_step)

    def evaluate_lanes(self, state: FleetState, epoch: int) -> Optional[list]:
        """Each lane's validation loss of `state` (a `fit` result) with
        epoch `epoch`'s validation noise, or None without a validation
        split."""
        val_order = self._val_order()
        if val_order is None:
            return None
        run = (unstack_state(state, 0, self.model_cfg, self._lane_train_cfg(0),
                             self.total_steps) if self.num_seeds == 1 else state)
        return self._run_eval_epoch(run, val_order, epoch)["loss"]

    def _lrs(self, run) -> list:
        """Each lane's lr at its applied updates (the serial record's lr)."""
        counts = ([run.scheduler.last_epoch] if self.num_seeds == 1 else run.counts)
        return [learning_rate_at(c.train, self.total_steps, int(n))
                for c, n in zip(self.lane_cfgs, counts)]

    # ---- the epoch loop --------------------------------------------------

    def fit(self, num_epochs: Optional[int] = None, resume: bool = False):
        """Train the whole fleet. Returns (state, out): the final
        `FleetState` (stacked at S = 1 too) and `out` with `history`
        (per-epoch records, per-lane values as lists), `best_val` (S,),
        `best_params` (the per-lane best-validation snapshots, stacked) and
        `final_params` (the final parameters, stacked); on a mesh `state`
        holds this rank's lanes and the rest is the whole fleet's.
        Each lane's best weights are also saved under its
        `checkpoint_name()`.

        `num_epochs` runs the first N epochs of the configured cosine
        horizon.
        `resume=True` restores the group from its lockstep per-lane
        checkpoints at the largest epoch every member has, and continues as
        the unbroken run would."""
        cfg, tcfg = self.cfg, self.cfg.train
        epochs = tcfg.num_epochs if num_epochs is None else num_epochs
        self.total_steps = self.steps_per_epoch * tcfg.num_epochs
        run = self.init_fleet_state()
        best_val = np.full(self.num_seeds, np.inf)
        best_params = {n: p.detach().clone() for n, p in self._params(run).items()}
        start_epoch = 0
        recover_after = max(0, int(tcfg.recover_after))
        lane_streak = [0] * self.num_seeds
        lane_rollbacks = [0] * self.num_seeds
        lane_anchor: list = [None] * self.num_seeds
        if resume and tcfg.checkpoint_every:
            restored = self._restore_checkpoints()
            if restored is not None:
                run, best_val, start_epoch, cleans = restored
                best_params = self._load_best(run, best_val)
                lane_anchor = [start_epoch - 1 if c else None for c in cleans]
                self.logger.log("fleet_resume", epoch=start_epoch, seeds=self.seeds,
                                best_val=[float(v) for v in best_val])
        val_order = self._val_order()
        ckpt_every = max(1, tcfg.checkpoint_every or 0)
        history = []
        run_dir = profile_run_dir(self.logger)
        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            with maybe_profile_epoch(run_dir, epoch) as (prof, prof_dir), \
                    timeline_span(f"train_epoch_{epoch}", cat="train", resource="device",
                                  epoch=epoch, seeds=self.num_seeds):
                train_m = self._run_train_epoch(run, epoch)
            log_profile_capture(self.logger, epoch, prof, prof_dir)
            val_m = None
            if val_order is not None:
                with timeline_span(f"val_epoch_{epoch}", cat="eval", resource="device",
                                   epoch=epoch, seeds=self.num_seeds):
                    val_m = self._run_eval_epoch(run, val_order, epoch)
                selection = val_m["loss"]
            else:
                selection = train_m["loss"]
            prev_best = best_val.copy()
            if self.num_seeds == 1:
                # the serial trainer's host branch: a copy on improvement
                if selection[0] < best_val[0]:
                    best_val = np.asarray([selection[0]])
                    best_params = {n: p.detach().clone() for n, p in self._params(run).items()}
            else:
                best_params, bv = select_best(
                    best_params, torch.as_tensor(best_val),
                    self._params(run), torch.as_tensor(np.asarray(selection, np.float64)))
                best_val = bv.numpy()
            seconds = time.perf_counter() - t0
            lrs = self._lrs(run)
            rec = dict(
                epoch=epoch, train_loss=train_m["loss"],
                val_loss=(val_m["loss"] if val_m is not None
                          else [float("nan")] * self.num_seeds),
                train_recon=train_m["recon"], train_kl=train_m["kl"],
                lr=lrs if self.hyper else lrs[0],
                step=int(run.step if self.num_seeds == 1 else run.steps[0]),
                seconds=seconds,
                seed_days_per_sec=len(self.all_seeds) * train_m["days"][0]
                / max(seconds, 1e-9),
                lane_labels=self.all_lane_labels())
            for key in ("skipped_steps", "loss_scale", "loss_scale_floor_steps"):
                if key in train_m:
                    rec[key] = train_m[key]
            if tcfg.obs_probes:
                rec.update({k: train_m[k] for k in TRAIN_PROBE_KEYS})
                if val_m is not None:
                    rec.update({"val_" + k: val_m[k] for k in EVAL_PROBE_KEYS})
            rec = self._full_record(rec)
            history.append(rec)
            self.logger.log("fleet_epoch", **rec)
            export_epoch_metrics(rec)
            watermark_event(epoch=epoch, seeds=len(self.all_seeds))

            # per-lane recovery: a bad lane rolls back alone
            loss_np = np.asarray(train_m["loss"], np.float64)
            skip_np = np.asarray(train_m.get("skipped_steps", [0.0] * self.num_seeds))
            if self.mixed:
                budget = self.steps_per_epoch // max(1, tcfg.loss_scale_growth_interval) + 1
                bad_lanes = (~np.isfinite(loss_np) | (skip_np > budget)
                             | (np.asarray(train_m["loss_scale"]) <= tcfg.loss_scale_floor))
            else:
                nf_np = np.nan_to_num(np.asarray(
                    train_m.get("nonfinite_grads", [0.0] * self.num_seeds), np.float64))
                bad_lanes = ~np.isfinite(loss_np) | (skip_np > 0) | (nf_np > 0)
            for i in range(self.num_seeds):
                lane_streak[i] = lane_streak[i] + 1 if bad_lanes[i] else 0
            to_roll = [i for i in range(self.num_seeds)
                       if recover_after and lane_streak[i] >= recover_after
                       and lane_rollbacks[i] < tcfg.recover_max_rollbacks
                       and lane_anchor[i] is not None]
            if to_roll:
                run = self._rollback_lanes(run, to_roll, lane_anchor, epoch)
                for i in to_roll:
                    lane_rollbacks[i] += 1
                    lane_streak[i] = 0
            for i in range(self.num_seeds):
                if recover_after and lane_streak[i] == recover_after and i not in to_roll:
                    reason = ("checkpointing disabled" if not tcfg.checkpoint_every
                              else f"rollback budget spent ({lane_rollbacks[i]}/"
                                   f"{tcfg.recover_max_rollbacks})"
                              if lane_rollbacks[i] >= tcfg.recover_max_rollbacks
                              else "no good-epoch checkpoint anchor yet")
                    self.logger.log("recovery", kind="lane_rollback_unavailable", lane=i,
                                    seed=self.seeds[i], epoch=epoch,
                                    note=f"{reason}; lane continues un-rolled")
                    timeline_event("recovery_rollback_unavailable", cat="recovery",
                                   resource="recovery", epoch=epoch, lane=i, reason=reason)
            improved = [i for i in range(self.num_seeds)
                        if np.isfinite(best_val[i]) and best_val[i] < prev_best[i]]
            self._save_best(best_params, improved)
            if tcfg.checkpoint_every and (epoch % ckpt_every == 0 or epoch == epochs - 1):
                self._save_checkpoints(run, epoch, best_val,
                                       [lane_streak[i] == 0 for i in range(self.num_seeds)])
                for i in range(self.num_seeds):
                    if lane_streak[i] == 0:
                        lane_anchor[i] = epoch
        self.close_checkpoints()
        self._barrier()
        final = self._params(run)
        if self.mesh is not None:
            best_val = np.asarray(self._gather_lanes([float(v) for v in best_val]))
            best_params = {n: self._gather_lanes(p) for n, p in best_params.items()}
            final = {n: self._gather_lanes(p) for n, p in final.items()}
        self.logger.log("fleet_best", seeds=self.all_seeds,
                        best_val=[float(v) for v in best_val])
        return self._stacked(run), {"history": history, "best_val": best_val,
                                    "best_params": best_params, "final_params": final}

    # ---- checkpoints -----------------------------------------------------

    def _lane_dir(self, i: int) -> str:
        c = self.lane_cfgs[i]
        return os.path.join(c.train.save_dir, f"{c.checkpoint_name()}_ckpt")

    def lane_checkpointer(self, i: int) -> Checkpointer:
        if i not in self._ckpts:
            t = self.lane_cfgs[i].train
            self._ckpts[i] = Checkpointer(self._lane_dir(i), keep=t.keep_checkpoints,
                                          async_save=t.async_checkpointing)
        return self._ckpts[i]

    def close_checkpoints(self) -> None:
        """Drain every lane's queued checkpoint saves."""
        for ck in self._ckpts.values():
            ck.close()

    def _save_best(self, best_params: dict, lanes) -> None:
        """Lane i's best weights under its `checkpoint_name()`, for each of
        `lanes`: the file a serial `--score_only` loads."""
        for i in lanes if self._writer else ():
            c = self.lane_cfgs[i]
            save_weights(model_from_params(self.model_cfg, best_params, i), c,
                         os.path.join(c.train.save_dir, c.checkpoint_name()))
        self._barrier()

    def _save_checkpoints(self, run, epoch: int, best_val, clean) -> None:
        """One full-state checkpoint per lane at `epoch`, in the serial
        format (a serial `Trainer` resumes any member). On a mesh the
        'stock'-index-0 rank writes them, drained before every rank goes on."""
        for i in range(self.num_seeds) if self._writer else ():
            self.lane_checkpointer(i).save(
                epoch, self._lane_state(run, i),
                {"epoch": epoch, "best_val": float(best_val[i]),
                 "config": self.lane_cfgs[i].to_dict(), "clean": bool(clean[i])})
            if self.mesh is not None:
                self.lane_checkpointer(i).wait_until_finished()
        self._barrier()

    def _restore_checkpoints(self):
        """(run state, best_val (S,), start epoch, per-lane clean flags) from
        the per-lane checkpoints at the largest epoch every member has
        verified, or None (logged when the members share no epoch). A member
        step that fails at restore is quarantined there, and the scan runs
        again below it."""
        common = None
        for i in range(self.num_seeds):
            steps = set(self.lane_checkpointer(i).verified_steps())
            if not steps:
                return None
            common = steps if common is None else common & steps
        if not common:
            self.logger.log("fleet_resume_skipped", seeds=self.seeds,
                            note="no checkpoint step common to every fleet member; "
                                 "starting the group fresh")
            return None
        epoch = max(common)
        states, best_vals, cleans = [], [], []
        for i in range(self.num_seeds):
            st = self.init_lane_state(i)
            try:
                meta = self.lane_checkpointer(i).restore(st, step=epoch, verified=True)
            except CheckpointIntegrityError as e:
                self.logger.log("fleet_resume_retry", seed=self.seeds[i], step=epoch,
                                error=str(e), note="member checkpoint failed at restore; "
                                                   "rescanning for an older common step")
                return self._restore_checkpoints()
            set_lr_scale(st, self._lane_train_cfg(i), 1.0)
            states.append(st)
            best_vals.append(float(meta.get("best_val", float("inf"))))
            cleans.append(bool(meta.get("clean", True)))
            saved = meta.get("config")
            if saved is not None and saved != self.lane_cfgs[i].to_dict():
                self.logger.log("fleet_resume_config_mismatch", seed=self.seeds[i],
                                note="resuming with a different config than the "
                                     "checkpoint was written with")
        run = states[0] if self.num_seeds == 1 else stack_states(states)
        return run, np.asarray(best_vals), epoch + 1, cleans

    def _load_best(self, run, best_val) -> dict:
        """The stacked best-parameters buffer from the per-lane best weights
        on disk; a lane without them keeps its current parameters."""
        current = self._params(run)
        rows = []
        for i, c in enumerate(self.lane_cfgs):
            path = os.path.join(c.train.save_dir, c.checkpoint_name())
            if np.isfinite(best_val[i]) and os.path.isdir(path):
                sd = read_state_dict(path)
                rows.append({n: sd[n].to(self.device) for n in current})
            else:
                rows.append({n: p[i].clone() for n, p in current.items()})
        return {n: torch.stack([r[n] for r in rows]) for n in current}

    def _rollback_lanes(self, run, lanes, lane_anchor, epoch: int):
        """Restore each of `lanes` from its last checkpoint saved at a clean
        epoch and splice it into the run; the other lanes are untouched. A
        lane whose anchor is gone falls back to its newest checkpoint."""
        for i in lanes:
            ckpt = self.lane_checkpointer(i)
            st = self.init_lane_state(i)
            restored = lane_anchor[i]
            try:
                ckpt.restore(st, step=restored)
            except (FileNotFoundError, CheckpointIntegrityError):   # evicted or corrupt
                try:
                    restored = int(ckpt.restore(st)["epoch"])
                except FileNotFoundError:
                    self.logger.log("recovery", kind="lane_rollback_unavailable", lane=i,
                                    seed=self.seeds[i], epoch=epoch,
                                    note="no checkpoint for this lane; continuing forward")
                    continue
            set_lr_scale(st, self._lane_train_cfg(i), 1.0)
            if self.num_seeds == 1:
                run = st
            else:
                set_lane(run, i, st)
            self.logger.log("recovery", kind="lane_rollback", lane=i, seed=self.seeds[i],
                            epoch=epoch, restored_step=restored)
            timeline_event("recovery_rollback", cat="recovery", resource="recovery", lane=i,
                           seed=self.seeds[i], epoch=epoch, step=restored)
        return run
