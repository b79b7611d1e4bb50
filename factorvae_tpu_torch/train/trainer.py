"""The trainer (`factorvae_tpu/train/trainer.py`): config + data +
model + optimizer in an epoch loop with best-validation selection and
resumable checkpoints.

    trainer = Trainer(config, dataset, device="cuda")
    state, summary = trainer.fit()
    metrics = trainer.evaluate(state.model)

The dataset lives on `device` (`PanelDataset(..., device=...)`); every step
gathers its day batch there. Days are visited in the JAX package's order
(`PanelDataset.epoch_order`), so from the same weights both packages take
the same steps. The train noise (the decoder's sample, the predictor's
dropout) comes from one `torch.Generator` seeded from `train.seed`; the
validation noise of epoch e from its own generator seeded from (seed, e).

Ported: the finite guard, best-validation weights (`params.save_weights`
under `config.checkpoint_name()`), full-state checkpoints every
`checkpoint_every` epochs, resume, and the rollback recovery: after
`recover_after` bad epochs in a row (a non-finite train loss or any skipped
step) the run goes back to its last checkpoint saved at a clean epoch,
scales the peak lr by `recover_lr_backoff` and replays from there, at most
`recover_max_rollbacks` times. Events go to a `utils.logging.MetricsLogger`
with the JAX `Trainer`'s names and fields.

The precision ladder: the training dtype resolves through
`train/state.resolve_train_dtype` and the model computes in it. A bfloat16
run is mixed: float32 masters and optimizer, a bfloat16 compute copy per
step, the dynamic loss scale of `TrainConfig.loss_scale_*` (each epoch
record gains `loss_scale` and `loss_scale_floor_steps`), and validation in
bfloat16 too. Its rollback counts up to steps_per_epoch // growth_interval
+ 1 skipped steps an epoch as normal (the scale's growth overshoots about
once per interval) and a scale at its floor as bad.

The dataset's residency decides how an epoch reaches the card: under
"stream" (`PanelDataset(residency="stream")`) each train and validation
epoch walks chunks of `steps_per_chunk = stream_chunk_days // days_per_step`
steps (the tail chunk shorter, never padded), each a mini-panel copied one
chunk ahead (`data/stream.py`); the steps, the generators and the metrics
are the "hbm" epoch's, bitwise. `last_stream_stats` is the last train
epoch's `ChunkStream` and its transfer ledger.

Observability (`factorvae_tpu/train/trainer.py`): with `train.obs_probes`
each epoch record gains the health probes of `obs/probes.py`
(`TRAIN_PROBE_KEYS`, and `val_`-prefixed `EVAL_PROBE_KEYS`), and on float32
a non-finite gradient element counts as a bad epoch for the rollback. Each
epoch runs inside `train_epoch_{e}` / `val_epoch_{e}` timeline spans on the
"device" resource, rewrites the installed Prometheus textfile
(`obs/metrics.export_epoch_metrics`) and marks the allocator's watermarks
(`obs/memory.watermark_event`). A `PROFILE_REQUEST` file beside the metrics
stream runs the next train epoch under `torch.profiler`
(`utils/profiling.maybe_profile_epoch`) and logs its `profile_capture`.

`train.remat` "dots" or "full" recomputes each step's forward in its
backward (`train/loop.rematerialized`), with the loss and gradients of
"none" and no lower peak memory (its checkpoint wraps the whole day loss);
another value raises the JAX package's ValueError. Refused in
`__init__`, naming its ROADMAP item, as the CLI does: on a CUDA device a
hidden size above the kernels' maximum. Fleets of models are `train/fleet.FleetTrainer`,
whose one-lane fleet is this trainer. Checkpoints are saved on a background thread when
`train.async_checkpointing` (the default), else synchronously; the files
are the same (`train/checkpoint.py`), and `fit` drains the queue before it
returns. A resume or a rollback restores only a step that verifies against
its manifest, falling back to an older one.

A mesh (`Trainer(mesh=...)`, or `use_mesh=True` to build `config.mesh`'s
over the world; `config.mesh` alone builds none, as in the JAX package)
runs the step of `train/loop.MeshStep`: the dataset keeps this rank's
stock rows (`parallel/sharding.shard_dataset`, in place), each rank takes
its days of every update, and the parameters stay bitwise equal on every
rank. The composition is checked by `parallel/compose.validate`. Rank 0
writes the checkpoints, the best weights and the metrics stream (the other
ranks log nowhere); a resume or a rollback broadcasts what rank 0 restores
(`train/checkpoint.RankZeroCheckpointer`). The `shard_balance` record is
the rule tables' per-rank byte bill (`obs/memory.shard_balance_block`);
`comms_block()` is the collectives the last fit ran (`obs/comms.py`).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from factorvae_tpu_torch import chaos
from factorvae_tpu_torch.config import Config
from factorvae_tpu_torch.data.stream import epoch_chunks
from factorvae_tpu_torch.models.factorvae import FactorVAE
from factorvae_tpu_torch.obs.memory import watermark_event
from factorvae_tpu_torch.obs.metrics import export_epoch_metrics
from factorvae_tpu_torch.obs.probes import EVAL_PROBE_KEYS, TRAIN_PROBE_KEYS
from factorvae_tpu_torch.ops.kernels import hidden_refusal
from factorvae_tpu_torch.params import save_weights
from factorvae_tpu_torch.train.checkpoint import (
    Checkpointer,
    CheckpointIntegrityError,
    RankZeroCheckpointer,
)
from factorvae_tpu_torch.train.loop import MeshStep, check_remat, eval_epoch, train_epoch
from factorvae_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
    mixed_fields,
    resolve_train_dtype,
    seed_for,
    set_horizon,
    set_lr_scale,
)
from factorvae_tpu_torch.utils.logging import MetricsLogger, timeline_event, timeline_span
from factorvae_tpu_torch.utils.profiling import (
    maybe_profile_epoch,
    step_annotation,
    summarize_capture,
)

_TRAIN_NOISE, _EVAL_NOISE = 1, 2      # stream ids of seed_for


def init_train_state(model_cfg, train_cfg, total_steps: int, device) -> TrainState:
    """A run's first state: the model of `model_cfg` with weights drawn from
    `train_cfg.seed` (bitwise `load_model`'s), Adam with the cosine over
    `total_steps`, the train noise generator; when `model_cfg` computes in
    bfloat16 (a mixed run) also the loss scale at `loss_scale_init`."""
    model = FactorVAE(model_cfg)
    model.reset_parameters(torch.Generator().manual_seed(train_cfg.seed))
    model.to(device)
    optimizer, scheduler = make_optimizer(model.parameters(), train_cfg, total_steps)
    generator = torch.Generator(device=device).manual_seed(
        seed_for(train_cfg.seed, _TRAIN_NOISE))
    state = TrainState(model, optimizer, scheduler, generator)
    if model_cfg.compute_dtype != "float32":
        state = dataclasses.replace(state, **mixed_fields(train_cfg))
    return state


def profile_run_dir(logger) -> Optional[str]:
    """The directory polled for a `PROFILE_REQUEST`: the metrics stream's
    (None without one, so a run without a stream never stats the disk)."""
    path = getattr(logger, "jsonl_path", None)
    return os.path.dirname(os.path.abspath(path)) if path else None


def log_profile_capture(logger, epoch: int, prof: bool, prof_dir: Optional[str]) -> None:
    """The `profile_capture` record of an epoch that a `PROFILE_REQUEST`
    asked for: the capture's summary, or the error that kept it from
    starting."""
    if prof:
        logger.log("profile_capture", epoch=epoch, dir=prof_dir,
                   **summarize_capture(prof_dir, top=5))
    elif prof_dir:
        logger.log("profile_capture", epoch=epoch, error=prof_dir)


def eval_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The validation noise of epoch `epoch` of the run seeded `seed`."""
    return torch.Generator(device=device).manual_seed(seed_for(seed, _EVAL_NOISE, epoch))


def build_mesh(config: Config, mesh, use_mesh: bool):
    """The run's mesh: `mesh` when given, else `config.mesh`'s over the world
    when `use_mesh`, else None."""
    if mesh is not None or not use_mesh:
        return mesh
    from factorvae_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(config.mesh)


def is_rank_zero(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def barrier(mesh) -> None:
    """Wait for every rank of `mesh` (nothing without a group)."""
    world = None if mesh is None else mesh.axis("world")
    if world is not None and world.group is not None:
        import torch.distributed as dist

        dist.barrier(group=world.group)


class Trainer:
    def __init__(self, config: Config, dataset, device="cuda",
                 logger: Optional[MetricsLogger] = None, mesh=None,
                 use_mesh: bool = False):
        from factorvae_tpu_torch.parallel import compose

        self.cfg = config
        self.ds = dataset
        self.device = torch.device(device)
        self.mesh = build_mesh(config, mesh, use_mesh)
        self.logger = (logger or MetricsLogger(echo=False)) if is_rank_zero(self.mesh) \
            else MetricsLogger(echo=False)
        refused = hidden_refusal(config.model.hidden_size, self.device)
        if refused:
            raise ValueError(refused)
        if dataset.device.type != self.device.type:
            raise ValueError(f"the dataset lives on {dataset.device}, the trainer "
                             f"runs on {self.device}")
        compose.validate(mesh=self.mesh, residency=dataset.residency,
                         days_per_step=max(1, config.train.days_per_step),
                         stream_chunk_days=config.data.stream_chunk_days,
                         n_stocks=dataset.n_max)
        self.mesh_step = None
        if self.mesh is not None:
            from factorvae_tpu_torch.parallel.sharding import shard_dataset

            shard_dataset(self.mesh, dataset)
            self.mesh_step = MeshStep(self.mesh)
        self._comms_at_fit = None
        check_remat(config.train.remat)
        self.train_dtype = resolve_train_dtype(config.train, config.model)
        self.mixed = self.train_dtype != "float32"
        self.model_cfg = dataclasses.replace(config.model, compute_dtype=self.train_dtype)
        t = config.train
        self.loss_scale_cfg = (t.loss_scale_growth, t.loss_scale_backoff,
                               t.loss_scale_growth_interval, t.loss_scale_floor)
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
        self.last_checkpointer: Optional[Checkpointer] = None   # the last fit's
        # the peak lr's factor: the rollback recovery backs it off, and it
        # holds for later fits of this trainer, as in the JAX package
        self._lr_scale = 1.0
        self.logger.log(
            "execution_layout", flatten_days=config.model.flatten_days,
            days_per_step=self.batch_days, compute_dtype=self.train_dtype,
            model_compute_dtype=config.model.compute_dtype, mixed_precision=self.mixed,
            checkpoint_saves="async" if config.train.async_checkpointing else "synchronous",
            n_real=dataset.n_real, n_padded=dataset.n_max,
            dead_compute_frac=round(dataset.dead_compute_frac, 4),
            obs_probes=config.train.obs_probes, device=str(self.device),
            panel_residency="stream" if self.stream else "hbm",
            steps_per_chunk=self.steps_per_chunk if self.stream else None)
        if self.mesh is not None:
            from factorvae_tpu_torch.obs.memory import shard_balance_block

            from factorvae_tpu_torch.parallel.partition import abstract_state_tree

            self.logger.log("shard_balance", **shard_balance_block(
                self.mesh, state=abstract_state_tree(self.model_cfg, self.device, self.mixed),
                dataset=dataset))

    def init_state(self) -> TrainState:
        """A model with weights drawn from `train.seed` (bitwise
        `load_model`'s), Adam, the schedule and the noise generator; on a
        mixed run also the loss scale at `loss_scale_init`."""
        return init_train_state(self.model_cfg, self.cfg.train, self.total_steps,
                                self.device)

    def _order_np(self, days, shuffle: bool, epoch: int) -> np.ndarray:
        order = self.ds.epoch_order(days, shuffle=shuffle, seed=self.cfg.train.seed,
                                    epoch=epoch, pad_to=self.batch_days)
        return order.reshape(-1, self.batch_days).astype(np.int64)

    def _order(self, days, shuffle: bool, epoch: int) -> torch.Tensor:
        """The epoch's (steps, B) day order on the device (an "hbm" dataset's)."""
        return torch.as_tensor(self._order_np(days, shuffle, epoch), device=self.device)

    def _chunks(self, days, shuffle: bool, epoch: int):
        """The epoch's (dataset, order) chunks for `train_epoch`/`eval_epoch`."""
        return epoch_chunks(self.ds, self._order_np(days, shuffle, epoch),
                            self.steps_per_chunk, self._placement())

    def _placement(self):
        """The stream's mini-panel placement on a mesh, else None."""
        if self.mesh is None:
            return None
        from factorvae_tpu_torch.parallel.sharding import chunk_placement

        return chunk_placement(self.mesh)

    def _eval_generator(self, epoch: int) -> torch.Generator:
        return eval_generator(self.cfg.train.seed, epoch, self.device)

    def fit(self, state: Optional[TrainState] = None, resume: bool = False,
            num_epochs: Optional[int] = None, rescale_schedule: bool = False):
        """Train the first `num_epochs` epochs of the configured schedule
        (default: all of them; the cosine horizon stays the config's, so a
        partial run and its resume equal an unbroken run). With
        rescale_schedule=True, `num_epochs` is the whole run instead: the
        cosine decays to its floor at its end (a later fit without it goes
        back to the config's horizon). With resume=True and no `state`,
        continue from the newest checkpoint. Returns (state, {"history":
        [per-epoch records], "best_val": float})."""
        cfg, tcfg = self.cfg, self.cfg.train
        epochs = tcfg.num_epochs if num_epochs is None else num_epochs
        total = self.steps_per_epoch * (epochs if rescale_schedule else tcfg.num_epochs)
        if total != self.total_steps:
            self.total_steps = total
            if state is not None:
                set_horizon(state, tcfg, total)
        ckpt = None
        if tcfg.checkpoint_every and is_rank_zero(self.mesh):
            ckpt = Checkpointer(os.path.join(tcfg.save_dir,
                                             f"{cfg.checkpoint_name()}_ckpt"),
                                keep=tcfg.keep_checkpoints,
                                async_save=tcfg.async_checkpointing)
        world = None if self.mesh is None else self.mesh.axis("world")
        shared = ckpt
        if tcfg.checkpoint_every and world is not None and world.group is not None:
            shared = RankZeroCheckpointer(ckpt, world)
        from factorvae_tpu_torch.parallel.collective_ops import comm_counts

        self._comms_at_fit = comm_counts()
        self._fit_steps = 0
        try:
            return self._fit(state, resume, epochs, shared)
        finally:
            if shared is not None:
                shared.close()
            self.last_checkpointer = ckpt

    def _fit(self, state, resume: bool, epochs: int, ckpt):
        cfg, tcfg = self.cfg, self.cfg.train
        start_epoch, best_val = 0, float("inf")
        # the rollback anchor: the newest checkpoint saved at a clean epoch
        last_good_step: Optional[int] = None
        if state is None:
            state = self.init_state()
            if resume and ckpt is not None and ckpt.latest_step() is not None:
                meta = ckpt.restore(state)
                start_epoch = int(meta["epoch"]) + 1
                if meta.get("clean", True):
                    last_good_step = start_epoch - 1
                best_val = float(meta["best_val"])
                saved, now = meta.get("config"), cfg.to_dict()
                if saved is not None and saved != now:
                    self.logger.log(
                        "resume_config_mismatch",
                        sections=sorted(k for k in set(saved) | set(now)
                                        if saved.get(k) != now.get(k)),
                        note="resuming with a different config than the "
                             "checkpoint was written with")
                self.logger.log("resume", epoch=start_epoch, best_val=best_val)
        set_lr_scale(state, tcfg, self._lr_scale)
        recover_after = max(0, int(tcfg.recover_after))
        bad_streak = rollbacks = 0
        history = []
        probes = tcfg.obs_probes
        run_dir = profile_run_dir(self.logger)
        epoch = start_epoch
        while epoch < epochs:
            t0 = time.perf_counter()
            poison = chaos.fault("nan_grads", epoch=epoch) is not None
            chunks = self._chunks(self.train_days, True, epoch)
            with maybe_profile_epoch(run_dir, epoch) as (prof, prof_dir), \
                    step_annotation(f"train_epoch_{epoch}"), \
                    timeline_span(f"train_epoch_{epoch}", cat="train", resource="device",
                                  epoch=epoch):
                train_m = train_epoch(state, chunks, guard=tcfg.finite_guard, poison=poison,
                                      compute_dtype=self.model_cfg.dtype,
                                      loss_scale_cfg=self.loss_scale_cfg, probes=probes,
                                      remat=tcfg.remat, mesh=self.mesh_step)
            self._fit_steps += self.steps_per_epoch
            log_profile_capture(self.logger, epoch, prof, prof_dir)
            if self.stream:
                self.last_stream_stats = chunks
            rec = {"epoch": epoch, "train_loss": train_m["loss"],
                   "train_recon": train_m["recon"], "train_kl": train_m["kl"]}
            if len(self.val_days):
                with timeline_span(f"val_epoch_{epoch}", cat="eval", resource="device",
                                   epoch=epoch):
                    val_m = eval_epoch(state.model, self._chunks(self.val_days, False, 0),
                                       self._eval_generator(epoch), self.model_cfg.dtype,
                                       probes=probes, mesh=self.mesh_step)
                rec.update(val_loss=val_m["loss"], val_recon=val_m["recon"],
                           val_kl=val_m["kl"])
                selection = val_m["loss"]
            else:       # no validation split: select on the train loss
                rec.update(val_loss=float("nan"), val_recon=float("nan"),
                           val_kl=float("nan"))
                selection = train_m["loss"]
            seconds = time.perf_counter() - t0
            rec.update(lr=state.scheduler.get_last_lr()[0], step=state.step,
                       seconds=seconds, days_per_sec=train_m["days"] / max(seconds, 1e-9))
            for key in ("skipped_steps", "loss_scale", "loss_scale_floor_steps"):
                if key in train_m:
                    rec[key] = train_m[key]
            if probes:
                rec.update({k: train_m[k] for k in TRAIN_PROBE_KEYS})
                if len(self.val_days):
                    rec.update({"val_" + k: val_m[k] for k in EVAL_PROBE_KEYS})
            history.append(rec)
            self.logger.log("epoch", **rec)
            export_epoch_metrics(rec)
            watermark_event(epoch=epoch)

            # the recovery escalation: on f32 any skipped step (or, with the
            # probes, any non-finite gradient element) is a bad signal; a
            # mixed run expects about one overflow per growth of the scale,
            # and a scale at its floor has stopped learning
            skipped = train_m.get("skipped_steps", 0.0)
            if self.mixed:
                budget = self.steps_per_epoch // max(1, tcfg.loss_scale_growth_interval) + 1
                bad = (not np.isfinite(train_m["loss"]) or skipped > budget
                       or train_m["loss_scale"] <= tcfg.loss_scale_floor)
            else:
                bad = (not np.isfinite(train_m["loss"]) or skipped > 0
                       or train_m.get("nonfinite_grads", 0.0) > 0)
            bad_streak = bad_streak + 1 if bad else 0
            escalate = bool(recover_after and bad_streak >= recover_after)
            can_roll = (rollbacks < tcfg.recover_max_rollbacks and ckpt is not None
                        and last_good_step is not None)
            if escalate and not can_roll and bad_streak == recover_after:
                # nowhere to roll back to: back the lr off alone (unless the
                # rollback budget is what ran out) and say so, once a streak
                budget_spent = rollbacks >= tcfg.recover_max_rollbacks
                reason = (f"rollback budget spent ({rollbacks}/{tcfg.recover_max_rollbacks})"
                          if budget_spent
                          else "checkpointing disabled" if ckpt is None
                          else "no good-epoch checkpoint anchor yet")
                if not budget_spent:
                    self._lr_scale *= tcfg.recover_lr_backoff
                    set_lr_scale(state, tcfg, self._lr_scale)
                self.logger.log("recovery", kind="rollback_unavailable", epoch=epoch,
                                lr_scale=self._lr_scale,
                                note=f"{reason}; continuing with lr backoff only")
                timeline_event("recovery_rollback_unavailable", cat="recovery",
                               resource="recovery", epoch=epoch, reason=reason)
            if escalate and can_roll:
                rollbacks += 1
                bad_streak = 0
                self._lr_scale *= tcfg.recover_lr_backoff
                try:
                    ckpt.restore(state, step=last_good_step)
                    restored = last_good_step
                except (FileNotFoundError, CheckpointIntegrityError):   # evicted or corrupt
                    # the newest step that verifies (restore quarantines as it
                    # scans); with none left, go on forward
                    try:
                        restored = int(ckpt.restore(state)["epoch"])
                    except FileNotFoundError:
                        set_lr_scale(state, tcfg, self._lr_scale)
                        self.logger.log("recovery", kind="rollback_unavailable",
                                        epoch=epoch, lr_scale=self._lr_scale,
                                        note="no verifiable checkpoint to roll back to; "
                                             "continuing with lr backoff only")
                        epoch += 1
                        continue
                set_lr_scale(state, tcfg, self._lr_scale)
                self.logger.log("recovery", kind="rollback", epoch=epoch,
                                restored_step=restored, lr_scale=self._lr_scale,
                                rollbacks=rollbacks)
                timeline_event("recovery_rollback", cat="recovery", resource="recovery",
                               epoch=epoch, step=restored, lr_scale=self._lr_scale)
                epoch = restored + 1
                continue

            if selection < best_val:
                best_val = selection
                if is_rank_zero(self.mesh):
                    save_weights(state.model, cfg,
                                 os.path.join(tcfg.save_dir, cfg.checkpoint_name()))
                barrier(self.mesh)
            if ckpt is not None and (epoch % max(1, tcfg.checkpoint_every) == 0
                                     or epoch == epochs - 1):
                ckpt.save(epoch, state, {"epoch": epoch, "best_val": best_val,
                                         "config": cfg.to_dict(), "clean": not bad})
                if not bad:
                    last_good_step = epoch
            epoch += 1
        self.logger.log("best", best_val=best_val)
        return state, {"history": history, "best_val": best_val}

    def evaluate(self, model, start=None, end=None, seed: int = 0) -> dict:
        """Validation-style metrics of `model` over a date range (default:
        the validation split)."""
        days = self.ds.split_days(
            self.cfg.data.val_start_time if start is None else start,
            self.cfg.data.val_end_time if end is None else end)
        if len(days) == 0:
            raise ValueError("no trading days in the requested range")
        generator = torch.Generator(device=self.device).manual_seed(
            seed_for(seed, _EVAL_NOISE))
        return eval_epoch(model, self._chunks(days, False, 0), generator,
                          self.model_cfg.dtype, mesh=self.mesh_step)

    def comms_block(self) -> Optional[dict]:
        """The collectives of the last `fit` (`obs/comms.comms_block`), or
        None without a mesh."""
        if self.mesh is None or self._comms_at_fit is None:
            return None
        from factorvae_tpu_torch.obs.comms import comms_block
        from factorvae_tpu_torch.parallel.collective_ops import comm_counts

        return comms_block(comm_counts(), self._comms_at_fit, mesh=self.mesh,
                           steps=self._fit_steps, steps_per_epoch=self.steps_per_epoch)

    def score(self, model, start=None, end=None, **kw):
        """Prediction scores DataFrame (`eval.predict.generate_prediction_scores`),
        on the trainer's mesh when it has one."""
        from factorvae_tpu_torch.eval.predict import generate_prediction_scores

        kw.setdefault("mesh", self.mesh)
        return generate_prediction_scores(model, self.cfg, self.ds, start=start,
                                          end=end, **kw)
