"""Population-based training over a hyper-fleet (`factorvae_tpu/train/pbt.py`).

One `FleetTrainer`, G generations: every lane trains its own (lr,
kl_weight) as run-time scalars of the hyper-fleet, and between generations
the losers take a winner's weights and perturbed scalars.

- **Fitness**: each lane's validation loss of the generation's last epoch
  (its train loss without a validation split).
- **Exploit**: a losing lane takes a winner's state: the winner's last
  lockstep checkpoint is saved into the loser's checkpoint directory, and
  the next generation's `fit(resume=True)` restores it through the group
  resume.
- **Explore**: deterministic: the loser's scalars are the winner's times
  `PERTURB_FACTORS[(generation + lane) % n]`, clipped to `LR_BOUNDS` and
  `KL_WEIGHT_BOUNDS` (no random draw, so a resumed run takes the same walk).
  The worst `EXPLOIT_FRAC` of the lanes (at least one, at most half) are
  the losers. These are the JAX `pbt_fit`'s defaults.

The controller writes `{generation, per-lane scalars}` to
`<save_dir>/<run_name>_pbt.json` after every generation (a rename, so it is
never half written). `pbt_fit(..., resume=True)` restores the scalars and
every lane's checkpoint and continues bitwise as the unbroken run.

On a mesh the lanes lie over 'data' (`train/fleet.py`), so a winner and
its loser may sit on different ranks. Every rank ranks the whole
population: the fitness is the fleet's record, gathered over 'data' with
`parallel/collective_ops` (counted in the comms block). Every rank applies
`set_lane_scalars` (each holds every lane's config; the loser's owner
trains with it). The exploit reads the winner's checkpoint row after a
barrier that follows every writer's `close_checkpoints()`; the loser's
writer (its rank's 'stock' index 0) writes the row into the loser's
directory. World rank 0 writes the state file once the exploit rows have
landed, and every rank waits for it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np

from factorvae_tpu_torch.config import Config
from factorvae_tpu_torch.train.fleet import FleetTrainer
from factorvae_tpu_torch.train.trainer import is_rank_zero
from factorvae_tpu_torch.utils.logging import MetricsLogger


EXPLOIT_FRAC = 0.25
PERTURB_FACTORS = (0.8, 1.25)
LR_BOUNDS = (1e-6, 1e-1)
KL_WEIGHT_BOUNDS = (1e-4, 10.0)


def perturb_factor(generation: int, lane: int) -> float:
    """The factor that multiplies a losing lane's scalars at `generation`."""
    return PERTURB_FACTORS[(int(generation) + int(lane)) % len(PERTURB_FACTORS)]


def pbt_state_path(config: Config) -> str:
    return os.path.join(config.train.save_dir, f"{config.train.run_name}_pbt.json")


def _write_pbt_state(path: str, generation: int, lanes: list) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"generation": generation, "lanes": lanes}, f, indent=1)
    os.replace(tmp, path)


def _with_scalars(c: Config, lr: float, kl_weight: float) -> Config:
    return dataclasses.replace(c, model=dataclasses.replace(c.model, kl_weight=kl_weight),
                               train=dataclasses.replace(c.train, lr=lr))


def pbt_fit(config: Config, dataset, lane_configs: Sequence[Config], generations: int,
            epochs_per_generation: int, logger: Optional[MetricsLogger] = None,
            resume: bool = False, stop_after: Optional[int] = None, device="cuda",
            mesh=None):
    """G generations of population-based training over one hyper-fleet.

    `lane_configs` seeds the population (per-lane lr, kl_weight and seed;
    `validate_lane_configs` applies). `train.num_epochs` becomes
    `generations * epochs_per_generation` (the cosine horizon of the whole
    run), and `checkpoint_every` must be at least 1: the lockstep per-lane
    checkpoints carry the exploit and the resume. `stop_after=g` ends the
    run after generation g (exploit, explore and the state file included),
    as a kill at a generation boundary would; a later `resume=True` call
    continues where it stopped.

    Returns (trainer, result): result holds the per-generation records
    (fitness, winners, exploited lanes, the scalars' walk), the final lane
    configs, state, best_val and best_params.

    `mesh` trains the population on a mesh: its lanes over 'data', each
    lane's rows over 'stock' (the module docstring). The records are the
    same on every rank."""
    logger = logger or MetricsLogger(echo=False)
    generations, epg = int(generations), int(epochs_per_generation)
    if generations < 1 or epg < 1:
        raise ValueError("need generations >= 1 and epochs_per_generation >= 1")
    total_epochs = generations * epg
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, num_epochs=total_epochs))
    if not config.train.checkpoint_every:
        raise ValueError("PBT needs checkpoint_every >= 1: the lockstep per-lane "
                         "checkpoints carry the exploit step and the resume")
    lane_cfgs = [dataclasses.replace(c, train=dataclasses.replace(
        c.train, num_epochs=total_epochs)) for c in lane_configs]
    state_path = pbt_state_path(config)
    start_gen = 0
    if resume and os.path.exists(state_path):
        with open(state_path) as f:
            saved = json.load(f)
        if len(saved.get("lanes", [])) != len(lane_cfgs):
            raise ValueError(f"PBT state at {state_path} has {len(saved.get('lanes', []))} "
                             f"lanes; this run has {len(lane_cfgs)}: the population size "
                             "cannot change across a resume")
        start_gen = int(saved["generation"])
        lane_cfgs = [_with_scalars(c, float(s["lr"]), float(s["kl_weight"]))
                     for c, s in zip(lane_cfgs, saved["lanes"])]
        logger.log("pbt_resume", generation=start_gen, lanes=saved["lanes"])

    # force_hyper: a homogeneous population would fold to baked scalars, and
    # the first explore step would have no run-time scalar to move
    trainer = FleetTrainer(config, dataset, lane_configs=lane_cfgs, device=device,
                           logger=logger, force_hyper=True, mesh=mesh)
    num_lanes = len(trainer.all_lane_cfgs)
    n_exploit = max(1, int(round(num_lanes * EXPLOIT_FRAC))) if num_lanes > 1 else 0
    n_exploit = min(n_exploit, num_lanes // 2)

    gen_records = []
    state = out = None
    for gen in range(start_gen, generations):
        state, out = trainer.fit(num_epochs=(gen + 1) * epg, resume=(gen > 0 or resume))
        last = out["history"][-1] if out["history"] else None
        if last is not None:
            val = np.asarray(last["val_loss"], np.float64)
            fitness = val if np.isfinite(val).any() else np.asarray(last["train_loss"],
                                                                    np.float64)
        else:
            # resumed at the generation's last epoch (killed after its last
            # checkpoint, before the state file): the fitness of the
            # restored weights with the last epoch's validation noise
            fitness = np.asarray(trainer.evaluate_lanes(state, (gen + 1) * epg - 1)
                                 or out["best_val"], np.float64)
        # NaN lanes rank last: a diverged lane is an exploit target, never a winner
        order = np.argsort(np.where(np.isfinite(fitness), fitness, np.inf), kind="stable")
        winners = [int(i) for i in order[:max(1, n_exploit)]]
        losers = [int(i) for i in order[-n_exploit:]] if n_exploit else []
        rec = {"generation": gen, "epochs": [gen * epg, (gen + 1) * epg],
               "fitness": [float(v) for v in fitness],
               "lane_labels": trainer.all_lane_labels(), "winners": winners,
               "exploited": []}
        if gen < generations - 1 and losers:
            gather_epoch = (gen + 1) * epg - 1
            # every writer's rows have landed before any rank reads a winner's
            trainer.close_checkpoints()
            trainer._barrier()
            for j, loser in enumerate(losers):
                winner = winners[j % len(winners)]
                if loser == winner:
                    continue
                f = perturb_factor(gen, loser)
                w_cfg = trainer.all_lane_cfgs[winner]
                new_lr = float(np.clip(w_cfg.train.lr * f, *LR_BOUNDS))
                new_klw = float(np.clip(w_cfg.model.kl_weight * f, *KL_WEIGHT_BOUNDS))
                trainer.set_lane_scalars(loser, lr=new_lr, kl_weight=new_klw)
                # exploit: the winner's checkpoint row into the loser's
                # directory, by the loser's writer
                if trainer.owns(loser) and trainer._writer:
                    row = trainer.init_lane_state(loser - trainer.lanes.start)
                    trainer.lane_checkpointer(winner).restore(row, step=gather_epoch)
                    trainer.lane_checkpointer(loser).save(
                        gather_epoch, row,
                        {"epoch": gather_epoch, "best_val": float(out["best_val"][loser]),
                         "config": trainer.all_lane_cfgs[loser].to_dict(),
                         "clean": True})
                rec["exploited"].append({"lane": loser, "from": winner,
                                         "perturb_factor": f, "lr": new_lr,
                                         "kl_weight": new_klw})
        gen_records.append(rec)
        trainer.close_checkpoints()      # the exploit rows land before the state file
        trainer._barrier()
        finite = fitness[np.isfinite(fitness)]
        logger.log("pbt_generation", **{k: v for k, v in rec.items() if k != "fitness"},
                   best_fitness=float(finite.min()) if finite.size else float("nan"))
        if is_rank_zero(trainer.mesh):
            _write_pbt_state(state_path, gen + 1,
                             [{"lr": c.train.lr, "kl_weight": c.model.kl_weight}
                              for c in trainer.all_lane_cfgs])
        trainer._barrier()
        if stop_after is not None and gen >= stop_after:
            logger.log("pbt_stopped", after_generation=gen)
            break
    return trainer, {
        "generations": gen_records, "lane_configs": list(trainer.all_lane_cfgs),
        "state": state,
        "best_val": out["best_val"] if out is not None else None,
        "best_params": out["best_params"] if out is not None else None,
    }
