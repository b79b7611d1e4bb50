"""The walk-forward operator (`factorvae_tpu/wf/operator.py`).

One nightly cycle, run as a journaled state machine over the port's
subsystems:

    append   the incoming days land in the `PanelStore` (each slab
             sha256-checked before its commit) and reach the serving panel
             in place (`ScoringDaemon.extend_dataset` ->
             `PanelDataset.extend_days`: no reload)
    judge    the incumbent scores the day before the append and each new
             day through the daemon, which feeds `obs/drift`'s day-over-day
             rank correlation; a correlation below the model's threshold
             triggers a refit, as do `force_refit` (retrain every night)
             and a serving failure on a new day
    refit    warm-started from the incumbent's full-state checkpoint
             (`train/checkpoint.Checkpointer`: its weights, a fresh
             optimizer and schedule), trained on the grown panel up to the
             holdout days; with `cold_ab` a cold fit races it on holdout
             Rank-IC
    promote  `ScoringDaemon.admit`: the candidate is admitted under its
             config hash and the fidelity gate (candidate against incumbent
             Rank-IC on the holdout days) decides; a winner flips the alias
             under the tick lock, so requests in flight finish on the
             incumbent and none is dropped
    verify   the first score served behind the alias closes the cycle

Every stage's result is committed to the cycle journal (`wf/journal.py`),
so a SIGKILL at any boundary resumes: committed stages replay their
recorded results and the uncommitted one runs again. The append is
idempotent per slab, the refit resumes bitwise from the candidate's own
checkpoints, and the promotion re-admits the same bytes. The chaos kinds
`kill_mid_append`, `corrupt_append_slab`, `kill_mid_refit` (here, `step` 0
before the fit and 1 after it, before the journal commit),
`kill_between_admit_and_drain` and `fidelity_gate_reject` pin these
windows.

A cycle is one trace tree: its root is `wf-<cycle id>`, each stage a child
span, and the daemon requests and admissions a stage makes carry the
stage's context (`obs/trace`).

A no-fault cycle's refit parameters are bitwise a plain `warm_refit` on the
grown panel: the operator adds journaling around the fit, no arithmetic in
it. The refit builds its `Trainer` from the caller's config, so it trains
under the caller's `train.remat` and refuses what `Trainer` refuses as a
`WalkForwardError`. A config whose mesh block asks for more than one rank
is refused too, naming its ROADMAP item: the JAX walk-forward builds no
mesh, so the port has none to hold a mesh refit against.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import List, Optional

import numpy as np
import torch

from factorvae_tpu_torch import chaos
from factorvae_tpu_torch.chaos import ops as chaos_ops
from factorvae_tpu_torch.config import Config
from factorvae_tpu_torch.data.append import PanelStore
from factorvae_tpu_torch.data.panel import Panel
from factorvae_tpu_torch.obs.trace import child, root_ctx, span_fields
from factorvae_tpu_torch.utils.logging import MetricsLogger, timeline_span
from factorvae_tpu_torch.wf.journal import CycleJournal


class WalkForwardError(RuntimeError):
    """Operator-level failure with a one-line actionable message."""


# ---------------------------------------------------------------------------
# refit primitives (module-level, so a plain call can be held against the
# operator's refit)
# ---------------------------------------------------------------------------


def holdout_day_indices(dataset, n: int = 1) -> List[int]:
    """The newest `n` day indices with at least 3 finite labels: the
    holdout the fidelity gate judges on (`eval.metrics.labeled_holdout_days`)."""
    from factorvae_tpu_torch.eval.metrics import labeled_holdout_days

    days = labeled_holdout_days(dataset, n)
    if not days:
        raise WalkForwardError(
            "no day with >=3 finite labels in the panel; the fidelity gate cannot "
            "judge Rank-IC: check the label column")
    return days


def _trainer(config: Config, dataset, logger, device):
    from factorvae_tpu_torch.train.trainer import Trainer

    if config.mesh.stock_axis > 1 or config.mesh.data_axis > 1:
        raise WalkForwardError(
            f"the refit builds no mesh (mesh.stock_axis={config.mesh.stock_axis}, "
            f"mesh.data_axis={config.mesh.data_axis}): a walk-forward on a mesh is not "
            "ported to factorvae_tpu_torch (ROADMAP Queue 1 item 16)")
    try:
        return Trainer(config, dataset, device=device, logger=logger)
    except NotImplementedError as e:
        raise WalkForwardError(
            f"the refit trains with the operator's config, which the port's Trainer "
            f"refuses: {e}") from None


def warm_refit(config: Config, dataset, warm_params: Optional[dict] = None,
               resume: bool = False, logger: Optional[MetricsLogger] = None,
               device=None):
    """One refit: a fresh `Trainer` over `dataset` on `device` (default:
    the dataset's), started from the state_dict `warm_params` with a fresh
    optimizer and schedule (yesterday's weights, today's optimization), or
    cold when None.

    `resume=True` continues from the config's own checkpoints when any
    exist (a refit killed part-way: the per-epoch full-state checkpoints
    make the continuation bitwise); with none on disk it is the plain warm
    or cold start, so a kill before the first checkpoint is a plain re-run.

    Returns (state, fit_info, best_weights_dir)."""
    from factorvae_tpu_torch.train.checkpoint import Checkpointer

    device = dataset.device if device is None else device
    trainer = _trainer(config, dataset, logger, device)
    has_ckpt = False
    if resume and config.train.checkpoint_every:
        ck = Checkpointer(os.path.join(config.train.save_dir,
                                       config.checkpoint_name() + "_ckpt"),
                          keep=config.train.keep_checkpoints,
                          async_save=config.train.async_checkpointing)
        try:
            has_ckpt = ck.latest_step() is not None
        finally:
            ck.close()
    if has_ckpt:
        state, info = trainer.fit(resume=True)
    else:
        start = trainer.init_state()
        if warm_params is not None:
            start.model.load_state_dict(warm_params)
        state, info = trainer.fit(state=start)
    weights = os.path.join(config.train.save_dir, config.checkpoint_name())
    return state, info, weights


def refit_rank_ic(model: torch.nn.Module, config: Config, dataset,
                  days: List[int], seed: int = 0) -> float:
    """Holdout Rank-IC of a refit candidate's model (deterministic scores;
    the masked Spearman the promotion gate judges with)."""
    from factorvae_tpu_torch.eval.metrics import panel_rank_ic
    from factorvae_tpu_torch.eval.predict import predict_panel

    days = np.asarray(days, np.int64)
    scores = predict_panel(model, config, dataset, days, stochastic=False, seed=seed)
    return panel_rank_ic(scores, dataset.day_labels(days), dataset.valid[days])


def _date(d) -> str:
    return str(np.datetime64(d, "D"))


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------


class WalkForwardOperator:
    """Runs nightly cycles against a live (store, dataset, daemon) triple.
    The daemon may serve traffic from other threads the whole time: the
    operator changes shared state only through the daemon's tick lock
    (`extend_dataset`, `admit`). The refits train on `device` (default: the
    dataset's)."""

    def __init__(self, store: PanelStore, dataset, daemon, config: Config,
                 run_dir: str, alias: str = "prod",
                 journal: Optional[CycleJournal] = None,
                 refit_epochs: Optional[int] = None, cold_ab: bool = False,
                 force_refit: bool = False, min_margin: float = 0.0,
                 drift_threshold: Optional[float] = None, holdout_days: int = 1,
                 window_days: int = 0, keep_cycles: int = 2,
                 logger: Optional[MetricsLogger] = None, device=None):
        self.store = store
        self.dataset = dataset
        self.daemon = daemon
        self.config = config
        self.run_dir = os.path.abspath(run_dir)
        self.alias = alias
        self.journal = journal or CycleJournal(os.path.join(
            self.run_dir, f"{config.train.run_name}_wf.json"))
        self.refit_epochs = refit_epochs
        self.cold_ab = bool(cold_ab)
        self.force_refit = bool(force_refit)
        self.min_margin = float(min_margin)
        self.drift_threshold = drift_threshold
        self.holdout_days = max(1, int(holdout_days))
        self.window_days = max(0, int(window_days))
        self.keep_cycles = max(1, int(keep_cycles))
        self.logger = logger or MetricsLogger(echo=False)
        self.device = dataset.device if device is None else torch.device(device)
        # the in-flight stage's trace context, read by the stages that call
        # the daemon so its spans join the cycle's tree
        self._stage_ctx: Optional[dict] = None

    # ---- cycle identity / configs ------------------------------------------

    def next_cycle_id(self) -> str:
        """The open cycle's id, else the next generation's: cycle N appends
        the store's Nth slab, so the id is known before and after the
        append commits."""
        cur = self.journal.open_cycle()
        if cur is not None:
            return cur["id"]
        return f"c{self.store.generation + 1:05d}"

    def cycle_dir(self, cycle_id: str) -> str:
        return os.path.join(self.run_dir, "cycles", cycle_id)

    def _candidate_config(self, cycle_id: str, cold: bool = False) -> Config:
        """The refit's Config: the same architecture, a save_dir per cycle
        (so candidate and incumbent coexist in the registry for the gate),
        splits on the grown panel: train up to the holdout, validate on the
        holdout tail, from `window_days` before it when set."""
        ds = self.dataset
        hold = holdout_day_indices(ds, self.holdout_days)
        fit_end = _date(ds.dates[hold[0] - 1]) if hold[0] > 0 else None
        start = self.config.data.start_time
        if self.window_days:
            start = _date(ds.dates[max(0, hold[0] - self.window_days)])
        save_dir = self.cycle_dir(cycle_id)
        if cold:
            save_dir = os.path.join(save_dir, "cold")
        train_kw = dict(save_dir=save_dir, checkpoint_every=1)
        if self.refit_epochs is not None:
            train_kw["num_epochs"] = int(self.refit_epochs)
        return dataclasses.replace(
            self.config,
            data=dataclasses.replace(self.config.data, start_time=start,
                                     fit_end_time=fit_end,
                                     val_start_time=_date(ds.dates[hold[0]]),
                                     val_end_time=None),
            train=dataclasses.replace(self.config.train, **train_kw))

    # ---- bootstrap ---------------------------------------------------------

    def ensure_incumbent(self, epochs: Optional[int] = None) -> str:
        """A model behind the alias: the journaled incumbent re-admitted (a
        fresh process after a crash), else one trained on the current panel
        and admitted unconditionally. Returns the serving key."""
        from factorvae_tpu_torch.serve.registry import RegistryError

        try:
            return self.daemon.registry.resolve_key(self.alias)
        except RegistryError:
            pass        # nothing behind the alias yet
        path = self.journal.get_meta("incumbent_path")
        if path and os.path.isdir(path):
            resp = self.daemon.admit(path, self.alias, drift_threshold=self.drift_threshold)
            return resp["model"]
        cfg = dataclasses.replace(
            self.config,
            train=dataclasses.replace(
                self.config.train, save_dir=os.path.join(self.run_dir, "incumbent"),
                checkpoint_every=1, **({"num_epochs": int(epochs)} if epochs else {})))
        self.logger.log("wf_bootstrap", run=cfg.train.run_name,
                        epochs=cfg.train.num_epochs)
        with timeline_span("wf_bootstrap", cat="wf", resource="wf"):
            _, _, weights = warm_refit(cfg, self.dataset, warm_params=None, resume=True,
                                       logger=self.logger, device=self.device)
        resp = self.daemon.admit(weights, self.alias, drift_threshold=self.drift_threshold)
        self.journal.set_meta("incumbent_path", weights)
        return resp["model"]

    # ---- stages ------------------------------------------------------------

    def _trace_field(self) -> Optional[dict]:
        """The in-flight stage's wire trace context ({"trace_id",
        "span_id"}) for a daemon request's `trace` field or an admission's
        `trace=`; None outside `run_cycle`."""
        ctx = self._stage_ctx
        if ctx is None:
            return None
        return {"trace_id": ctx["trace_id"], "span_id": ctx["span_id"]}

    def _stage_append(self, incoming: Panel) -> dict:
        rec = self.store.append_panel(incoming)
        # the serving pickup, under the tick lock; a no-op when the resumed
        # dataset (built from the store after the append) holds the days
        self.daemon.extend_dataset(incoming)
        return dict(rec, n_days_total=int(len(self.dataset.dates)))

    def _stage_judge(self, incoming: Panel) -> dict:
        """Serve the day before the append and each appended day with the
        incumbent through the daemon (the drift chain advances as traffic
        would advance it), then read the drift verdict. The same days in
        the same order rebuild the same chain in a fresh process."""
        dates = np.asarray(self.dataset.dates)
        first = np.datetime64(incoming.dates[0], "D")
        hit = np.nonzero(dates == first)[0]
        if hit.size == 0:
            raise WalkForwardError(
                f"judge: appended day {_date(first)} is not in the serving panel: the "
                "append stage did not commit; resume the cycle")
        first_new = int(hit[0])
        days = [d for d in range(first_new - 1, len(dates)) if d >= 0]
        inc_key = self.daemon.registry.resolve_key(self.alias)
        tf = self._trace_field()
        failures = 0
        for day in days:
            req = {"model": self.alias, "day": day}
            if tf is not None:
                req["trace"] = tf
            if not self.daemon.handle(req).get("ok"):
                failures += 1
        drift = self.daemon.drift.stats().get(inc_key, {})
        drifting = bool(self.daemon.drift.drifting(inc_key))
        trigger = bool(self.force_refit or drifting or failures)
        reasons = [r for r, hit in (("force_refit", self.force_refit),
                                    ("score_drift", drifting),
                                    ("serving_failures", failures > 0)) if hit]
        return {"trigger": trigger, "reason": "+".join(reasons) or "no_drift",
                "rank_corr": drift.get("last_rank_corr"),
                "threshold": self.daemon.drift.threshold_for(inc_key),
                "incumbent": inc_key, "days_served": len(days), "failures": failures}

    def _warm_params(self, template_state) -> dict:
        """The incumbent's weights as the warm start: from its full-state
        checkpoint when one exists (restored into `template_state`), else
        the serving entry's own tensors."""
        from factorvae_tpu_torch.train.checkpoint import Checkpointer

        entry = self.daemon.registry.get(self.alias)
        ck_dir = (entry.source_path or "") + "_ckpt"
        if entry.source_path and os.path.isdir(ck_dir):
            ck = Checkpointer(ck_dir, async_save=False)
            try:
                ck.restore(template_state)
            finally:
                ck.close()
            return {k: v.detach().clone() for k, v in template_state.model.state_dict().items()}
        if entry.model is None or entry.qparams is not None:
            raise WalkForwardError(
                f"incumbent {entry.key} has neither a full-state checkpoint at {ck_dir} "
                "nor float weights in memory to warm-start from")
        return entry.params

    def _stage_refit(self, cycle_id: str) -> dict:
        cand_cfg = self._candidate_config(cycle_id)
        fresh = not self.journal.marked("refit_started")
        if fresh:
            # wipe, then mark: the mark covers only this cycle's files, so a
            # marked resume never adopts an earlier cycle's checkpoints
            shutil.rmtree(self.cycle_dir(cycle_id), ignore_errors=True)
            self.journal.mark("refit_started")
        if chaos.fault("kill_mid_refit", step=0) is not None:
            chaos_ops.kill_now()
        template = _trainer(cand_cfg, self.dataset, self.logger, self.device).init_state()
        warm_params = self._warm_params(template)
        hold = holdout_day_indices(self.dataset, self.holdout_days)
        with timeline_span("wf_refit_warm", cat="wf", resource="wf"):
            state, info, weights = warm_refit(cand_cfg, self.dataset,
                                              warm_params=warm_params, resume=not fresh,
                                              logger=self.logger, device=self.device)
        result = {
            "holdout_days": hold,
            "warm": {"best_val": float(info["best_val"]),
                     "rank_ic": refit_rank_ic(state.model, cand_cfg, self.dataset, hold),
                     "path": weights, "epochs": len(info["history"])},
            "cold": None, "winner": "warm",
        }
        if self.cold_ab:
            cold_cfg = self._candidate_config(cycle_id, cold=True)
            with timeline_span("wf_refit_cold", cat="wf", resource="wf"):
                cstate, cinfo, cweights = warm_refit(
                    cold_cfg, self.dataset, warm_params=None, resume=not fresh,
                    logger=self.logger, device=self.device)
            result["cold"] = {
                "best_val": float(cinfo["best_val"]),
                "rank_ic": refit_rank_ic(cstate.model, cold_cfg, self.dataset, hold),
                "path": cweights, "epochs": len(cinfo["history"])}
            warm_ic, cold_ic = result["warm"]["rank_ic"], result["cold"]["rank_ic"]
            # the cold fit takes the candidacy only by strictly beating warm
            if np.isfinite(cold_ic) and (not np.isfinite(warm_ic) or cold_ic > warm_ic):
                result["winner"] = "cold"
        result["path"] = result[result["winner"]]["path"]
        if chaos.fault("kill_mid_refit", step=1) is not None:
            chaos_ops.kill_now()
        return result

    def _stage_promote(self, refit: dict) -> dict:
        resp = self.daemon.admit(refit["path"], self.alias,
                                 holdout_days=refit.get("holdout_days"),
                                 min_margin=self.min_margin,
                                 drift_threshold=self.drift_threshold,
                                 trace=self._trace_field())
        if resp.get("promoted"):
            self.journal.set_meta("incumbent_path", refit["path"])
        keep = ("promoted", "model", "incumbent", "reason", "candidate_rank_ic",
                "incumbent_rank_ic", "alias", "generation")
        return {k: resp[k] for k in keep if k in resp}

    def _stage_verify(self) -> dict:
        """The first score served from whatever stands behind the alias now:
        the serving plane answering closes the cycle."""
        day = int(self.dataset.split_days(None, None)[-1])
        req = {"model": self.alias, "day": day}
        tf = self._trace_field()
        if tf is not None:
            req["trace"] = tf
        resp = self.daemon.handle(req)
        if not resp.get("ok"):
            raise WalkForwardError(
                f"verify: serving the newest day failed ({resp.get('error')}); the cycle "
                "stays open: fix the daemon and resume")
        return {"day": day, "date": _date(self.dataset.dates[day]), "model": resp["model"],
                "n": resp["n"], "latency_ms": resp.get("latency_ms")}

    # ---- the cycle ---------------------------------------------------------

    def run_cycle(self, incoming: Panel) -> dict:
        """Run (or resume) one cycle over `incoming` (the new days). Returns
        a summary with each stage's result and seconds; committed stages
        replay their journaled results."""
        cycle_id = self.next_cycle_id()
        # the trace id derives from the journal's cycle counter, so a resumed
        # cycle rejoins the same trace
        trace_root = root_ctx(f"wf-{cycle_id}", "cycle")
        self.journal.begin_cycle(cycle_id, start=_date(incoming.dates[0]),
                                 end=_date(incoming.dates[-1]),
                                 days=int(incoming.num_days))
        walls, ran = {}, {}

        def stage(name, fn, *args):
            done = self.journal.committed(name)
            if done is not None:
                ran[name] = False
                return done
            t0 = time.perf_counter()
            self._stage_ctx = child(trace_root, name)
            try:
                with timeline_span(f"wf_{name}", cat="wf", resource="wf", cycle=cycle_id,
                                   **span_fields(self._stage_ctx)):
                    result = fn(*args)
            finally:
                self._stage_ctx = None
            walls[name] = round(time.perf_counter() - t0, 4)
            ran[name] = True
            self.logger.log("wf_stage", cycle=cycle_id, stage=name, wall_s=walls[name],
                            **{k: v for k, v in result.items()
                               if isinstance(v, (int, float, str, bool, type(None)))})
            return self.journal.commit(name, dict(result, wall_s=walls[name]))

        with timeline_span("wf_cycle", cat="wf", resource="wf", cycle=cycle_id,
                           **span_fields(trace_root)):
            append = stage("append", self._stage_append, incoming)
            judge = stage("judge", self._stage_judge, incoming)
            if judge["trigger"]:
                refit = stage("refit", self._stage_refit, cycle_id)
                promote = stage("promote", self._stage_promote, refit)
            else:
                refit = stage("refit", lambda: {"skipped": True})
                promote = stage("promote", lambda: {"skipped": True, "promoted": False})
            verify = stage("verify", self._stage_verify)
        self.journal.finish_cycle()
        self._cleanup_cycles()
        summary = {
            "cycle": cycle_id, "triggered": bool(judge["trigger"]),
            "promoted": bool(promote.get("promoted")),
            "stages": {"append": append, "judge": judge, "refit": refit,
                       "promote": promote, "verify": verify},
            "walls": walls, "ran": ran,
        }
        if ran.get("refit") and ran.get("verify") and not refit.get("skipped"):
            # refit start -> the first score served by the rolled-over model
            summary["refit_to_serve_s"] = round(
                sum(walls.get(s, 0.0) for s in ("refit", "promote", "verify")), 4)
        self.logger.log("wf_cycle", **{k: v for k, v in summary.items()
                                       if isinstance(v, (int, float, str, bool, type(None)))})
        return summary

    def _cleanup_cycles(self) -> None:
        """Drop old per-cycle candidate workspaces, keeping the newest
        `keep_cycles` and whatever holds the journaled incumbent."""
        root = os.path.join(self.run_dir, "cycles")
        try:
            dirs = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        except OSError:
            return
        incumbent = self.journal.get_meta("incumbent_path") or ""
        for d in dirs[:-self.keep_cycles]:
            full = os.path.join(root, d)
            if incumbent.startswith(full + os.sep):
                continue
            shutil.rmtree(full, ignore_errors=True)
