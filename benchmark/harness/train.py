"""The "train" traffic kind: `Trainer.fit`, epoch after epoch, until the
window closes.

Set-up builds the trainer and its state (the benchmark's weights copied in),
drives that state through the traffic's first `check_steps` steps with the
trainer's own step function on its own dataset, on day batches drawn from
the seed whose days all differ, and records what the check compares: each
step's loss, each leaf's first gradient as Adam holds it after step 1
(exp_avg / (1 - beta1)) and each leaf's change after the last check step.
A validation pass warms the evaluation's shapes. The window then runs
`Trainer.fit` on that same state: every epoch trains on the training split
in `days_per_step` batches, validates on the validation split and writes
its best weights and checkpoint under the run's TMPDIR. The window closes
at the first epoch's end past `--seconds`; its rate counts the valid
training windows of the epochs done over all of the window's time.
"""

from __future__ import annotations

import tempfile
import time
from typing import Optional

import numpy as np
import torch

from benchmark.harness import common
from benchmark.harness.seeds import rng

CHECK_DAYS_STREAM = 13
BETA1 = 0.9
#: a leaf whose first reference gradient is under this share of the median
#: leaf's is zero to rounding (the portfolio's bias, whose shift the softmax
#: over stocks cancels); Adam moves it by round-off alone, so `change_gap`
#: leaves it out
ROUNDING_SHARE = 1e-6


class WindowClosed(Exception):
    """Raised at the first epoch record after the deadline."""


def window_logger(deadline_box: list, marks: list):
    """A `MetricsLogger` that notes the time of each epoch record and ends
    the fit at the first one past `deadline_box[0]`."""
    from factorvae_tpu_torch.utils.logging import MetricsLogger

    class _Logger(MetricsLogger):
        def log(self, event, _echo=None, **fields):
            super().log(event, _echo=_echo, **fields)
            if event == "epoch":
                now = time.perf_counter()
                marks.append((now, fields))
                if deadline_box[0] is not None and now >= deadline_box[0]:
                    raise WindowClosed()

    return _Logger(echo=False)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from factorvae_tpu_torch.train.trainer import Trainer

        self.traffic, self.seed, self.device = traffic, seed, device
        self.inputs = common.Inputs(config, seed, device)
        self.b = traffic["days_per_step"]
        self.tmp = tempfile.TemporaryDirectory(prefix="bench_train_")
        self.cfg = common.program_config(config, dict(
            seed=seed, days_per_step=self.b, num_epochs=traffic["num_epochs"],
            lr=traffic["lr"], save_dir=self.tmp.name))
        self.ds = self.inputs.dataset()
        self.deadline = [None]
        self.marks: list = []
        self.trainer = Trainer(self.cfg, self.ds, device=device,
                               logger=window_logger(self.deadline, self.marks))
        self.state = self.trainer.init_state()
        w0 = self.inputs.weights()
        with torch.no_grad():
            for name, p in self.state.model.named_parameters():
                p.copy_(w0[name])
        draw = rng(seed, CHECK_DAYS_STREAM)
        steps = traffic["check_steps"]
        self.check_days = draw.choice(self.inputs.train_days, size=(steps, self.b),
                                      replace=False)
        self.prog = self._check_steps(w0)
        del w0
        self.trainer.evaluate(self.state.model)
        self.windows_per_epoch = int(self.inputs.valid_np[self.inputs.train_days].sum())

    def _check_steps(self, w0: dict) -> dict:
        from factorvae_tpu_torch.train.loop import train_step

        losses, grad = [], None
        for i, days in enumerate(self.check_days):
            aux = train_step(self.state, self.ds, torch.as_tensor(days, device=self.device),
                             guard=self.cfg.train.finite_guard,
                             loss_scale_cfg=self.trainer.loss_scale_cfg)
            losses.append(float(aux["loss_sum"] / aux["days"]))
            if i == 0:
                # a leaf Adam holds no moment for has had no gradient
                moments = self.state.optimizer.state
                grad = {name: common.norm(moments[p]["exp_avg"]) / (1.0 - BETA1)
                        if "exp_avg" in moments.get(p, {}) else 0.0
                        for name, p in self.state.model.named_parameters()}
        change = {name: common.norm(p - w0[name])
                  for name, p in self.state.model.named_parameters()}
        return {"losses": losses, "grad": grad, "change": change}

    def shapes(self) -> dict:
        m, n = self.inputs.m, self.ds.n_max
        return {"days": self.b, "n": n, "rows": self.b * n, "t": m["seq_len"],
                "h": m["hidden_size"], "k": m["num_factors"],
                "valid_train": self.inputs.valid_per_day["train"] * self.b,
                "valid_eval": self.inputs.valid_per_day["val"] * self.b}

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        self.deadline[0] = t0 + seconds
        try:
            self.trainer.fit(self.state)
        except WindowClosed:
            pass
        t1 = self.marks[-1][0] if self.marks else time.perf_counter()
        epochs = len(self.marks)
        times = [t0] + [t for t, _ in self.marks]
        skipped = sum(int(f.get("skipped_steps", 0)) for _, f in self.marks)
        window_s = t1 - t0
        windows = epochs * self.windows_per_epoch
        return {"window_s": window_s, "windows": windows,
                "rates": {"train_windows_per_s": windows / window_s},
                "spans": {"epoch": list(np.diff(times))},
                "attempted": epochs * self.trainer.steps_per_epoch, "failed": skipped,
                "valid_per_day": self.inputs.valid_per_day["train"]}

    def release(self) -> None:
        self.trainer = self.state = self.ds = None
        self.tmp.cleanup()
        common.free_device()

    def reference_run(self, precision: str, half_batch: bool = False) -> dict:
        """The reference's check steps from the same weights, days and noise."""
        ref = self.inputs.reference
        m = self.inputs.m
        values, valid = self.inputs.reference_panel()
        n = values.shape[0]
        batches = []
        for days in self.check_days:
            x, y, mask = ref.windows(values, valid, torch.as_tensor(days, device=self.device),
                                     m["seq_len"])
            batches.append((x, y, mask, torch.ones(len(days), device=self.device)))
        del values, valid
        noise = ref.train_noise(m, self.seed, len(batches), self.b, n, self.device)
        total = -(-len(self.inputs.train_days) // self.b) * self.traffic["num_epochs"]
        lrs = [ref.cosine_lr(self.traffic["lr"], s, total) for s in range(len(batches))]
        w0 = self.inputs.weights()
        with ref.precision(precision):
            losses, first, last = ref.train_steps(w0, m, batches, noise, lrs,
                                                  half_batch=half_batch)
        out = {"losses": losses, "grad": {k: common.norm(g) for k, g in first.items()},
               "change": {k: common.norm(last[k] - w0[k]) for k in w0}}
        del batches, noise
        common.free_device()
        return out

    def numbers(self, prog: Optional[dict] = None, against: Optional[dict] = None,
                leaves: bool = False) -> dict:
        """The compared numbers of `prog` (default: the program's check
        steps) against the float32 reference (or `against`). With `leaves`,
        also each leaf's readings: its reference gradient over the median
        leaf's, and both sides' gradient and change."""
        prog = self.prog if prog is None else prog
        ref = against or self.reference_run("float32")
        loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
        grad = common.worst_leaf_gap(prog["grad"], ref["grad"], ref["grad"])
        med = float(np.median(list(ref["grad"].values())))
        moving = [k for k, g in ref["grad"].items() if g >= ROUNDING_SHARE * med]
        change = common.worst_leaf_gap(prog["change"], ref["change"], moving)
        out = {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
               "_excluded": sorted(set(ref["grad"]) - set(moving))}
        if leaves:
            out["_leaves"] = {k: [ref["grad"][k] / med, prog["grad"][k], ref["grad"][k],
                                  prog["change"][k], ref["change"][k]] for k in ref["grad"]}
        return out
