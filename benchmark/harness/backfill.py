"""The "backfill" traffic kind: `eval/predict.predict_panel` over every day of
the span in `chunk_days` chunks, pass after pass, until the window closes.

Each pass scores every (day, stock) window of the span with its own seed
for the sampled scores, and copies each chunk's scores to the host, as
`predict_panel` does. Set-up warms the chunk's shape with `warm_chunks`
chunks. The window closes at the end of the first pass past `--seconds`;
its rate counts the valid windows of the passes done over all of the
window's time.

The check: for every chunk position of the span, one pass drawn from the
seed; the reference scores that chunk from the same weights, windows and
noise. Compared: the widest gap between the two, against the reference's
RMS score, and the answers only one side gives.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from benchmark.harness import common
from benchmark.harness.seeds import rng, stream_seed

PASS_STREAM = 14
SAMPLE_STREAM = 15


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from factorvae_tpu_torch.eval.predict import predict_panel
        from factorvae_tpu_torch.models.factorvae import model_from_params

        self.traffic, self.seed, self.device = traffic, seed, device
        self.predict = predict_panel
        self.inputs = common.Inputs(config, seed, device)
        self.chunk = traffic["chunk_days"]
        self.cfg = common.program_config(config, dict(seed=seed))
        self.ds = self.inputs.dataset()
        self.model = model_from_params(self.cfg.model, self.inputs.weights()).eval()
        self.days = np.arange(len(self.inputs.dates), dtype=np.int64)
        self.chunks = -(-len(self.days) // self.chunk)
        self.predict(self.model, self.cfg, self.ds, self.days[:self.chunk * traffic["warm_chunks"]],
                     seed=self.pass_seed(-1), chunk=self.chunk)
        self.windows_per_pass = int(self.inputs.valid_np[self.days].sum())
        self.outputs: list = []

    def pass_seed(self, p: int) -> int:
        return stream_seed(self.seed, PASS_STREAM, p + 1)

    def shapes(self) -> dict:
        m, n = self.inputs.m, self.ds.n_max
        return {"days": self.chunk, "n": n, "rows": self.chunk * n, "t": m["seq_len"],
                "h": m["hidden_size"], "k": m["num_factors"],
                "valid_eval": self.windows_per_pass / self.chunks}

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        times = [t0]
        while True:
            self.outputs.append(self.predict(self.model, self.cfg, self.ds, self.days,
                                             seed=self.pass_seed(len(self.outputs)),
                                             chunk=self.chunk))
            times.append(time.perf_counter())
            if times[-1] - t0 >= seconds:
                break
        window_s = times[-1] - t0
        windows = len(self.outputs) * self.windows_per_pass
        return {"window_s": window_s, "windows": windows,
                "rates": {"score_windows_per_s": windows / window_s},
                "spans": {"pass": list(np.diff(times))},
                "attempted": len(self.outputs) * self.chunks, "failed": 0,
                "valid_per_day": self.inputs.valid_per_day["all"]}

    def release(self) -> None:
        self.model = self.ds = None
        common.free_device()

    def sample(self) -> list:
        """(chunk, pass) pairs: every chunk position, each from a pass drawn
        from the seed."""
        passes = rng(self.seed, SAMPLE_STREAM).integers(0, len(self.outputs), self.chunks)
        return list(zip(range(self.chunks), passes.tolist()))

    def reference_scores(self, pairs: list, precision: str) -> list:
        ref, m = self.inputs.reference, self.inputs.m
        values, valid = self.inputs.reference_panel()
        n = values.shape[0]
        w = self.inputs.weights()
        out = []
        with ref.precision(precision), torch.no_grad():
            for c, p in pairs:
                days = self.days[c * self.chunk:(c + 1) * self.chunk]
                x, _, mask = ref.windows(values, valid, torch.as_tensor(days, device=self.device),
                                         m["seq_len"])
                eps = ref.score_noise(self.pass_seed(p), c, self.chunk, n, self.device)
                out.append(ref.scores(w, m, x, mask, eps[:len(days)]).cpu().numpy())
                del x, mask
        del values, valid
        common.free_device()
        return out

    def numbers(self, prog: Optional[list] = None, against: Optional[list] = None) -> dict:
        """The compared number of `prog` (default: the program's sampled
        chunks) against the float32 reference (or `against`)."""
        pairs = self.sample()
        if prog is None:
            prog = [self.outputs[p][c * self.chunk:(c + 1) * self.chunk] for c, p in pairs]
        ref = against or self.reference_scores(pairs, "float32")
        return common.score_gaps(np.concatenate(prog), np.concatenate(ref))
