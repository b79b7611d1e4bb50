#!/usr/bin/env python3
"""Hold one training step's gradients on the GPU against the CPU's, day by
day, beside how well conditioned each bias gradient is.

    python3 scripts/torch_grad_conditioning.py [--seed 0] [--first 0] [--days 50] [--out FILE]

The step is `chip_smoke.py`'s deterministic parity step: the flagship
preset with dropout 0 and the NLL loss, days_per_step 1, on an 80-day
synthetic panel of 300 stocks made from --seed, from the same initial
weights on both devices. For each day it records every parameter's
max |card - cpu| / max |cpu| (the smoke test's gradient metric; a
gradient of at most 1e-6 everywhere, zero up to rounding, is left out), and for
the bias of every `Dense` layer, whose gradient is the sum of the layer's
output gradient over the day's rows, the cancellation of that sum on the
CPU: kappa = sum |terms| / |sum|, and on the entries that cancel 50-fold
or more (those `chip_smoke.py` holds to SUM_RTOL of their terms) the
difference against the sum of magnitudes, |card - cpu| / sum |terms|
(what rounding in the terms can move). Prints one JSON line with the card's `nvidia-smi` name and power
limit; exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


CANCELLED = 50.0     # kappa from which chip_smoke.py holds a bias entry to its terms


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _step(torch, cfg, dataset, device: str, day: int) -> tuple:
    """(gradients, {bias name: sum over rows of |output gradient|}) of one
    step on `day`, on the host."""
    from factorvae_tpu_torch.models.layers import Dense
    from factorvae_tpu_torch.train.loop import train_step
    from factorvae_tpu_torch.train.trainer import init_train_state

    state = init_train_state(cfg.model, cfg.train, 100, device)
    terms, hooks = {}, []
    for name, mod in state.model.named_modules():
        if isinstance(mod, Dense):
            def keep(g, key=f"{name}.bias"):
                terms[key] = terms.get(key, 0) + g.abs().reshape(-1, g.shape[-1]).sum(0)

            def watch(m, args, out, keep=keep):
                out.register_hook(keep)

            hooks.append(mod.register_forward_hook(watch))
    train_step(state, dataset, torch.tensor([day], device=device), guard=True)
    for h in hooks:
        h.remove()
    grads = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}
    return grads, {k: v.detach().cpu() for k, v in terms.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--first", type=int, default=0)
    p.add_argument("--days", type=int, default=50)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_grad_conditioning: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import dataclasses

    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.presets import get_preset

    base = get_preset("flagship")
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, dropout_rate=0.0, recon_loss="nll"),
        train=dataclasses.replace(base.train, seed=args.seed, days_per_step=1,
                                  checkpoint_every=0))
    panel = synthetic_panel_dense(80, 300, cfg.model.num_features, seed=args.seed)
    data = {d: PanelDataset(panel, seq_len=cfg.model.seq_len, device=d)
            for d in ("cuda", "cpu")}
    days = []
    for day in range(args.first, args.first + args.days):
        (g_card, _), (g_cpu, terms) = (_step(torch, cfg, data[d], d, day)
                                        for d in ("cuda", "cpu"))
        # a gradient zero up to rounding (chip_smoke's ZERO_GRAD_ATOL) has no scale
        errs = {k: float((g_card[k] - g).abs().max()) / float(g.abs().max())
                for k, g in g_cpu.items() if float(g.abs().max()) > 1e-6}
        worst = max(errs, key=errs.get)
        bias = {}
        for k, mag in terms.items():
            if k not in errs:
                continue
            g, d = g_cpu[k], (g_card[k] - g_cpu[k]).abs()
            kappa = mag / g.abs().clamp(min=1e-30)
            cut = kappa >= CANCELLED
            bias[k] = {"kappa_max": float(kappa.max()), "err": errs[k],
                       "cancelled": int(cut.sum()),
                       "err_over_terms": float((d / mag)[cut].max()) if bool(cut.any())
                       else None}
        cancelled = [b["err_over_terms"] for b in bias.values() if b["cancelled"]]
        days.append({"day": day, "worst": worst, "worst_err": errs[worst],
                     "worst_bias": bias.get(worst),
                     "cancelled_err_over_terms_max": max(cancelled, default=None),
                     "top": dict(sorted(errs.items(), key=lambda kv: -kv[1])[:3])})
    over = [d for d in days if d["worst_err"] > 5e-5]
    out = {"script": "torch_grad_conditioning", "card": _card(), "seed": args.seed,
           "config": "flagship C158/T20/H64/K96/M128, f32, dropout 0, nll, days_per_step 1, "
                     "80 days x 300 stocks",
           "days": days,
           "days_over_5e-5": [(d["day"], d["worst"], d["worst_err"],
                               (d["worst_bias"] or {}).get("kappa_max")) for d in over],
           "cancelled_err_over_terms_max": max(
               (d["cancelled_err_over_terms_max"] for d in days
                if d["cancelled_err_over_terms_max"] is not None), default=None)}
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(json.dumps({k: v for k, v in out.items() if k != "days"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
