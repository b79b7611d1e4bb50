#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--out FILE]

Phases, each printed as one JSON line:

1. device  -- the card (`nvidia-smi` name and power limit); no CUDA device
              means exit 1 at once, with no result.
2. build   -- nvcc builds every kernel of `factorvae_tpu_torch/csrc/` for
              sm_90a, in parallel; the build seconds and ptxas reports.
3. K1      -- the GRU forward kernel against its plain PyTorch version on
              the card at the flagship serving shape (N = 32 days x 304
              stocks, T = 20, H = 64) and at ragged shapes with H = 60 and
              H = 37; kernel, plain and cuDNN nn.GRU times (nn.GRU on
              xi with an identity input weight, checked against the
              plain version), and the analytic bound.
4. K4      -- the K-head attention kernel against its plain version at
              B = 32, N = 304, K = 96, H = 64, with padded rows, an
              all-masked day, a NaN latent row (the guard) and a keep-mask,
              and at the csi800-k60 width (N = 800, H = 60) and H = 37.
5. slice   -- a flagship-width FactorVAE (C158/T20/H64/K96/M128, random
              weights from --seed) on an 80-day synthetic panel of 300
              stocks (padded to 304), admitted to the port's ModelRegistry;
              the ScoringDaemon answers a day with `top`, a 34-day range
              (the last chunk is -1-padded), ping and stats. The launch
              counters are set to 0 just before this tick and must be above
              0 after it. The same days are scored on the CPU, where the
              plain versions run, and compared.
6. kernels -- one line {"kernels": [...]} with each kernel's error, times,
              bound and launches.

The last line is {"ok": true, "device": {...}}. Any failed check raises and
the script exits non-zero. Times come from CUDA events. The bounds use the
H100 SXM data-sheet rates: 67 TFLOP/s f32 on CUDA cores (no tensor cores in
these kernels) and 3.35 TB/s of HBM, over the least work and bytes the
function needs on this run's inputs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

F32_PEAK = 67e12       # FLOP/s, f32 outside the tensor cores (H100 SXM)
HBM_RATE = 3.35e12     # bytes/s (H100 SXM)
# Limits on max |a - b|. The kernels sum in another order than the plain
# versions (cuBLAS on the card, the CPU's BLAS for the slice); every
# reading so far was at most 2.1e-7, so 1e-5 leaves a margin of about 50.
K1_TOL = 1e-5          # K1 kernel vs its plain version
K4_TOL = 1e-5          # K4 kernel vs its plain version
SLICE_TOL = 1e-5       # scores on the card vs scores on the CPU
LIBRARY_TOL = 1e-4     # cuDNN's GRU vs K1's plain version (read 6.6e-6); this
                       # only shows that the timed library call computes K1's
                       # function, it does not hold a kernel of the port


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bound_ms(n_bytes: float, flops: float) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_RATE, flops / F32_PEAK
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(line, flush=True)
    return {"phase": "device", "nvidia_smi": line,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def phase_build() -> dict:
    from factorvae_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    return {"phase": "build", "seconds": seconds, "ptxas": ptxas}


def phase_k1(torch, seed: int) -> dict:
    from factorvae_tpu_torch.ops.kernels.gru import gru_fwd, gru_fwd_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    flagship = (32 * 304, 20, 64)
    cases, timed = {}, None
    for label, (n, t, h) in {"flagship": flagship, "ragged_h60": (1001, 20, 60),
                             "odd_h37": (333, 7, 37)}.items():
        xi = torch.randn(n, t, 3 * h, device="cuda", generator=g) * 0.5
        wh = (torch.rand(h, 3 * h, device="cuda", generator=g) * 2 - 1) / h ** 0.5
        bh = (torch.rand(3 * h, device="cuda", generator=g) * 2 - 1) / h ** 0.5
        got, want = gru_fwd(xi, wh, bh), gru_fwd_plain(xi, wh, bh)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K1 {label}: non-finite output")
        err = float((got - want).abs().max())
        check(err <= K1_TOL, f"K1 {label}: max_abs_err {err} > {K1_TOL}")
        cases[label] = {"shape": [n, t, h], "max_abs_err": err}
        timed = timed or (xi, wh, bh)

    n, t, h = flagship
    xi, wh, bh = timed
    kernel_ms = cuda_ms(torch, lambda: gru_fwd(*timed))
    plain_ms = cuda_ms(torch, lambda: gru_fwd_plain(*timed))
    # cuDNN's GRU on K1's own inputs: an identity input weight makes its
    # input projection return xi unchanged, so it computes K1's function,
    # plus one (N*T, 3H) x (3H, 3H) product that its API cannot skip.
    gru = torch.nn.GRU(3 * h, h, batch_first=True).cuda()
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.eye(3 * h, device="cuda"))
        gru.bias_ih_l0.zero_()
        gru.weight_hh_l0.copy_(wh.t())
        gru.bias_hh_l0.copy_(bh)
        library_err = float((gru(xi)[1][0] - gru_fwd_plain(*timed)).abs().max())
        library_ms = cuda_ms(torch, lambda: gru(xi))
    check(library_err <= LIBRARY_TOL, f"K1: cuDNN GRU differs by {library_err}")
    flops = 2.0 * n * t * h * 3 * h + 10.0 * n * t * h
    n_bytes = 4.0 * (n * t * 3 * h + 3 * h * h + 3 * h + n * h)
    b_ms, b_by = bound_ms(n_bytes, flops)
    return {"phase": "K1", "cases": cases, "tolerance": K1_TOL,
            "max_abs_err": max(v["max_abs_err"] for v in cases.values()),
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "torch.nn.GRU (cuDNN) over xi with an identity input "
                       "weight: K1's function plus a 3H x 3H input product",
            "library_max_abs_err": library_err,
            "flops": flops, "bytes": n_bytes, "bound_ms": b_ms, "bound_by": b_by}


def _k4_inputs(torch, g, b, n, k, h, n_real):
    latent = torch.rand(b, n, h, device="cuda", generator=g) * 2 - 1
    mask = torch.zeros(b, n, dtype=torch.bool, device="cuda")
    mask[:, :n_real] = torch.rand(b, n_real, device="cuda", generator=g) > 0.05
    scale = 1.0 / h ** 0.5
    q = torch.randn(k, h, device="cuda", generator=g)
    wk = (torch.rand(k, h, h, device="cuda", generator=g) * 2 - 1) * scale
    bk = (torch.rand(k, h, device="cuda", generator=g) * 2 - 1) * scale
    wv = (torch.rand(k, h, h, device="cuda", generator=g) * 2 - 1) * scale
    bv = (torch.rand(k, h, device="cuda", generator=g) * 2 - 1) * scale
    return latent, mask, q, wk, bk, wv, bv


def phase_k4(torch, seed: int) -> dict:
    from factorvae_tpu_torch.ops.kernels.attention import (
        attention_fwd,
        attention_fwd_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    b, n, k, h, n_real = 32, 304, 96, 64, 300
    latent, mask, q, wk, bk, wv, bv = _k4_inputs(torch, g, b, n, k, h, n_real)
    weights = (q, wk, bk, wv, bv)

    # the serving inputs: padded rows and missing stocks only
    got = attention_fwd(latent, mask, *weights)
    err_serving = float((got - attention_fwd_plain(latent, mask, *weights)).abs().max())

    # the guards: an all-masked day (7) and a NaN latent row on day 3
    lat_g, mask_g = latent.clone(), mask.clone()
    mask_g[7] = False
    lat_g[3, 11] = float("nan")
    mask_g[3, 11] = True
    keep = (torch.rand(b, k, n, device="cuda", generator=g) > 0.1).float() / 0.9
    errs = {"serving": err_serving}
    for label, kp in (("guards", None), ("guards_keep_mask", keep)):
        got_g = attention_fwd(lat_g, mask_g, *weights, keep=kp)
        want_g = attention_fwd_plain(lat_g, mask_g, *weights, keep=kp)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got_g).all()), f"K4 {label}: non-finite output")
        check(bool((got_g[7] == 0).all()), f"K4 {label}: all-masked day not zero")
        check(bool((got_g[3] == 0).all()), f"K4 {label}: NaN day not zeroed")
        check(bool((got_g[0] != 0).any()), f"K4 {label}: day 0 all zero")
        errs[label] = float((got_g - want_g).abs().max())
    # other widths: csi800-k60 (N = 800, H = 60) and an H that is no
    # multiple of 4 (the kernel's zero-padded rows), with the keep-mask
    for label, shape in (("csi800_k60", (4, 800, 60, 60, 790)),
                         ("odd_h37", (3, 70, 6, 37, 66))):
        ob, on, ok_, oh, _ = shape
        other = _k4_inputs(torch, g, *shape)
        other[1][0] = False
        kp = (torch.rand(ob, ok_, on, device="cuda", generator=g) > 0.1).float() / 0.9
        errs[label] = max(
            float((attention_fwd(*other, keep=kp)
                   - attention_fwd_plain(*other, keep=kp)).abs().max()),
            float((attention_fwd(*other) - attention_fwd_plain(*other)).abs().max()))
    err = max(errs.values())
    check(err <= K4_TOL, f"K4: max_abs_err {errs} > {K4_TOL}")

    kernel_ms = cuda_ms(torch, lambda: attention_fwd(latent, mask, *weights))
    plain_ms = cuda_ms(torch, lambda: attention_fwd_plain(latent, mask, *weights))
    # The least work of the function, counted over this run's valid rows
    # (masked rows need none): the score needs only L . (Wk[k] . q[k]) +
    # bk[k] . q[k], so per head one (H, H) . (H,) product and one dot, and
    # per valid row and head a score dot (2H), the value product and bias
    # (2H^2 + H), the context update (2H) and five scalar steps (scale,
    # keep, ReLU, exp, normalise). The algebra as the kernel writes it
    # computes the key (2H^2 + H) instead of the 2H score dot: reported
    # beside it, not used for the bound.
    n_valid = int(mask.sum())
    per_row = 2.0 * h * h + 5.0 * h + 5.0
    flops = k * n_valid * per_row + k * (2.0 * h * h + 2.0 * h)
    flops_as_written = k * n_valid * (per_row - 2.0 * h + 2.0 * h * h + h)
    n_bytes = 4.0 * (b * n * h + k * (2 * h * h + 3 * h) + b * k * h) + b * n
    b_ms, b_by = bound_ms(n_bytes, flops)
    return {"phase": "K4", "shape": [b, n, k, h], "errors": errs,
            "max_abs_err": err, "tolerance": K4_TOL, "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no single PyTorch call computes this function",
            "valid_rows": n_valid, "flops": flops,
            "flops_as_written": flops_as_written, "bytes": n_bytes,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_as_written": bound_ms(n_bytes, flops_as_written)[0]}


def _stage_breakdown(torch, model, dataset, days) -> dict:
    """CUDA-event times of one 32-day chunk's stages."""
    from torch.nn.functional import leaky_relu

    from factorvae_tpu_torch.ops.kernels.gru import gru_fwd

    day_idx = torch.as_tensor(days[:32], device="cuda")
    fe = model.feature_extractor
    slope = model.cfg.leaky_relu_slope
    with torch.inference_mode():
        x, _, mask = dataset.gather(day_idx)
        b, n = x.shape[:2]
        flat = x.reshape((b * n,) + tuple(x.shape[2:]))

        def projections():
            return fe.gru.input_proj(leaky_relu(fe.proj(fe.layer_norm(flat)), slope))

        xi = projections()
        latent = gru_fwd(xi, fe.gru.hidden_kernel, fe.gru.hidden_bias).reshape(b, n, -1)
        mu, sigma = model.factor_predictor.day_batched(latent, mask)
        stages = {
            "gather": lambda: dataset.gather(day_idx),
            "layernorm_proj_inputproj": projections,
            "gru_fwd (K1)": lambda: gru_fwd(xi, fe.gru.hidden_kernel, fe.gru.hidden_bias),
            "predictor (K4 + heads)": lambda: model.factor_predictor.day_batched(latent, mask),
            "decoder": lambda: model.factor_decoder(latent, mu, sigma, sample=False),
            "whole chunk": lambda: model.day_batched_prediction(x, mask, stochastic=False),
        }
        return {name: cuda_ms(torch, fn, reps=10, warmup=2) for name, fn in stages.items()}


def phase_slice(torch, seed: int, counters) -> dict:
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.synthetic import synthetic_panel_dense
    from factorvae_tpu_torch.eval.predict import predict_panel
    from factorvae_tpu_torch.models.factorvae import load_model
    from factorvae_tpu_torch.presets import get_preset
    from factorvae_tpu_torch.serve.daemon import ScoringDaemon
    from factorvae_tpu_torch.serve.registry import ModelRegistry

    cfg = get_preset("flagship")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=seed))
    m = cfg.model
    panel = synthetic_panel_dense(80, 300, m.num_features, seed=seed)
    dataset = PanelDataset(panel, seq_len=m.seq_len, device="cuda")
    check(dataset.n_max == 304, f"n_max {dataset.n_max} != 304")
    model = load_model(cfg, device="cuda")
    registry = ModelRegistry(device="cuda")
    registry.admit(model, cfg, alias="flagship")
    daemon = ScoringDaemon(registry, dataset)
    dates = [str(d) for d in dataset.dates]
    day_req = {"id": 1, "model": "flagship", "day": dates[40], "top": 10}
    range_req = {"id": 2, "model": "flagship", "start": dates[19], "end": dates[52]}
    requests = [day_req, range_req, {"id": 3, "cmd": "ping"},
                {"id": 4, "cmd": "stats"}]

    daemon.handle_batch([day_req])     # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    responses = daemon.handle_batch(requests)
    tick_ms = (time.perf_counter() - t0) * 1e3
    launches = {c.__name__: c.launches for c in counters}
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")

    check(all(r["ok"] for r in responses), f"a request failed: {responses}")
    check(responses[0]["n"] == 10, "top-10 day request did not return 10 scores")
    ranged = responses[1]["results"]
    check(len(ranged) == 34, f"range returned {len(ranged)} days, not 34")
    got = np.asarray([r["scores"] for r in ranged], np.float32)       # (34, 300)
    check(got.shape == (34, 300) and bool(np.isfinite(got).all()),
          f"range scores shape {got.shape} or non-finite")

    # the same days on the CPU, where every kernel runs its plain version
    days = dataset.split_days(dates[19], dates[52])
    cpu_model = load_model(cfg, device="cpu")
    cpu_ds = PanelDataset(panel, seq_len=m.seq_len, device="cpu")
    want = predict_panel(cpu_model, cfg, cpu_ds, days, stochastic=False)[:, :300]
    err = float(np.abs(got - want).max())
    check(err <= SLICE_TOL, f"cuda vs cpu scores: max_abs_err {err} > {SLICE_TOL}")
    top = np.asarray(responses[0]["results"][0]["scores"])
    check(bool(np.all(np.diff(top) <= 0)), "top-10 scores not sorted")

    breakdown = _stage_breakdown(torch, model, dataset, days)
    return {"phase": "slice", "config": "flagship C158/T20/H64/K96/M128, f32",
            "panel": {"days": 80, "stocks": 300, "n_max": dataset.n_max},
            "launches": launches, "tick_ms": tick_ms,
            "latency_ms": {str(r["id"]): r.get("latency_ms") for r in responses},
            "cuda_vs_cpu_max_abs_err": err, "tolerance": SLICE_TOL,
            "score_range": [float(got.min()), float(got.max())],
            "chunk_stage_ms": breakdown}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write every phase here (JSON)")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA "
              "GPU (nothing was run)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from factorvae_tpu_torch.ops.kernels.attention import attention_fwd
    from factorvae_tpu_torch.ops.kernels.gru import gru_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)

    phases = []
    for fn in (lambda: phase_device(torch), phase_build,
               lambda: phase_k1(torch, args.seed), lambda: phase_k4(torch, args.seed),
               lambda: phase_slice(torch, args.seed, (gru_fwd, attention_fwd))):
        t0 = time.perf_counter()
        out = fn()
        out["wall_s"] = time.perf_counter() - t0
        phases.append(out)
        emit(out)

    by = {ph["phase"]: ph for ph in phases}
    launches = by["slice"]["launches"]
    rows = []
    for name, ph, src, replaces in (
            ("gru_fwd", by["K1"], "factorvae_tpu_torch/csrc/gru_fwd.cu",
             "factorvae_tpu/ops/pallas/gru.py:417"),
            ("attention_fwd", by["K4"], "factorvae_tpu_torch/csrc/attention_fwd.cu",
             "factorvae_tpu/ops/pallas/attention.py:104")):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": ph["max_abs_err"], "tolerance": ph["tolerance"],
                     "ms": ph["ms"], "kernel_ms": ph["ms"],
                     "plain_ms": ph["plain_ms"], "bound_ms": ph["bound_ms"],
                     "bound_by": ph["bound_by"], "library_ms": ph["library_ms"]})
    kernels = {"kernels": rows}
    emit(kernels)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"phases": phases, **kernels}, fh, indent=1)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
