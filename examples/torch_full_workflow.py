"""End-to-end example on the PyTorch/CUDA port: the reference workflow on
synthetic data (`examples/full_workflow.py` through `factorvae_tpu_torch`).

Train, export the scores as the reference's CSV, then the Rank-IC, the
top-k dropout backtest and the int8 weight-only scores' rank correlation
with the float32 ones, through the port's Python API (the port's CLI,
`python -m factorvae_tpu_torch.cli`, covers the same flow from the shell).
Runs on the GPU, or on the CPU with --cpu. Prints the results, then one
JSON line of them; exits 1 if a result is not finite.

Run:  python examples/torch_full_workflow.py [--real /path/to/csi_data.pkl]
          [--epochs 3] [--cpu] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--real", default=None, help="path to a reference-schema pickle")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the GPU")
    ap.add_argument("--workdir", default=None,
                    help="checkpoints and the score CSV (default: a new temp directory)")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from factorvae_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from factorvae_tpu_torch.data.loader import PanelDataset
    from factorvae_tpu_torch.data.panel import build_panel, load_frame
    from factorvae_tpu_torch.data.synthetic import synthetic_frame
    from factorvae_tpu_torch.eval.backtest import topk_dropout_backtest
    from factorvae_tpu_torch.eval.metrics import RankIC
    from factorvae_tpu_torch.eval.predict import (
        export_scores,
        predict_panel,
        score_frame,
        score_table,
    )
    from factorvae_tpu_torch.train.trainer import Trainer
    from factorvae_tpu_torch.utils.logging import MetricsLogger

    device = "cpu" if args.cpu else "cuda"
    workdir = args.workdir or tempfile.mkdtemp(prefix="factorvae_torch_example_")

    if args.real:
        frame = load_frame(args.real)
        cfg = Config(train=TrainConfig(num_epochs=args.epochs, save_dir=workdir))
    else:
        frame = synthetic_frame(
            num_days=60, num_instruments=20, num_features=16,
            missing_prob=0.05, signal=0.7, seed=0,
            label_scale=0.02,  # daily-return-like magnitudes for the demo
        )
        cfg = Config(
            model=ModelConfig(num_features=16, hidden_size=16, num_factors=8,
                              num_portfolios=12, seq_len=8),
            data=DataConfig(seq_len=8, start_time=None, fit_end_time="2020-02-28",
                            val_start_time="2020-03-01", val_end_time=None),
            train=TrainConfig(num_epochs=args.epochs, lr=1e-3, save_dir=workdir),
        )

    dataset = PanelDataset(build_panel(frame), seq_len=cfg.data.seq_len, device=device)
    trainer = Trainer(cfg, dataset, device=device, logger=MetricsLogger())
    state, _ = trainer.fit()
    model = state.model.eval()

    days = dataset.split_days(None, None)
    table = score_table(dataset, days,
                        predict_panel(model, cfg, dataset, days, stochastic=False),
                        with_labels=True)
    scores = score_frame(table)
    csv_path = export_scores(table, cfg, out_dir=f"{workdir}/scores")
    ic = RankIC(scores.dropna(), "LABEL0", "score")
    bt = topk_dropout_backtest(scores, topk=5, n_drop=2)

    print(f"\nscores csv : {csv_path}")
    print(f"rank-ic    : {float(ic['RankIC'].iloc[0]):+.4f} "
          f"(IR {float(ic['RankIC_IR'].iloc[0]):+.3f})")
    print(f"backtest   : {bt.summary()}")

    # int8 weight-only scoring (ops/quant.py): 4x smaller parameter
    # residency, rank-faithful scores — the serving-oriented path.
    i8 = score_frame(score_table(dataset, days, predict_panel(
        model, cfg, dataset, days, stochastic=False, int8=True)))
    rho = scores["score"].corr(i8["score"], method="spearman")
    print(f"int8 path  : rank corr vs f32 = {rho:+.4f}")

    result = {"device": device, "csv": csv_path, "rows": len(scores),
              "rank_ic": float(ic["RankIC"].iloc[0]),
              "rank_ic_ir": float(ic["RankIC_IR"].iloc[0]),
              "backtest": bt.summary(), "int8_rank_corr": float(rho)}
    print(json.dumps(result))
    finite = [result["rank_ic"], result["int8_rank_corr"],
              result["backtest"]["cumulative_return"]]
    return 0 if np.isfinite(finite).all() else 1


if __name__ == "__main__":
    sys.exit(main())
