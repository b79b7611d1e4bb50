"""Score-file parity comparison (`factorvae_tpu/eval/compare.py`).

Join each of two score files (datetime, instrument, score) with labels,
compute the per-day Rank-IC, and report the parity delta against the
±0.002 target: the reference's `scores/*.csv` against the port's export,
or the port's card scores against its CPU scores.

CLI:
    python -m factorvae_tpu_torch.eval.compare REF.csv OURS.csv \\
        --labels panel.pkl [--tolerance 0.002]

It prints the result as JSON and exits 0 within the tolerance, 1 outside.
"""

from __future__ import annotations

import numpy as np

from factorvae_tpu_torch.eval.metrics import daily_rank_ic


def load_scores(path: str):
    """A score CSV (reference schema: datetime,instrument,score) as a
    (datetime, instrument)-indexed frame, sorted."""
    import pandas as pd

    df = pd.read_csv(path, parse_dates=["datetime"])
    return df.set_index(["datetime", "instrument"]).sort_index()


def labels_from_panel(path: str):
    """The LABEL0 series of a reference-schema pickle."""
    from factorvae_tpu_torch.data.panel import load_frame

    return load_frame(path)["LABEL0"]


def compare_scores(ref, ours, labels, tolerance: float = 0.002) -> dict:
    """Rank-IC of both score frames against shared labels, and the parity
    verdict. Only the (datetime, instrument) pairs present in a score
    frame AND the labels count towards its Rank-IC (an inner join)."""
    out = {}
    for name, scores in (("reference", ref), ("ours", ours)):
        joined = scores.join(labels.rename("LABEL0"), how="inner").dropna()
        ic = daily_rank_ic(joined, "LABEL0", "score")
        out[f"{name}_rank_ic"] = float(ic.mean())
        std = float(ic.std(ddof=0))
        out[f"{name}_rank_ic_ir"] = float(ic.mean() / std) if std else np.nan
        out[f"{name}_days"] = int(len(ic))
    out["delta_rank_ic"] = out["ours_rank_ic"] - out["reference_rank_ic"]
    out["tolerance"] = tolerance
    out["within_tolerance"] = bool(abs(out["delta_rank_ic"]) <= tolerance)
    return out


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("reference_csv")
    p.add_argument("ours_csv")
    p.add_argument("--labels", required=True,
                   help="reference-schema panel pickle supplying LABEL0")
    p.add_argument("--tolerance", type=float, default=0.002)
    args = p.parse_args(argv)
    result = compare_scores(load_scores(args.reference_csv), load_scores(args.ours_csv),
                            labels_from_panel(args.labels), tolerance=args.tolerance)
    print(json.dumps(result, indent=2))
    return 0 if result["within_tolerance"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
