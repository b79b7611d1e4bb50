"""Dataset construction (ETL) — qlib Alpha158/Alpha360 -> panel pickle
(`factorvae_tpu/data/etl.py`).

Capability parity with reference data/make_dataset.py:1-102: initialize
qlib for the CN or US region, build the Alpha158 handler with the same
processor chain (RobustZScoreNorm+Fillna on features; DropnaLabel+
CSRankNorm on the label; label = Ref($close,-2)/Ref($close,-1)-1,
make_dataset.py:50-58), fetch learn/infer frames and pickle them in the
MultiIndex (datetime, instrument) schema `data.panel.load_frame` reads.

qlib is an *external tool* here exactly as it is for the reference (it is
not bundled with either framework); this module degrades to a clear
instruction if qlib or its data bundle is absent. Prebuilt pickles from
the reference pipeline load unchanged via `data.panel.load_frame`.

Only the gate is tested: without qlib, `build_dataset` raises ImportError
with the recipe and `main` returns 2. The qlib body is the JAX module's,
unverified against a qlib installation.
"""

from __future__ import annotations

from typing import Optional


QLIB_RECIPE = """\
qlib is not installed (or its data bundle is missing). To build the panel:

1. Install qlib and download daily data (the reference's recipe,
   data/readme.md):
     pip install pyqlib
     # CN (CSI300/CSI800):
     python -m qlib.run.get_data qlib_data --target_dir ~/.qlib/qlib_data/cn_data --region cn
     # or collect from Yahoo via the qlib scripts collector.
2. Run this module:
     python -m factorvae_tpu_torch.data.etl --region cn --market csi300 \\
         --out ./data/csi_data.pkl
3. Point the trainer at the pickle: python -m factorvae_tpu_torch.cli --dataset ./data/csi_data.pkl
"""


def build_dataset(
    out_path: str,
    region: str = "cn",
    market: str = "csi300",
    start: str = "2008-01-01",
    end: str = "2020-12-31",
    fit_start: str = "2009-01-01",   # reference pins this (make_dataset.py:47)
    fit_end: str = "2017-12-31",
    handler: str = "Alpha158",
    qlib_dir: Optional[str] = None,
    infer_out_path: Optional[str] = None,
) -> str:
    """Build and pickle the feature panel. Returns the pickle path.

    Matches the reference handler config (make_dataset.py:44-59): infer
    processors RobustZScoreNorm(clip, fit on [fit_start, fit_end]) +
    Fillna on features; learn processors DropnaLabel + CSRankNorm on the
    label; label = Ref($close,-2)/Ref($close,-1)-1.
    """
    try:
        import qlib
        from qlib.constant import REG_CN, REG_US
        from qlib.contrib.data.handler import Alpha158, Alpha360
    except ImportError as e:
        raise ImportError(QLIB_RECIPE) from e

    import os

    region = region.lower()
    default_dir = os.path.expanduser(
        f"~/.qlib/qlib_data/{'cn' if region == 'cn' else 'us'}_data"
    )
    qlib.init(
        provider_uri=qlib_dir or default_dir,
        region=REG_CN if region == "cn" else REG_US,
    )

    handler_cls = {"Alpha158": Alpha158, "Alpha360": Alpha360}[handler]
    handler_config = {
        "start_time": start,
        "end_time": end,
        "fit_start_time": fit_start,
        "fit_end_time": fit_end,
        "instruments": market,
        "infer_processors": [
            {
                "class": "RobustZScoreNorm",
                "kwargs": {
                    "fields_group": "feature",
                    "clip_outlier": True,
                    "fit_start_time": fit_start,
                    "fit_end_time": fit_end,
                },
            },
            {"class": "Fillna", "kwargs": {"fields_group": "feature"}},
        ],
        "learn_processors": [
            {"class": "DropnaLabel"},
            {"class": "CSRankNorm", "kwargs": {"fields_group": "label"}},
        ],
        "label": ["Ref($close, -2) / Ref($close, -1) - 1"],
    }
    h = handler_cls(**handler_config)

    from qlib.data.dataset.handler import DataHandlerLP

    learn = h.fetch(col_set=["feature", "label"], data_key=DataHandlerLP.DK_L)
    learn.to_pickle(out_path)
    if infer_out_path:
        infer = h.fetch(col_set=["feature", "label"], data_key=DataHandlerLP.DK_I)
        infer.to_pickle(infer_out_path)
    return out_path


def main(argv=None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="./data/csi_data.pkl")
    p.add_argument("--infer_out", default=None,
                   help="also write the inference-processed panel (no "
                        "DropnaLabel/CSRankNorm), as the backtest uses")
    p.add_argument("--region", choices=["cn", "us"], default="cn")
    p.add_argument("--market", default="csi300")
    p.add_argument("--handler", choices=["Alpha158", "Alpha360"], default="Alpha158")
    p.add_argument("--start", default="2008-01-01")
    p.add_argument("--end", default="2020-12-31")
    p.add_argument("--fit_start", default="2009-01-01")
    p.add_argument("--fit_end", default="2017-12-31")
    p.add_argument("--qlib_dir", default=None)
    args = p.parse_args(argv)
    try:
        path = build_dataset(
            args.out, region=args.region, market=args.market, start=args.start,
            end=args.end, fit_start=args.fit_start, fit_end=args.fit_end,
            handler=args.handler, qlib_dir=args.qlib_dir,
            infer_out_path=args.infer_out,
        )
    except ImportError as e:
        print(e, file=sys.stderr)
        return 2
    except Exception as e:
        # qlib present but its data bundle / provider is broken or absent:
        # surface the recipe, not a qlib traceback.
        print(f"qlib ETL failed: {type(e).__name__}: {e}\n\n{QLIB_RECIPE}",
              file=sys.stderr)
        return 2
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
