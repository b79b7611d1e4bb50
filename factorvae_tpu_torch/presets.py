"""Named model configurations (the JAX package's `presets.py`).

The same five BASELINE.json configurations plus the CLI-default flagship.
They differ from the JAX presets in one field: `compute_dtype` stays
"float32". The JAX presets default to bfloat16 because that was the best
setting measured on a TPU, and the port carries over no default tuned
there; `--bf16` (or `compute_dtype="bfloat16"`) takes the bfloat16 rung.
"""

from __future__ import annotations

from factorvae_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig


def _csi300(num_factors: int, hidden: int, run: str) -> Config:
    return Config(
        model=ModelConfig(
            num_features=158, hidden_size=hidden, num_factors=num_factors,
            num_portfolios=128, seq_len=20,
        ),
        data=DataConfig(dataset_path="./data/csi_data.pkl", seq_len=20),
        train=TrainConfig(run_name=run),
    )


PRESETS = {
    # reference CLI defaults: C158 / T20 / H64 / K96 / M128
    "flagship": _csi300(96, 64, "flagship"),
    "csi300-k20": _csi300(20, 20, "free20"),
    "csi300-k48": _csi300(48, 48, "free48"),
    "csi300-k60": _csi300(60, 60, "free60"),
    "csi800-k60": Config(
        model=ModelConfig(num_features=158, hidden_size=60, num_factors=60,
                          num_portfolios=128, seq_len=20),
        data=DataConfig(dataset_path="./data/csi800_data.pkl", seq_len=20),
        train=TrainConfig(run_name="csi800_k60"),
    ),
    "alpha360-k60": Config(
        model=ModelConfig(num_features=360, hidden_size=60, num_factors=60,
                          num_portfolios=128, seq_len=60),
        data=DataConfig(dataset_path="./data/csi_alpha360.pkl", seq_len=60),
        train=TrainConfig(run_name="alpha360_k60"),
    ),
}


def get_preset(name: str) -> Config:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; choose from {sorted(PRESETS)}")
