"""Typed configuration for the PyTorch port.

The same dataclasses, fields, defaults and JSON round-trip as the JAX
package's `factorvae_tpu/config.py`, copied rather than imported (importing
any `factorvae_tpu` module loads Flax). Two fields are left out on purpose:
`use_pallas_attention` and `use_pallas_gru`. On a CUDA device the port always
runs its kernels; on the CPU it always runs their plain versions, so there is
nothing to switch. `Config.from_dict` ignores unknown keys, so a config
written by the JAX package loads here unchanged.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch


# The compute dtypes of the precision ladder's float rungs (int8 is a
# weight format of scoring, not a compute dtype).
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (C, H, K, M, T of the reference)."""

    num_features: int = 158      # C: Alpha158 features
    hidden_size: int = 64        # H
    num_factors: int = 96        # K
    num_portfolios: int = 128    # M
    seq_len: int = 20            # T: look-back window
    gru_layers: int = 1          # the reference uses a 1-layer GRU
    dropout_rate: float = 0.1    # attention-score dropout (training only)
    leaky_relu_slope: float = 0.01
    recon_loss: str = "mse"
    kl_weight: float = 1.0
    # The reference draws a reparameterized sample even at inference;
    # False returns the distribution mean (deterministic scores).
    stochastic_inference: bool = True
    # "float32" | "bfloat16": the dtype of the extractor's activations
    # (flax's `dtype=`). bfloat16 scoring keeps float32 weights; a bfloat16
    # training run computes with a bfloat16 copy of float32 master weights.
    compute_dtype: str = "float32"
    # torch-style U(+-1/sqrt(fan_in)) initializers; False -> lecun normal.
    torch_init: bool = True
    # Kept for the config round-trip. The port always runs the day-batched
    # (flattened) layout; the JAX package pins both layouts equal.
    flatten_days: bool = True

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {tuple(COMPUTE_DTYPES)}; "
                             f"got {self.compute_dtype!r}")

    @property
    def dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self.compute_dtype]


@dataclass(frozen=True)
class DataConfig:
    dataset_path: str = "./data/csi_data.pkl"
    start_time: str = "2009-01-01"
    fit_end_time: str = "2017-12-31"
    val_start_time: str = "2018-01-01"
    val_end_time: str = "2018-12-31"
    end_time: str = "2020-12-31"
    seq_len: int = 20
    normalize: bool = True
    select_feature: Optional[Sequence[str]] = None
    # Cross-section padding size (N_max); None -> the panel's instrument
    # count rounded up to `pad_multiple`.
    max_stocks: Optional[int] = None
    pad_multiple: int = 8
    panel_residency: str = "hbm"
    stream_chunk_days: int = 32


@dataclass(frozen=True)
class TrainConfig:
    num_epochs: int = 30
    lr: float = 1e-4
    seed: int = 42
    days_per_step: int = 1
    cosine_schedule: bool = True
    run_name: str = "VAE-Revision2"
    save_dir: str = "./best_models"
    wandb: bool = False
    checkpoint_every: int = 1
    keep_checkpoints: int = 3
    async_checkpointing: bool = True
    obs_probes: bool = False
    finite_guard: bool = True
    recover_after: int = 2
    recover_lr_backoff: float = 0.5
    recover_max_rollbacks: int = 2
    # The training compute dtype; None inherits model.compute_dtype
    # (train/state.resolve_train_dtype).
    compute_dtype: Optional[str] = None
    # The dynamic loss scale of a mixed (bfloat16) run: the scale starts at
    # init, grows by `growth` after `growth_interval` finite steps in a row
    # and backs off by `backoff`, down to `floor`, at a step whose gradient
    # is not finite (which applies no update).
    loss_scale_init: float = 32768.0
    loss_scale_growth: float = 2.0
    loss_scale_backoff: float = 0.5
    loss_scale_growth_interval: int = 200
    loss_scale_floor: float = 1.0
    remat: str = "none"

    def __post_init__(self):
        if not (self.loss_scale_init > 0 and self.loss_scale_floor > 0
                and self.loss_scale_growth >= 1 and 0 < self.loss_scale_backoff <= 1
                and self.loss_scale_growth_interval >= 1):
            raise ValueError(
                "loss scale knobs need init > 0, floor > 0, growth >= 1, "
                "0 < backoff <= 1 and growth_interval >= 1; got "
                f"init={self.loss_scale_init}, floor={self.loss_scale_floor}, "
                f"growth={self.loss_scale_growth}, backoff={self.loss_scale_backoff}, "
                f"growth_interval={self.loss_scale_growth_interval}")


@dataclass(frozen=True)
class MeshConfig:
    data_axis: int = -1
    stock_axis: int = 1


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    def checkpoint_name(self) -> str:
        """The reference's parameter-encoding name,
        ``{run_name}_factor_{K}_hdn_{H}_port_{M}_seed_{seed}``."""
        return (f"{self.train.run_name}_factor_{self.model.num_factors}"
                f"_hdn_{self.model.hidden_size}_port_{self.model.num_portfolios}"
                f"_seed_{self.train.seed}")

    def score_name(self) -> str:
        """The reference's score-CSV name (scores/readme.md:2-8),
        ``{run_name}_{K}_{normalize}_{select_feature}_{C}_{H}``."""
        sel = ("None" if self.data.select_feature is None
               else str(len(self.data.select_feature)))
        return (f"{self.train.run_name}_{self.model.num_factors}_{self.data.normalize}"
                f"_{sel}_{self.model.num_features}_{self.model.hidden_size}")

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        def _load(tp, sub):
            known = {f.name for f in dataclasses.fields(tp)}
            return tp(**{k: v for k, v in (sub or {}).items() if k in known})

        return cls(
            model=_load(ModelConfig, d.get("model")),
            data=_load(DataConfig, d.get("data")),
            train=_load(TrainConfig, d.get("train")),
            mesh=_load(MeshConfig, d.get("mesh")),
        )

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))


def config_hash(config: dict) -> str:
    """Canonical 12-hex digest of a config dict: the serving registry's key."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]
