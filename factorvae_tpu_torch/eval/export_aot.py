"""Ahead-of-time serving artifact (`factorvae_tpu/eval/export_aot.py`).

`export_prediction` writes the day-batched prediction `(x (1, n_max, T, C),
mask (1, n_max)) -> scores (1, n_max)` of one model, weights baked in, as a
`torch.export` program in a validated container:

    ARTIFACT_MAGIC \\n header-JSON \\n torch.export.save bytes

The header carries the JAX header's fields (the Config hash the serving
registry keys on, n_max, seq_len, num_features, stochastic, int8,
platforms) with `"torch": torch.__version__` where the JAX one has
`"jax"`, and its own `format`. `load_exported` validates the header before
anything is deserialized and fails with a one-line `ArtifactError`; a JAX
StableHLO artifact (same magic, a `"jax"` header) is refused by name, never
deserialized.

Differences by design from the JAX artifact:

- The program's graph calls the CUDA kernels as the registered ops
  `factorvae_tpu_torch::gru_fwd` (K1's serving variant) and
  `factorvae_tpu_torch::attention_fwd` (K4), so loading needs this package's
  kernel modules, which `load_exported` imports first. The JAX artifact
  runs without its package.
- The export runs on the CPU whatever the target (`platform`, recorded in
  the header): the graph records the ops, not a device's code, and
  `load_exported(..., device=)` moves the program to the card with
  `torch.export.passes.move_to_device_pass`. This is the port's form of the
  JAX package's cross-export.
- A stochastic artifact bakes one noise draw, from a torch.Generator seeded
  0, the counterpart of the JAX artifact's fixed PRNGKey(0): every call
  samples with the same eps.

`int8=True` bakes the weights as per-channel int8 `q` and float32 `s`
(`ops/quant.py`) and dequantizes them inside the program, as the int8
scoring path does for each chunk.

Each `torch.export` writes one `compile` record (`fn` "export:<checkpoint
name>") onto the installed timeline (`utils/logging.timeline_compile`).
"""

from __future__ import annotations

import io
import json
import time
from typing import Optional

import torch
from torch import nn

from factorvae_tpu_torch.config import Config, config_hash
from factorvae_tpu_torch.models.factorvae import call_with, model_from_params
from factorvae_tpu_torch.ops.quant import QTensor, quantize_params
from factorvae_tpu_torch.utils.logging import timeline_compile

ARTIFACT_MAGIC = b"FVAE-AOT1"
FORMAT = "factorvae-aot-torch/1"
PLATFORMS = ("cuda", "cpu")


class ArtifactError(ValueError):
    """An AOT artifact failed validation; the message is one actionable line."""


def _buffer_name(name: str, part: str) -> str:
    return f"{name.replace('.', '__')}__{part}"


class _Prediction(nn.Module):
    """The exported function: every weight (int8: its `q` and `s`) a buffer,
    dequantized and handed to the model's structure by `call_with`."""

    def __init__(self, model_cfg, params: dict, eps: Optional[torch.Tensor]):
        super().__init__()
        self.names = sorted(params)
        for name in self.names:
            v = params[name]
            if isinstance(v, QTensor):
                self.register_buffer(_buffer_name(name, "q"), v.q)
                self.register_buffer(_buffer_name(name, "s"), v.s)
            else:
                self.register_buffer(_buffer_name(name, "w"), v)
        self.quantized = {n for n in self.names if isinstance(params[n], QTensor)}
        self.register_buffer("eps", eps)
        # the structure only (meta device), outside the module tree so that
        # the export lifts none of its parameters
        self.__dict__["structure"] = model_from_params(model_cfg, None)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dtype = self.structure.cfg.dtype
        weights = {}
        for name in self.names:
            if name in self.quantized:
                weights[name] = QTensor(getattr(self, _buffer_name(name, "q")),
                                        getattr(self, _buffer_name(name, "s"))
                                        ).dequantize(dtype)
            else:
                weights[name] = getattr(self, _buffer_name(name, "w"))
        return call_with(self.structure, weights, "day_batched_prediction", x, mask,
                         stochastic=self.eps is not None, eps=self.eps)


def export_prediction(model: nn.Module, config: Config, n_max: int,
                      stochastic: bool = False, int8: bool = False,
                      platform: str = "cuda") -> bytes:
    """The serialized artifact of `model` (a FactorVAE, on any device) under
    `config`: call(x (1, n_max, T, C) f32, mask (1, n_max) bool) -> (1,
    n_max) scores, NaN on padded stocks. One day per call; the registry
    loops days. Exported on the CPU for `platform` (cuda or cpu)."""
    if platform not in PLATFORMS:
        raise ArtifactError(f"export platform must be one of {PLATFORMS}; got "
                            f"{platform!r} (the port exports no TPU programs)")
    cfg = config.model
    params = {n: t.detach().to("cpu", copy=True) for n, t in model.state_dict().items()}
    if int8:
        params = quantize_params(params)
    eps = None
    if stochastic:
        eps = torch.randn((1, int(n_max)), generator=torch.Generator().manual_seed(0))
    module = _Prediction(cfg, params, eps).eval()
    args = (torch.zeros((1, int(n_max), cfg.seq_len, cfg.num_features), dtype=torch.float32),
            torch.ones((1, int(n_max)), dtype=torch.bool))
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(module, args)
    timeline_compile(f"export:{config.checkpoint_name()}", t0, time.perf_counter())
    buf = io.BytesIO()
    torch.export.save(program, buf)
    header = {
        "format": FORMAT,
        "config_hash": config_hash(config.to_dict()),
        "torch": torch.__version__,
        "n_max": int(n_max),
        "seq_len": int(cfg.seq_len),
        "num_features": int(cfg.num_features),
        "stochastic": bool(stochastic),
        "int8": bool(int8),
        "platforms": [platform],
    }
    return (ARTIFACT_MAGIC + b"\n" + json.dumps(header, sort_keys=True).encode() + b"\n"
            + buf.getvalue())


def read_artifact_header(blob: bytes) -> Optional[dict]:
    """The header dict, or None for a blob without the magic. A blob that
    claims the magic but carries an unparseable header is corrupt:
    ArtifactError."""
    if not blob.startswith(ARTIFACT_MAGIC + b"\n"):
        return None
    line, sep, _ = blob[len(ARTIFACT_MAGIC) + 1:].partition(b"\n")
    try:
        if not sep:
            raise ValueError("missing payload")
        header = json.loads(line.decode())
        if not isinstance(header, dict):
            raise ValueError("header is not an object")
    except ValueError as e:
        raise ArtifactError(f"AOT artifact header is corrupt ({e}); re-export with "
                            "eval/export_aot.export_prediction or cli --export") from None
    return header


class LoadedArtifact:
    """A loaded artifact: `call(x, mask) -> (1, n_max)` on `device`, and the
    validated `header`."""

    def __init__(self, program, header: dict, device: torch.device):
        self.program = program
        self.module = program.module()
        self.header = header
        self.device = device

    def call(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Scores (1, n_max) f32 for x (1, n_max, T, C) and mask (1, n_max)
        on `device`."""
        with torch.inference_mode():
            return self.module(x, mask)


def load_exported(blob: bytes, expect_config_hash: Optional[str] = None,
                  device=None) -> LoadedArtifact:
    """Validate the header, then deserialize the program and move it to
    `device` (default: the platform the header names). A config-hash
    mismatch, a torch-version skew, a JAX artifact, a blob without a header
    or a payload that does not deserialize raise a one-line
    ArtifactError."""
    # the ops the graph calls must be registered before the load
    import factorvae_tpu_torch.ops.kernels.attention  # noqa: F401
    import factorvae_tpu_torch.ops.kernels.gru  # noqa: F401

    header = read_artifact_header(blob)
    if header is None:
        raise ArtifactError("blob has no factorvae AOT header; export one with "
                            "eval/export_aot.export_prediction or cli --export")
    if "jax" in header or header.get("format") != FORMAT:
        raise ArtifactError(
            f"AOT artifact is a JAX StableHLO export (format {header.get('format')!r}, "
            f"jax {header.get('jax')}); factorvae_tpu_torch loads {FORMAT} artifacts: "
            "re-export with python -m factorvae_tpu_torch.cli --export")
    if expect_config_hash is not None and header.get("config_hash") != expect_config_hash:
        raise ArtifactError(
            f"AOT artifact is for config {header.get('config_hash')}, expected "
            f"{expect_config_hash}; re-export from the matching weights (cli --export)")
    if header.get("torch") != torch.__version__:
        raise ArtifactError(
            f"AOT artifact was exported under torch {header.get('torch')} but this "
            f"runtime is {torch.__version__}; re-export it with this torch (cli --export)")
    device = torch.device(device if device is not None else header["platforms"][0])
    try:
        program = torch.export.load(io.BytesIO(blob.split(b"\n", 2)[2]))
    except Exception as e:   # noqa: BLE001 - any deserializer failure is one line
        raise ArtifactError(f"AOT artifact failed to deserialize ({type(e).__name__}: "
                            f"{str(e)[:200]}); the payload is truncated or not a "
                            "torch.export program: re-export with cli --export") from None
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return LoadedArtifact(program, header, device)
