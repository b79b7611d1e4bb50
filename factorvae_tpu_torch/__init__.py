"""PyTorch/CUDA port of factorvae_tpu for NVIDIA Hopper (H100).

The JAX package `factorvae_tpu` is the reference this package is held
against; nothing here imports it (or jax, flax or pandas on the scoring
path). The CUDA kernels live in `csrc/` and are built at first use
(`_build.py`).
"""
