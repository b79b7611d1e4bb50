"""The chaos faults' host-side effects (`factorvae_tpu/chaos/ops.py`, in
part): a hard kill of this process and deterministic byte flips in a file."""

from __future__ import annotations

import os
import signal
from typing import List

import numpy as np


def corrupt_file(path: str, rng_seed: int = 0, n_bytes: int = 16) -> List[int]:
    """Flip `n_bytes` bytes of `path` in place, at offsets drawn from
    `rng_seed` (XOR 0xFF, never a no-op); returns the offsets."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path}")
    rng = np.random.default_rng(rng_seed)
    offsets = sorted({int(o) for o in rng.integers(0, size, size=min(n_bytes, size))})
    with open(path, "r+b") as fh:
        for off in offsets:
            fh.seek(off)
            b = fh.read(1)
            fh.seek(off)
            fh.write(bytes([b[0] ^ 0xFF]))
    return offsets


def kill_now() -> None:
    """SIGKILL this process: no atexit handler, no flushed buffer, the crash
    that a commit protocol must survive."""
    os.kill(os.getpid(), signal.SIGKILL)
