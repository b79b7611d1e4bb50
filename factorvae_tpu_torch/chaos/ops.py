"""The chaos faults' host-side effects (`factorvae_tpu/chaos/ops.py`): a
hard kill of this process, deterministic byte flips in a file or in a
checkpoint step's payload, and a JSONL stream torn mid-line. Each is seeded
and returns what it did."""

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


def corrupt_checkpoint_step(directory: str, step: int, rng_seed: int = 0,
                            n_bytes: int = 16) -> str:
    """Flip bytes of one committed step's payload file
    (`<directory>/epoch_<step>.pt`, `train/checkpoint.py`); returns the file
    hit."""
    path = os.path.join(os.path.abspath(directory), f"epoch_{int(step)}.pt")
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        raise FileNotFoundError(f"no payload file {path}: is step {step} committed?")
    corrupt_file(path, rng_seed=rng_seed, n_bytes=n_bytes)
    return path


def tear_jsonl(path: str, keep_frac: float = 0.6, rng_seed: int = 0) -> int:
    """Truncate a JSONL stream mid-line, as a kill during a write leaves it:
    the first lines up to `keep_frac` of them survive, the last kept one cut
    at a seeded offset inside it. Returns the new size in bytes."""
    with open(path, "rb") as fh:
        data = fh.read()
    lines = data.splitlines(keepends=True)
    if not lines:
        raise ValueError(f"cannot tear empty stream {path}")
    keep = max(1, int(len(lines) * keep_frac))
    head = b"".join(lines[:keep - 1])
    last = lines[keep - 1]
    rng = np.random.default_rng(rng_seed)
    # at least one byte of the line survives, and at least its newline is lost
    cut = int(rng.integers(1, max(2, len(last) - 1)))
    with open(path, "wb") as fh:
        fh.write(head + last[:cut])
    return len(head) + cut


def kill_now() -> None:
    """SIGKILL this process: no atexit handler, no flushed buffer, the crash
    that a commit protocol must survive."""
    os.kill(os.getpid(), signal.SIGKILL)
