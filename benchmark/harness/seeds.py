"""Seeds of the benchmark's own streams, derived from `--seed` and a stream id
(numpy's SeedSequence, so that any whole number up to 2**64 gives well
mixed, separate streams)."""

from __future__ import annotations

import numpy as np


def stream_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for the benchmark's stream `stream` of run `seed`."""
    state = np.random.SeedSequence([int(seed), 0xBE4C, *map(int, stream)]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator on the benchmark's stream `stream` of run `seed`."""
    return np.random.default_rng(stream_seed(seed, *stream))
