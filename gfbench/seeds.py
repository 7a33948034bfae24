"""Seeds of the benchmark's streams, all derived from the run's --seed."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, name: str, index) -> int:
    """A 64-bit seed for stream ``name`` at ``index`` (an int, -1 and up,
    or a label) of the run seeded ``seed`` (any whole number >= 0)."""
    if isinstance(index, str):
        index = zlib.crc32(index.encode())
    else:
        index = int(index) + 1
    entropy = [int(seed), zlib.crc32(name.encode()), index]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0])
