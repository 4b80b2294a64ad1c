"""The swap-or-not shuffle's per-round hash schedule.

Free of torch: the host whole-list map (models/phase0/helpers.py) and the
device kernel's wrapper (ops/shuffle.py) both read their pivots and
source bytes from here.
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["shuffle_sources"]


def shuffle_sources(count: int, seed: bytes, rounds: int):
    """Per-round pivots and source-byte tables.

    Returns (pivots: (rounds,) int64, sources: (rounds, n_chunks*32)
    uint8) where sources[r] concatenates sha256(seed + r + chunk) for every
    256-index chunk (helpers.rs:287's hash schedule)."""
    if count <= 0:
        raise ValueError("empty index list")
    n_chunks = (count + 255) // 256
    pivots = np.empty(rounds, dtype=np.int64)
    sources = np.empty((rounds, n_chunks * 32), dtype=np.uint8)
    for r in range(rounds):
        round_byte = r.to_bytes(1, "little")
        pivots[r] = (
            int.from_bytes(hashlib.sha256(seed + round_byte).digest()[:8], "little")
            % count
        )
        sources[r] = np.frombuffer(
            b"".join(
                hashlib.sha256(seed + round_byte + chunk.to_bytes(4, "little")).digest()
                for chunk in range(n_chunks)
            ),
            dtype=np.uint8,
        )
    return pivots, sources
