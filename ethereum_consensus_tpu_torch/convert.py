"""Carry-across between the reference package, bytes and word tensors.

SSZ bytes are the interchange with ``ethereum_consensus_tpu``: a state the
reference serialized comes across through the port's own ``deserialize``.
Word tensors hold SHA-256's big-endian uint32 words as ``torch.int32`` bit
patterns, one item per column (lanes last), the layout the kernels take.
Field elements come across as canonical integers: ``lv_to_ints`` reads the
reference pairing stack's lazy columns (ops/fql.py there).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.phase0 import containers as phase0_containers
from .crypto.fields import P as P_INT

__all__ = ["chunks_from_words", "lv_to_ints", "state_from_ssz", "words_from_chunks"]

# The reference's lazy field: 24 columns of 16 bits (a column may hold more
# between its multiplications), Montgomery form with R' = 2^416.
_LV_COLUMNS = 24
_R_PRIME_INV = pow(1 << 416, -1, P_INT)


def state_from_ssz(data: bytes, preset):
    """The port's phase0 ``BeaconState`` for the preset, from its SSZ bytes."""
    return phase0_containers.build(preset).BeaconState.deserialize(data)


def words_from_chunks(chunks: bytes, device, width: int = 8) -> torch.Tensor:
    """``(width, N)`` int32 words of N consecutive ``4 * width``-byte items
    (32-byte chunks by default, 64-byte messages with ``width=16``)."""
    n = len(chunks) // (4 * width)
    if n * 4 * width != len(chunks):
        raise ValueError(f"{len(chunks)} bytes is not a whole number of "
                         f"{4 * width}-byte items")
    words = np.frombuffer(chunks, dtype=">u4").reshape(n, width).T
    host = torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32))
    return host.to(device)


def chunks_from_words(t: torch.Tensor) -> bytes:
    """Inverse of ``words_from_chunks``: ``(width, N)`` words to N items."""
    return t.cpu().numpy().view(np.uint32).T.astype(">u4").tobytes()


def lv_to_ints(cols) -> "list[int]":
    """Canonical integers of a reference lazy-field array (numpy uint64, the
    last axis 24 columns of 16 bits, R'-Montgomery), row-major over the
    other axes."""
    rows = np.asarray(cols, dtype=np.uint64).reshape(-1, _LV_COLUMNS)
    return [sum(int(c) << (16 * i) for i, c in enumerate(row)) * _R_PRIME_INV % P_INT
            for row in rows]
