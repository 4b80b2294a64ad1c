"""Whole-list swap-or-not shuffle: the CUDA kernel and its plain version.

Reference parity: the optimized whole-list shuffle behind the reference's
``shuffling`` feature (ethereum-consensus/src/phase0/helpers.rs:287). The
per-round pivot and source-byte material is small and data-independent,
so it is a host precompute (``shuffling.shuffle_sources``: SHUFFLE_ROUND_COUNT
x ceil(count/256) SHA-256 calls); the per-index permutation runs on the
card, the half of each round's row that the round reads staged in each
SM's shared memory.

Two paths, bit-identical to models.phase0.helpers.compute_shuffled_index:
  - ``shuffle_cuda``: the Hopper kernel in ``csrc/shuffle.cu``;
  - ``shuffle_plain``: the same rounds as int64 tensor ops.
``shuffle`` takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..shuffling import shuffle_sources

__all__ = [
    "launch_count",
    "shuffle",
    "shuffle_cuda",
    "shuffle_plain",
    "shuffle_sources",
    "shuffled_indices",
    "shuffled_indices_plain",
]

# Kernel launches since the count was last set to 0 (``shuffle_cuda`` adds
# one per launch and nowhere else).
launch_count = 0


def _check(pivots: torch.Tensor, sources: torch.Tensor, count: int) -> None:
    if pivots.dtype != torch.int64 or sources.dtype != torch.uint8:
        raise TypeError(
            f"pivots must be int64 and sources uint8, got {pivots.dtype}, {sources.dtype}"
        )
    if count <= 0:
        raise ValueError(f"count must be positive, got {count}")
    if pivots.dim() != 1 or sources.dim() != 2 or sources.shape[0] != pivots.shape[0]:
        raise ValueError(
            f"need pivots (rounds,) and sources (rounds, bytes), got "
            f"{tuple(pivots.shape)}, {tuple(sources.shape)}"
        )
    if sources.shape[1] < 32 * ((count + 255) // 256):
        raise ValueError(f"source rows of {sources.shape[1]} bytes are too short for {count}")
    if pivots.device != sources.device:
        raise ValueError("pivots and sources must be on one device")
    # one conditional subtraction reduces pivot + count - idx only when
    # pivot < count; a larger pivot would read past the source rows
    if bool(((pivots < 0) | (pivots >= count)).any()):
        raise ValueError(f"pivots must lie in [0, {count})")


def shuffle_plain(pivots: torch.Tensor, sources: torch.Tensor, count: int) -> torch.Tensor:
    """The swap-or-not map of every index in plain PyTorch: (count,) int64
    with out[i] == compute_shuffled_index(i, count, seed)."""
    _check(pivots, sources, count)
    idx = torch.arange(count, dtype=torch.int64, device=pivots.device)
    for r in range(pivots.shape[0]):
        flip = pivots[r] + count - idx
        flip = torch.where(flip >= count, flip - count, flip)
        position = torch.maximum(idx, flip)
        byte = sources[r][position >> 3].to(torch.int64)
        idx = torch.where(((byte >> (position & 7)) & 1) == 1, flip, idx)
    return idx


def shuffle_cuda(pivots: torch.Tensor, sources: torch.Tensor, count: int) -> torch.Tensor:
    """The swap-or-not map of every index on the card (csrc/shuffle.cu)."""
    _check(pivots, sources, count)
    if pivots.device.type != "cuda":
        raise ValueError(f"shuffle_cuda needs CUDA tensors, got {pivots.device}")
    if not (pivots.is_contiguous() and sources.is_contiguous()):
        raise ValueError("pivots and sources must be contiguous")
    return _launch(pivots, sources, count)


def _launch(pivots: torch.Tensor, sources: torch.Tensor, count: int) -> torch.Tensor:
    """The launch alone, on inputs ``shuffle_cuda`` has checked (the pivot
    check waits for the card, so kernel timings call this directly). The
    kernel copies 16-byte pieces of rows from 16-byte aligned addresses, so
    longer rows are cut to the ones the count reads, and an unaligned table
    is copied."""
    global launch_count
    lib = _kernels.load("shuffle")
    row_bytes = 32 * ((count + 255) // 256)
    if sources.shape[1] != row_bytes or sources.data_ptr() % 16:
        sources = sources[:, :row_bytes].clone()
    out = torch.empty((count,), dtype=torch.int64, device=pivots.device)
    with torch.cuda.device(pivots.device):
        stream = torch.cuda.current_stream(pivots.device).cuda_stream
        rc = lib.shuffle_launch(
            pivots.data_ptr(), sources.data_ptr(), row_bytes,
            pivots.shape[0], count, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"shuffle kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return out


def shuffle(pivots: torch.Tensor, sources: torch.Tensor, count: int) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if pivots.device.type == "cpu":
        return shuffle_plain(pivots, sources, count)
    return shuffle_cuda(pivots, sources, count)


def _tables(count: int, seed: bytes, rounds: int, device):
    pivots, sources = shuffle_sources(count, seed, rounds)
    return torch.from_numpy(pivots).to(device), torch.from_numpy(sources).to(device)


def shuffled_indices(count: int, seed: bytes, rounds: int, device="cuda") -> torch.Tensor:
    """out[i] == compute_shuffled_index(i, count, seed) for every index, as
    an int64 tensor on ``device`` (the kernel on a CUDA device)."""
    return shuffle(*_tables(count, seed, rounds, device), count)


def shuffled_indices_plain(count: int, seed: bytes, rounds: int, device="cpu") -> torch.Tensor:
    """``shuffled_indices`` through the plain version."""
    return shuffle_plain(*_tables(count, seed, rounds, device), count)
