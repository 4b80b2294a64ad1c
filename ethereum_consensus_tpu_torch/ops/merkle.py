"""Device-resident SSZ merkle tree reduction.

Computes a full binary merkle root from packed 32-byte chunks on the card:
every tree level is one launch of the SHA-256 kernel (ops/sha256.py), and
the levels stay in device memory. Virtual padding to huge SSZ limits (e.g.
VALIDATOR_REGISTRY_LIMIT = 2^40) is applied by chaining precomputed
zero-subtree hashes above the populated subtree — identical semantics to
ssz/merkle.py's host merkleizer.

Reference parity: `ssz_rs` hash_tree_root merkleization (SURVEY.md L0).
"""

from __future__ import annotations

import functools

import torch

from ..convert import chunks_from_words, words_from_chunks
from ..ssz.merkle import BYTES_PER_CHUNK, next_pow_of_two, zero_hash
from .sha256 import sha256_64b

__all__ = [
    "merkleize_chunks_device",
    "reduce_levels",
    "zero_hash_words",
]

_MAX_DEPTH = 64


@functools.lru_cache(maxsize=None)
def zero_hash_words(device="cpu") -> torch.Tensor:
    """(64, 8) int32: zero-subtree root at each depth, as big-endian words."""
    table = b"".join(zero_hash(d) for d in range(_MAX_DEPTH))
    return words_from_chunks(table, device).T.contiguous()


def reduce_levels(
    nodes: torch.Tensor, zero_words: torch.Tensor, depth: int, start_level: int = 0
) -> torch.Tensor:
    """Reduce ``nodes`` (8, N) int32 to the root of a tree whose leaves sit
    ``start_level`` levels above the chunk layer, up to total ``depth``.

    Odd levels are padded with the precomputed ``zero_words`` (64, 8) sibling
    for that level (the host merkleizer's strategy), so sparse trees never
    hash into fully-zero subtrees. Levels above the populated region chain
    zero-subtree siblings. Returns (8,) root words."""
    n = nodes.shape[1]
    level = start_level
    while n > 1:
        if n % 2 == 1:
            nodes = torch.cat([nodes, zero_words[level][:, None]], dim=1)
            n += 1
        pairs = nodes.reshape(8, n // 2, 2)
        msgs = torch.cat([pairs[:, :, 0], pairs[:, :, 1]], dim=0)
        nodes = sha256_64b(msgs)
        n //= 2
        level += 1
    for d in range(level, depth):
        msgs = torch.cat([nodes, zero_words[d][:, None]], dim=0)
        nodes = sha256_64b(msgs)
    return nodes[:, 0]


def merkleize_chunks_device(chunks: bytes, limit: int | None = None,
                            device="cuda") -> bytes:
    """Device equivalent of ssz.merkle.merkleize_chunks on ``device``.

    Bit-identical to the host merkleizer; intended for large chunk counts
    (validator registries, balance lists, big leaf ranges)."""
    if len(chunks) % BYTES_PER_CHUNK != 0:
        raise ValueError("chunks must be a multiple of 32 bytes")
    count = len(chunks) // BYTES_PER_CHUNK
    if limit is None:
        width = next_pow_of_two(count)
    else:
        if count > limit:
            raise ValueError(f"chunk count {count} exceeds limit {limit}")
        width = next_pow_of_two(limit)
    depth = (width - 1).bit_length()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("merkleize_chunks_device: no CUDA device is available")
    if count == 0:
        return zero_hash(depth)
    root = reduce_levels(
        words_from_chunks(chunks, device), zero_hash_words(device), depth
    )
    return chunks_from_words(root[:, None])
