"""Device-resident SSZ merkle tree reduction: the multi-level merkle kernel
(B2) and its plain version.

Computes a full binary merkle root from packed 32-byte chunks on the card.
Virtual padding to huge SSZ limits (e.g. VALIDATOR_REGISTRY_LIMIT = 2^40)
is applied by chaining precomputed zero-subtree hashes above the populated
subtree — identical semantics to ssz/merkle.py's host merkleizer.

Two paths, bit-identical:
  - ``reduce_levels_cuda``: the Hopper kernel in ``csrc/merkle.cu`` — each
    block reduces 2^8 to 2^11 nodes level by level in shared memory, then a
    launch of one block reduces the block roots and chains the zero
    siblings to the depth (two launches up to 2^22 nodes, one up to 2^8);
  - ``reduce_levels_plain``: one ``sha256_64b_plain`` call per level, odd
    levels padded with the level's zero word, then the zero chain.
``reduce_levels`` takes the plain version for a CPU tensor only; for a CUDA
tensor it launches the kernel or raises.

Reference parity: ethereum_consensus_tpu/ops/merkle.py (``reduce_levels``
:44, ``merkle_root_words`` :73, ``merkleize_chunks_device`` :83), itself
``ssz_rs`` hash_tree_root merkleization (SURVEY.md L0).
"""

from __future__ import annotations

import functools

import torch

from .. import _kernels
from ..convert import chunks_from_words, words_from_chunks
from ..ssz.merkle import BYTES_PER_CHUNK, next_pow_of_two, zero_hash
from .sha256 import sha256_64b_plain

__all__ = [
    "launch_count",
    "merkle_root_words",
    "merkleize_chunks_device",
    "reduce_levels",
    "reduce_levels_cuda",
    "reduce_levels_plain",
    "zero_hash_words",
]

_MAX_DEPTH = 64
# the kernel's schedule (csrc/merkle_core.h): log2 of a block's nodes, the
# blocks that fill the card, the most block roots the tail takes
BLOCK_LOG2 = (8, 11)
FILL_BLOCKS = 512
TAIL_NODES = 1 << BLOCK_LOG2[1]

# Grid launches since the count was last set to 0 (``reduce_levels_cuda``
# adds those of its call, and nowhere else).
launch_count = 0


@functools.lru_cache(maxsize=None)
def zero_hash_words(device="cpu") -> torch.Tensor:
    """(64, 8) int32: zero-subtree root at each depth, as big-endian words."""
    table = b"".join(zero_hash(d) for d in range(_MAX_DEPTH))
    return words_from_chunks(table, device).T.contiguous()


def _check(nodes: torch.Tensor, zero_words: torch.Tensor, depth: int, start_level: int) -> int:
    if nodes.dtype != torch.int32 or zero_words.dtype != torch.int32:
        raise TypeError("node and zero words must be torch.int32")
    if nodes.dim() != 2 or nodes.shape[0] != 8 or nodes.shape[1] < 1:
        raise ValueError(f"nodes must be (8, N) with N >= 1, got {tuple(nodes.shape)}")
    if tuple(zero_words.shape) != (_MAX_DEPTH, 8) or zero_words.device != nodes.device:
        raise ValueError("zero_words must be the (64, 8) table on the nodes' device")
    if not 0 <= start_level <= depth <= _MAX_DEPTH:
        raise ValueError(f"need 0 <= start_level <= depth <= 64, got {start_level}, {depth}")
    return nodes.shape[1]


def reduce_levels_plain(
    nodes: torch.Tensor, zero_words: torch.Tensor, depth: int, start_level: int = 0
) -> torch.Tensor:
    """Reduce ``nodes`` (8, N) int32 to the root of a tree whose leaves sit
    ``start_level`` levels above the chunk layer, up to total ``depth``, one
    SHA-256 call a level (the reference's loop). Returns (8,) root words."""
    n = _check(nodes, zero_words, depth, start_level)
    level = start_level
    while n > 1:
        if n % 2 == 1:
            nodes = torch.cat([nodes, zero_words[level][:, None]], dim=1)
            n += 1
        pairs = nodes.reshape(8, n // 2, 2)
        msgs = torch.cat([pairs[:, :, 0], pairs[:, :, 1]], dim=0)
        nodes = sha256_64b_plain(msgs)
        n //= 2
        level += 1
    for d in range(level, depth):
        msgs = torch.cat([nodes, zero_words[d][:, None]], dim=0)
        nodes = sha256_64b_plain(msgs)
    return nodes[:, 0]


def _block_log2(n: int) -> int:
    """log2 of the nodes each block of a launch over n takes (merkle_core.h
    block_log2)."""
    b = BLOCK_LOG2[0]
    while b < BLOCK_LOG2[1] and -(-n >> b) > FILL_BLOCKS:
        b += 1
    return b


def _work_nodes(n: int) -> int:
    """Nodes of the kernel's scratch (merkle_core.h work_nodes): the block
    roots of every launch of more than one block."""
    total = 0
    while True:
        blocks = -(-n >> _block_log2(n))
        if blocks == 1:
            return total
        total += blocks
        if blocks <= TAIL_NODES:
            return total
        n = blocks


def reduce_levels_cuda(
    nodes: torch.Tensor, zero_words: torch.Tensor, depth: int, start_level: int = 0
) -> torch.Tensor:
    """``reduce_levels`` on the card (csrc/merkle.cu): contiguous (8, N)
    int32 CUDA nodes and the (64, 8) table beside them; returns (8,)."""
    global launch_count
    n = _check(nodes, zero_words, depth, start_level)
    if nodes.device.type != "cuda":
        raise ValueError(f"reduce_levels_cuda needs CUDA tensors, got {nodes.device}")
    if not (nodes.is_contiguous() and zero_words.is_contiguous()):
        raise ValueError("nodes and zero_words must be contiguous")
    lib = _kernels.load("merkle")
    work = torch.empty((8, max(_work_nodes(n), 1)), dtype=torch.int32, device=nodes.device)
    out = torch.empty(8, dtype=torch.int32, device=nodes.device)
    with torch.cuda.device(nodes.device):
        stream = torch.cuda.current_stream(nodes.device).cuda_stream
        rc = lib.merkle_root_launch(nodes.data_ptr(), n, zero_words.data_ptr(), start_level,
                                    depth, work.data_ptr(), out.data_ptr(), stream)
    if rc <= 0:
        raise RuntimeError(f"merkle kernel launch failed: CUDA error {-rc}")
    launch_count += rc
    return out


def reduce_levels(
    nodes: torch.Tensor, zero_words: torch.Tensor, depth: int, start_level: int = 0
) -> torch.Tensor:
    """Reduce ``nodes`` (8, N) int32 to the root of a tree whose leaves sit
    ``start_level`` levels above the chunk layer, up to total ``depth``.

    Odd levels are padded with the precomputed ``zero_words`` (64, 8) sibling
    for that level (the host merkleizer's strategy), so sparse trees never
    hash into fully-zero subtrees. Levels above the populated region chain
    zero-subtree siblings. Returns (8,) root words: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if nodes.device.type == "cpu":
        return reduce_levels_plain(nodes, zero_words, depth, start_level)
    return reduce_levels_cuda(nodes.contiguous(), zero_words.contiguous(), depth, start_level)


def merkle_root_words(nodes: torch.Tensor, zero_words: torch.Tensor, depth: int) -> torch.Tensor:
    """Reduce ``nodes`` (8, N) int32 to the root of a depth-``depth`` tree."""
    return reduce_levels(nodes, zero_words, depth)


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
    root = merkle_root_words(words_from_chunks(chunks, device), zero_hash_words(device), depth)
    return chunks_from_words(root[:, None])
