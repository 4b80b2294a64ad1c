"""Sharded SSZ merkleization over a device mesh.

The merkle tree over N leaf chunks is split by leaf range: each shard
reduces its contiguous, aligned 2^k-leaf subtree on its own device with the
multi-level merkle kernel (B2, ``ops/merkle.py``), the shards' 32-byte roots
gather on the mesh's first device, and B2 reduces them from
``start_level = k`` to the tree's depth (the zero chain up to the SSZ limit
included). Bit-identical to ssz/merkle.py's host merkleizer.

Reference parity: ethereum_consensus_tpu/parallel/merkle.py
(``sharded_merkle_root_words`` :37, ``sharded_merkleize_chunks`` :74),
where every device finishes the top tree redundantly after an
``all_gather``; here the first device finishes it.
"""

from __future__ import annotations

import torch

from ..convert import chunks_from_words, words_from_chunks
from ..ops.merkle import reduce_levels, zero_hash_words
from ..ssz.merkle import BYTES_PER_CHUNK, merkleize_chunks, next_pow_of_two, zero_hash
from .mesh import Mesh, all_gather

__all__ = ["sharded_merkle_root_words", "sharded_merkleize_chunks"]


def _local_depth(n: int, n_dev: int) -> int:
    if n % n_dev != 0:
        raise ValueError(f"leaf count {n} not divisible by mesh size {n_dev}")
    local_n = n // n_dev
    if local_n == 0 or local_n & (local_n - 1):
        raise ValueError(f"local leaf count {local_n} must be a power of two")
    return (local_n - 1).bit_length()


def _reduce_shards(shards, zero_words: torch.Tensor, depth: int, local_depth: int,
                   mesh: Mesh) -> torch.Tensor:
    """B2 over each shard's (8, local) words on its device, then over the
    gathered roots from ``local_depth``: the (8,) root on ``devices[0]``."""
    roots = [reduce_levels(words, zero_words.to(words.device), local_depth)
             for words in shards]
    top = all_gather(roots, mesh).T.contiguous()
    return reduce_levels(top, zero_words.to(top.device), depth, start_level=local_depth)


def sharded_merkle_root_words(nodes: torch.Tensor, zero_words: torch.Tensor, depth: int,
                              mesh: Mesh) -> torch.Tensor:
    """Root of a depth-``depth`` tree over ``nodes`` (8, N) int32, N a
    power of two divisible by the mesh size: shard i takes the i-th
    contiguous range of N / n_dev leaves onto ``mesh.devices[i]``.
    ``zero_words`` is the (64, 8) table. Returns the (8,) root words on the
    mesh's first device."""
    n_dev = mesh.n_dev
    local_depth = _local_depth(nodes.shape[1], n_dev)
    local_n = nodes.shape[1] // n_dev
    shards = [nodes[:, i * local_n:(i + 1) * local_n].contiguous().to(device)
              for i, device in enumerate(mesh.devices)]
    return _reduce_shards(shards, zero_words, depth, local_depth, mesh)


def sharded_merkleize_chunks(chunks: bytes, mesh: Mesh, limit: "int | None" = None) -> bytes:
    """Mesh-sharded equivalent of ssz.merkle.merkleize_chunks (bit-identical).

    Pads the populated leaves up to a power-of-two multiple of the mesh size
    with zero chunks; the virtual tree above (up to ``limit``) chains
    zero-subtree hashes exactly like the host merkleizer. A mesh that is not
    a power of two, or one wider than the tree, goes to the host
    merkleizer, as in the reference. Each shard's words are made from its
    own byte range and uploaded to its device."""
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
    if count == 0:
        return zero_hash(depth)

    n_dev = mesh.n_dev
    # shardable only when every shard owns a full, aligned 2^k-leaf subtree
    # inside the virtual tree: mesh size a power of two and <= width
    if n_dev & (n_dev - 1) or n_dev > width:
        return merkleize_chunks(chunks, limit)
    local = max(1, next_pow_of_two(count) // n_dev)
    padded = local * n_dev  # == max(next_pow_of_two(count), n_dev) <= width
    data = chunks + b"\x00" * ((padded - count) * BYTES_PER_CHUNK)
    step = local * BYTES_PER_CHUNK
    shards = [words_from_chunks(data[i * step:(i + 1) * step], device)
              for i, device in enumerate(mesh.devices)]
    root = _reduce_shards(shards, zero_hash_words(mesh.devices[0]), depth,
                          (local - 1).bit_length(), mesh)
    return chunks_from_words(root[:, None])
