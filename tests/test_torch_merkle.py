"""The port's device merkleizer against the reference's and the host's.

On the CPU the port's ``merkleize_chunks_device(device="cpu")`` runs every
level through the plain SHA-256; the reference's runs through its XLA
kernel. Roots are bytes, so the comparison is exact. The multi-level merkle
kernel (B2, csrc/merkle.cu) cannot run here: its schedule, run on the host
by ``csrc/merkle_core.h`` (each block's levels with its threads in turn,
the blocks in turn, then the tail's one-block launch), is built with g++
and held against the reference's ``reduce_levels`` and a hashlib tree, at
the schedule's seams too.
"""

import ctypes
import hashlib
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ethereum_consensus_tpu.ops import merkle as ref_merkle
from ethereum_consensus_tpu_torch.ops import merkle as port_merkle
from ethereum_consensus_tpu_torch.ops import sha256 as port_sha
from ethereum_consensus_tpu_torch.ssz.merkle import merkleize_chunks
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CSRC = Path(port_merkle.__file__).resolve().parents[1] / "csrc"

# the reference test's grid (tests/test_ops_sha256.py), empty input included
GRID = [
    (1, None), (2, None), (5, None), (8, None), (1, 16), (3, 2**20),
    (1, 2**40), (100, 2**40), (0, 2**40),
]


@pytest.mark.parametrize("count,limit", GRID)
def test_merkleize_device_matches_reference_and_host(count, limit):
    chunks = np.random.default_rng(count).bytes(32 * count)
    got = port_merkle.merkleize_chunks_device(chunks, limit, device="cpu")
    assert got == ref_merkle.merkleize_chunks_device(chunks, limit)
    assert got == merkleize_chunks(chunks, limit)


def test_zero_hash_words_match_reference():
    ref = ref_merkle.zero_hash_words()
    got = port_merkle.zero_hash_words().numpy().view(np.uint32)
    assert got.shape == (64, 8)
    assert (got == ref).all()


def test_merkleize_device_rejects_bad_input():
    with pytest.raises(ValueError):
        port_merkle.merkleize_chunks_device(b"\x00" * 33, device="cpu")
    with pytest.raises(ValueError):
        port_merkle.merkleize_chunks_device(b"\x00" * 96, limit=2, device="cpu")


def test_merkleize_device_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chunks = np.random.default_rng(7).bytes(32 * 5000)
    monkeypatch.setattr(port_sha, "launch_count", 0)
    monkeypatch.setattr(port_merkle, "launch_count", 0)
    got = port_merkle.merkleize_chunks_device(chunks, 2**40, device="cuda")
    assert got == merkleize_chunks(chunks, 2**40)
    # B2: 5,000 leaves in 20 blocks of 256, then one block over their roots
    # that chains the zero siblings to depth 40; no per-level B1 launch
    assert (port_merkle.launch_count, port_sha.launch_count) == (2, 0)


# ---------------------------------------------------------------------------
# B2: reduce_levels and merkle_root_words, with start_level
# ---------------------------------------------------------------------------

# (count, depth, start_level): odd widths, a count of one, depths far above
# the count, and leaves three levels above the chunk layer (the top tree of
# the sharded merkleizer)
REDUCE_CASES = [
    (1, 0, 0), (2, 1, 0), (3, 2, 0), (5, 3, 0), (1025, 11, 0),
    (1, 40, 0), (3, 20, 0), (5, 20, 0), (1025, 40, 0),
    (1, 3, 3), (1, 20, 3), (3, 20, 3), (5, 40, 3), (1025, 20, 3),
]


def _hashlib_root(leaves: bytes, depth: int, start_level: int) -> bytes:
    """The root by hashlib: odd levels padded with the level's zero-subtree
    hash, then the zero chain to ``depth``."""
    zero = [b"\x00" * 32]
    for _ in range(64):
        zero.append(hashlib.sha256(zero[-1] * 2).digest())
    nodes = [leaves[i:i + 32] for i in range(0, len(leaves), 32)]
    level = start_level
    while len(nodes) > 1:
        if len(nodes) % 2:
            nodes.append(zero[level])
        nodes = [hashlib.sha256(nodes[i] + nodes[i + 1]).digest()
                 for i in range(0, len(nodes), 2)]
        level += 1
    root = nodes[0]
    for d in range(level, depth):
        root = hashlib.sha256(root + zero[d]).digest()
    return root


def _words(leaves: bytes) -> np.ndarray:
    n = len(leaves) // 32
    return np.ascontiguousarray(np.frombuffer(leaves, dtype=">u4").reshape(n, 8).T,
                                dtype=np.uint32)


def _root_bytes(words) -> bytes:
    return np.asarray(words, dtype=np.uint32).astype(">u4").tobytes()


@pytest.mark.parametrize("count,depth,start_level", REDUCE_CASES)
def test_reduce_levels_plain_matches_reference_and_hashlib(count, depth, start_level):
    leaves = np.random.default_rng(count + depth).bytes(32 * count)
    words = _words(leaves)
    got = port_merkle.reduce_levels(torch.from_numpy(words.view(np.int32)),
                                    port_merkle.zero_hash_words(), depth, start_level)
    got = _root_bytes(got.numpy().view(np.uint32))
    zero = jnp.asarray(ref_merkle.zero_hash_words())
    if start_level == 0:
        ref = ref_merkle.merkle_root_words(jnp.asarray(words), zero, depth)
    else:
        ref = ref_merkle.reduce_levels(jnp.asarray(words), zero, depth, start_level)
    assert got == _root_bytes(ref)
    assert got == _hashlib_root(leaves, depth, start_level)


def test_merkle_root_words_is_reduce_levels_from_the_chunk_layer():
    words = torch.from_numpy(_words(np.random.default_rng(9).bytes(32 * 7)).view(np.int32))
    zero = port_merkle.zero_hash_words()
    assert torch.equal(port_merkle.merkle_root_words(words, zero, 5),
                       port_merkle.reduce_levels_plain(words, zero, 5))


def test_reduce_levels_rejects_what_the_kernel_does_not_take():
    zero = port_merkle.zero_hash_words()
    words = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        port_merkle.reduce_levels(words.to(torch.int64), zero, 2)
    with pytest.raises(ValueError):
        port_merkle.reduce_levels(torch.zeros((8, 0), dtype=torch.int32), zero, 2)
    with pytest.raises(ValueError):
        port_merkle.reduce_levels(words, zero, 2, start_level=3)
    with pytest.raises(ValueError):
        port_merkle.reduce_levels(words, zero, 65)
    with pytest.raises(ValueError):
        port_merkle.reduce_levels_cuda(words, zero, 2)


_HOST_SHIM = r"""
#include "merkle_core.h"
// merkle.cu's launches on the host: the same blocks, levels and zero chain.
extern "C" int merkle_root_host(const uint32_t* nodes, int64_t n, const uint32_t* zero_words,
                                int start_level, int depth, uint32_t* work, uint32_t* root) {
  return merkle_core::merkle_root_host(nodes, n, zero_words, start_level, depth, work, root);
}
extern "C" int64_t merkle_work_nodes(int64_t n) { return merkle_core::work_nodes(n); }
"""


@pytest.fixture(scope="session")
def merkle_core_host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("merkle_core")
    shim = tmp / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    lib_path = tmp / "libmerkle_core.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
         f"-I{CSRC}", str(shim), "-o", str(lib_path)],
        check=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.merkle_root_host.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.merkle_root_host.restype = ctypes.c_int
    lib.merkle_work_nodes.argtypes = [ctypes.c_int64]
    lib.merkle_work_nodes.restype = ctypes.c_int64
    zero = np.ascontiguousarray(ref_merkle.zero_hash_words())

    def root(leaves: bytes, depth: int, start_level: int = 0) -> "tuple[bytes, int]":
        words = _words(leaves)
        n = words.shape[1]
        work_n = lib.merkle_work_nodes(n)
        assert work_n == port_merkle._work_nodes(n)
        work = np.zeros((8, max(work_n, 1)), dtype=np.uint32)
        out = np.zeros(8, dtype=np.uint32)
        launches = lib.merkle_root_host(words.ctypes.data, n, zero.ctypes.data, start_level,
                                        depth, work.ctypes.data, out.ctypes.data)
        return _root_bytes(out), launches

    return root


@pytest.mark.parametrize("count,depth,start_level", REDUCE_CASES)
def test_kernel_header_host_build_matches_reference(merkle_core_host, count, depth,
                                                    start_level):
    leaves = np.random.default_rng(count + depth).bytes(32 * count)
    got, launches = merkle_core_host(leaves, depth, start_level)
    assert got == _hashlib_root(leaves, depth, start_level)
    zero = jnp.asarray(ref_merkle.zero_hash_words())
    ref = ref_merkle.reduce_levels(jnp.asarray(_words(leaves)), zero, depth, start_level)
    assert got == _root_bytes(ref)
    assert launches == (1 if count <= 256 else 2)


# (count, depth, start_level) at the schedule's seams: four leaves (two
# pairs); one block's 2^8 leaves and one more or fewer (the tail
# alone, or two blocks and the tail over their roots); a block past the last
# live node (257: its one leaf chained up its block's levels, then the
# tail); 2^17, the most leaves in blocks of 2^8, and one more (blocks of
# 2^9); blocks of 2^10 and 2^11, where a thread takes two or four pairs, the
# last block one leaf short or one leaf alone; the zero chain to the table's
# last row (depth 64), from the leaf layer, from level 10 and with leaves
# three levels up; more leaves than the depth holds (the reference reduces
# them to one)
SEAM_CASES = [
    (4, 2, 0), (255, 8, 0), (256, 8, 0), (257, 9, 0), (257, 40, 0),
    (1 << 17, 17, 0), ((1 << 17) + 1, 40, 0), ((1 << 18) + 1023, 40, 0),
    ((1 << 18) + 1025, 40, 0), ((1 << 19) + 2047, 40, 0), ((1 << 19) + 2049, 40, 0),
    (1, 64, 0), (1, 64, 10), (3, 64, 3), (1025, 64, 3), (5, 4, 3),
]


@pytest.mark.parametrize("count,depth,start_level", SEAM_CASES)
def test_kernel_header_host_build_at_the_schedule_seams(merkle_core_host, count, depth,
                                                        start_level):
    leaves = np.random.default_rng(count + depth + 1).bytes(32 * count)
    got, launches = merkle_core_host(leaves, depth, start_level)
    if count > 1 << 16:  # the host merkleizer is quicker than hashlib from Python
        assert start_level == 0 and got == merkleize_chunks(leaves, 2**depth)
    else:
        assert got == _hashlib_root(leaves, depth, start_level)
    assert launches == (1 if count <= 256 else 2)


def test_kernel_header_host_build_at_registry_scale(merkle_core_host):
    """2^20 leaves at the registry limit 2^40: two launches (512 blocks of
    2^11, then the tail over their roots and the zero chain), the host
    merkleizer's root."""
    leaves = np.random.default_rng(20).bytes(32 << 20)
    got, launches = merkle_core_host(leaves, 40)
    assert launches == 2
    assert got == merkleize_chunks(leaves, 2**40)


def test_kernel_header_host_build_past_one_tail(merkle_core_host):
    """2^22 + 2^11 + 1 leaves: 2,050 block roots, more than the tail takes,
    so a second block launch (9 blocks of 2^8) comes before the tail."""
    leaves = np.random.default_rng(21).bytes(32 * ((1 << 22) + 2049))
    got, launches = merkle_core_host(leaves, 40)
    assert launches == 3
    assert got == merkleize_chunks(leaves, 2**40)


@pytest.mark.parametrize("count,depth,start_level", REDUCE_CASES)
def test_kernel_matches_plain_on_card(count, depth, start_level):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    words = torch.from_numpy(_words(np.random.default_rng(count).bytes(32 * count))
                             .view(np.int32)).cuda()
    zero = port_merkle.zero_hash_words("cuda")
    got = port_merkle.reduce_levels(words, zero, depth, start_level)
    torch.cuda.synchronize()
    assert torch.equal(got, port_merkle.reduce_levels_plain(words, zero, depth, start_level))
