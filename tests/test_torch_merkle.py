"""The port's device merkleizer against the reference's and the host's.

On the CPU the port's ``merkleize_chunks_device(device="cpu")`` runs every
level through the plain SHA-256; the reference's runs through its XLA
kernel. Roots are bytes, so the comparison is exact.
"""

import numpy as np
import pytest
import torch

from ethereum_consensus_tpu.ops import merkle as ref_merkle
from ethereum_consensus_tpu_torch.ops import merkle as port_merkle
from ethereum_consensus_tpu_torch.ops import sha256 as port_sha
from ethereum_consensus_tpu_torch.ssz.merkle import merkleize_chunks
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

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
    got = port_merkle.merkleize_chunks_device(chunks, 2**40, device="cuda")
    assert got == merkleize_chunks(chunks, 2**40)
    assert port_sha.launch_count == 40  # one launch per level
