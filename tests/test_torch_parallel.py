"""The port's sharded twins (``parallel/``) against the reference's.

The reference shards over a virtual n-device JAX CPU mesh, which needs a
fresh process: one subprocess (``conftest.run_in_cpu_mesh``, 8 devices)
computes every reference result of this file once. The port runs each twin
on ``virtual_mesh(n, "cpu")``: n shards of the host, each through the
kernels' plain versions. Roots, u64 columns, Fq12 products and affine
signature sums must be equal exactly, at the same shard count:

* ``sharded_merkleize_chunks`` at n in {1, 2, 3, 4, 8} (3 goes to the host
  merkleizer in both packages), odd counts, limits far above the count;
* ``MeshEpochSweeps`` (inactivity, fused, rewards) at n in {1, 3, 4} on
  seeded columns with u64 edge rows, and its wrap census.

The pairing twin has a file of its own (``test_torch_parallel_pairing.py``),
so that the two reference subprocesses, each mostly JAX compilation, run on
two test workers.
"""

import json

import numpy as np
import pytest
import torch

from conftest import run_in_cpu_mesh
from ethereum_consensus_tpu_torch.ops import epoch as ops_epoch
from ethereum_consensus_tpu_torch.parallel import (
    Mesh,
    all_gather,
    psum_words,
    sharded_merkle_root_words,
    sharded_merkleize_chunks,
    virtual_mesh,
)
from ethereum_consensus_tpu_torch.parallel import epoch as port_epoch
from ethereum_consensus_tpu_torch.ssz.merkle import merkleize_chunks
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

MERKLE_MESHES = (1, 2, 3, 4, 8)
MERKLE_CASES = [(1, None), (5, None), (1025, 2**16)]
EPOCH_MESHES = (1, 3, 4)

# The epoch columns, made the same way in the reference's subprocess and
# here: seeded numpy, an odd length (padding is live on every mesh) and u64
# edge rows whose products wrap (zero balances there, so no add wraps).
EPOCH_INPUTS = r"""
import numpy as np

def epoch_columns():
    rng = np.random.default_rng(12)
    n = 1003
    eff = rng.integers(0, 33, n, dtype=np.uint64) * np.uint64(10**9)
    balances = eff + rng.integers(0, 10**9, n, dtype=np.uint64)
    prev_part = rng.integers(0, 8, n, dtype=np.uint8)
    slashed = rng.random(n) < 0.05
    active_prev = rng.random(n) < 0.9
    eligible = active_prev | (rng.random(n) < 0.02)
    scores = rng.integers(0, 50, n, dtype=np.uint64)
    edges = [2**63, 2**64 - 1, 2**63 + 12345, 2**40 + 7]
    for i, word in enumerate(edges):
        eff[100 + i] = np.uint64(word)
        scores[200 + i] = np.uint64(word)
        balances[100 + i] = 0
        balances[200 + i] = 0
    return balances, eff, prev_part, slashed, active_prev, eligible, scores

EPOCH_KWARGS = dict(increment=10**9, brpi=31414, active_increments=27000,
                    denominator=4 * (1 << 24), weights=(14, 26, 14),
                    weight_denominator=64, head_flag_index=2, target_flag_index=1)
"""
exec(EPOCH_INPUTS)  # epoch_columns, EPOCH_KWARGS  # noqa: S102

REFERENCE = EPOCH_INPUTS + r"""
import json
import jax
jax.config.update("jax_enable_x64", True)
from ethereum_consensus_tpu.parallel import chip_mesh, sharded_merkleize_chunks
from ethereum_consensus_tpu.parallel.epoch import MeshEpochSweeps

out = {"merkle": {}, "epoch": {}}
for n_dev in MERKLE_MESHES:
    mesh = chip_mesh(n_dev)
    for count, limit in MERKLE_CASES:
        chunks = np.random.default_rng(count).bytes(32 * count)
        out["merkle"][f"{n_dev}-{count}-{limit}"] = sharded_merkleize_chunks(
            chunks, mesh, limit=limit).hex()

cols = epoch_columns()
balances, eff, prev_part, slashed, active_prev, eligible, scores = cols
participating = active_prev & ~slashed & ((prev_part >> 1) & 1).astype(bool)
for n_dev in EPOCH_MESHES:
    runner = MeshEpochSweeps(chip_mesh(n_dev))
    res = {}
    for leaking in (False, True):
        res[f"inactivity-{leaking}"] = runner.inactivity_scores(
            scores, eligible, participating, 4, 16, leaking).tolist()
        new_scores, new_balances = runner.fused(*cols, bias=4, recovery_rate=16,
                                                leaking=leaking, **EPOCH_KWARGS)
        res[f"fused-{leaking}"] = [new_scores.tolist(), new_balances.tolist()]
        res[f"rewards-{leaking}"] = runner.rewards(*cols, leaking=leaking,
                                                   **EPOCH_KWARGS).tolist()
    hot = balances.copy()
    hot[1] = np.uint64(2**64 - 1)
    res["wrapped"] = runner.fused(hot, eff, np.full(len(hot), 7, np.uint8),
                                  np.zeros(len(hot), bool), np.ones(len(hot), bool),
                                  np.ones(len(hot), bool), scores, bias=4, recovery_rate=16,
                                  leaking=False, **EPOCH_KWARGS) is None
    out["epoch"][str(n_dev)] = res

print("REFERENCE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    code = (f"MERKLE_MESHES = {MERKLE_MESHES!r}\nMERKLE_CASES = {MERKLE_CASES!r}\n"
            f"EPOCH_MESHES = {EPOCH_MESHES!r}\n" + REFERENCE)
    out = run_in_cpu_mesh(code, n_devices=8)
    line = next(x for x in out.splitlines() if x.startswith("REFERENCE "))
    return json.loads(line[len("REFERENCE "):])


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------


def test_psum_words_adds_mod_2_64():
    parts = [torch.tensor([-1, 5, 2**62], dtype=torch.int64), [1, 2**64 - 3, 2**62]]
    assert psum_words(parts) == (0, 2, 2**63)
    with pytest.raises(ValueError):
        psum_words([])


def test_all_gather_stacks_on_the_first_device():
    mesh = virtual_mesh(3, "cpu")
    got = all_gather([torch.full((2,), i) for i in range(3)], mesh)
    assert got.tolist() == [[0, 0], [1, 1], [2, 2]] and got.device == mesh.devices[0]


def test_mesh_rejects_no_devices():
    with pytest.raises(ValueError):
        Mesh(())
    with pytest.raises(ValueError):
        virtual_mesh(0, "cpu")


# ---------------------------------------------------------------------------
# the merkle twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("count,limit", MERKLE_CASES)
@pytest.mark.parametrize("n_dev", MERKLE_MESHES)
def test_sharded_merkleize_matches_reference(reference, n_dev, count, limit):
    chunks = np.random.default_rng(count).bytes(32 * count)
    got = sharded_merkleize_chunks(chunks, virtual_mesh(n_dev, "cpu"), limit=limit)
    assert got.hex() == reference["merkle"][f"{n_dev}-{count}-{limit}"]
    assert got == merkleize_chunks(chunks, limit)


def test_sharded_merkle_root_words_rejects_unaligned_shards():
    words = torch.zeros((8, 12), dtype=torch.int32)
    zero = torch.zeros((64, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_merkle_root_words(words, zero, 4, virtual_mesh(5, "cpu"))
    with pytest.raises(ValueError, match="power of two"):
        sharded_merkle_root_words(words, zero, 4, virtual_mesh(4, "cpu"))


# ---------------------------------------------------------------------------
# the epoch twin
# ---------------------------------------------------------------------------


def _u64(values) -> np.ndarray:
    return np.asarray(values, dtype=np.uint64)


def test_pad_to_mesh():
    assert [port_epoch.pad_to_mesh(n, 4) for n in (1, 4, 5, 1003)] == [4, 4, 8, 1004]
    assert port_epoch.pad_to_mesh(1003, 3) == 1005


@pytest.mark.parametrize("leaking", [False, True])
@pytest.mark.parametrize("n_dev", EPOCH_MESHES)
def test_mesh_epoch_sweeps_match_reference(reference, n_dev, leaking):
    cols = epoch_columns()
    balances, eff, prev_part, slashed, active_prev, eligible, scores = cols
    participating = active_prev & ~slashed & ((prev_part >> 1) & 1).astype(bool)
    runner = port_epoch.MeshEpochSweeps(virtual_mesh(n_dev, "cpu"))
    want = reference["epoch"][str(n_dev)]
    got = runner.inactivity_scores(scores, eligible, participating, 4, 16, leaking)
    assert np.array_equal(got, _u64(want[f"inactivity-{leaking}"]))
    new_scores, new_balances = runner.fused(*cols, bias=4, recovery_rate=16, leaking=leaking,
                                            **EPOCH_KWARGS)
    assert np.array_equal(new_scores, _u64(want[f"fused-{leaking}"][0]))
    assert np.array_equal(new_balances, _u64(want[f"fused-{leaking}"][1]))
    rewards = runner.rewards(*cols, leaking=leaking, **EPOCH_KWARGS)
    assert np.array_equal(rewards, _u64(want[f"rewards-{leaking}"]))
    # and the unsharded fused kernel's plain version
    want_scores, want_balances, wrapped = ops_epoch.fused_epoch_device(
        *cols, bias=4, recovery_rate=16, leaking=leaking, device="cpu", **EPOCH_KWARGS)
    assert wrapped == 0
    assert np.array_equal(new_scores, want_scores)
    assert np.array_equal(new_balances, want_balances)


@pytest.mark.parametrize("n_dev", EPOCH_MESHES)
def test_mesh_epoch_wrap_census_returns_none(reference, n_dev):
    balances, eff, _, _, _, _, scores = epoch_columns()
    hot = balances.copy()
    hot[1] = np.uint64(2**64 - 1)
    n = len(hot)
    runner = port_epoch.MeshEpochSweeps(virtual_mesh(n_dev, "cpu"))
    got = runner.fused(hot, eff, np.full(n, 7, np.uint8), np.zeros(n, bool), np.ones(n, bool),
                       np.ones(n, bool), scores, bias=4, recovery_rate=16, leaking=False,
                       **EPOCH_KWARGS)
    assert got is None
    assert reference["epoch"][str(n_dev)]["wrapped"]
