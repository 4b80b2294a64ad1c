"""The port's sharded chain step and epoch sweep step (``parallel/step.py``)
against the reference's.

The reference's steps are ``shard_map`` programs over a virtual 4-device JAX
CPU mesh, which needs a fresh process: one subprocess
(``conftest.run_in_cpu_mesh``) computes every reference result of this file
once, on seeded numpy columns made the same way here. The port runs each
step on ``virtual_mesh(n, "cpu")`` for n in {1, 3, 4}: n shards of the host,
each through the shard kernels' plain versions (``ops/chain_step.py``).
Roots, totals and u64 columns must be equal exactly:

* the chain step through ``run_chain_step`` at 2^13 + 5 validators (the
  graft entry's unaligned count) and at 37, with u64 edge rows: balances
  within a threshold of 2^64 (the hysteresis compare wraps) and two active
  rows above 2^63 that keep their effective balance (the total wraps);
* the epoch sweep step on mainnet constants, leaking and not, and with u64
  edge rows: flag sums and the active total past 2^64, one flag sum that
  wraps to below one increment (where the step and the fused epoch kernel
  differ), the active total at 2^64 - 1 (``_isqrt``'s quirk near 2^64), and
  scores whose product with the effective balance passes 2^64: the checked
  step raises ``OverflowError``, the unchecked one wraps as the reference's.

The kernels' arithmetic (``csrc/chain_step_core.h``, and K2's lane in
``csrc/masked_sums.h``) is built with g++ and held against the same
reference outputs.
"""

import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import run_in_cpu_mesh
from ethereum_consensus_tpu.parallel import step as ref_step
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.ops import chain_step as port_ops
from ethereum_consensus_tpu_torch.ops import epoch as ops_epoch
from ethereum_consensus_tpu_torch.ops.merkle import zero_hash_words
from ethereum_consensus_tpu_torch.parallel import make_chain_step, virtual_mesh
from ethereum_consensus_tpu_torch.parallel import step as port_step
from ethereum_consensus_tpu_torch.ssz import List, uint64
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CSRC = Path(port_ops.__file__).resolve().parents[1] / "csrc"
MESHES = (1, 3, 4)
CHAIN_SIZES = ((1 << 13) + 5, 37)
# label: (edge rows, leaking, checked)
EPOCH_CASES = {
    "plain": (False, False, True),
    "leaking": (False, True, True),
    "edges": (True, False, False),
    "edges_leaking": (True, True, False),
    "edges_checked": (True, False, True),
}

INPUTS = r"""
import numpy as np

M64 = (1 << 64) - 1
INC = 10**9
EPOCH_N = 12 * 684  # the shards' rows: divisible by 1, 3 and 4


def chain_columns(n, seed):
    rng = np.random.default_rng(seed)
    balances = rng.integers(16 * INC, 40 * INC, size=n, dtype=np.uint64)
    eff = rng.integers(0, 33, size=n, dtype=np.uint64) * np.uint64(INC)
    active = rng.random(n) < 0.9
    balances[3] = np.uint64(M64 - INC // 8)
    balances[5] = np.uint64(M64)
    eff[3] = np.uint64(32 * INC)
    for i in (7, 11):
        eff[i] = balances[i] = np.uint64(2**63 + 12345 * i)
        active[i] = True
    return balances, eff, active


def _masked_sum(eff, mask):
    return sum(int(v) for v in eff[mask]) & M64


def epoch_columns(edges):
    rng = np.random.default_rng(21)
    n = EPOCH_N
    eff = rng.integers(0, 33, n, dtype=np.uint64) * np.uint64(INC)
    balances = eff + rng.integers(0, INC, n, dtype=np.uint64)
    part = rng.integers(0, 8, n, dtype=np.uint8)
    slashed = rng.random(n) < 0.05
    active_prev = rng.random(n) < 0.9
    active_cur = active_prev & (rng.random(n) < 0.98)
    eligible = active_prev | (rng.random(n) < 0.02)
    scores = rng.integers(0, 50, n, dtype=np.uint64)
    balances[:4] = [M64, M64 - 5, 0, 1]
    if edges:
        for i in range(8, 16):
            eff[i] = np.uint64(2**63 + i)
            part[i] = 7
            slashed[i] = False
            active_prev[i] = active_cur[i] = eligible[i] = True
        scores[20:24] = [2**40, 2**63, M64, 2**33]
        # flag 0's sum wraps to 5, below one increment (row 30: flag 0
        # only), and the active total to 2^64 - 1 (row 31: active now only)
        part[30], slashed[30], eligible[30] = 1, False, True
        active_prev[30], active_cur[30] = True, False
        part[31], active_prev[31], active_cur[31] = 0, False, True
        eff[30] = eff[31] = 0
        unslashed = active_prev & ~slashed
        eff[30] = np.uint64((5 - _masked_sum(eff, unslashed & (part & 1).astype(bool))) & M64)
        eff[31] = np.uint64((M64 - _masked_sum(eff, active_cur)) & M64)
    return balances, eff, part, slashed, active_prev, active_cur, eligible, scores
"""
exec(INPUTS)  # chain_columns, epoch_columns, M64, INC  # noqa: S102

REFERENCE = INPUTS + r"""
import json
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from ethereum_consensus_tpu.config import Context
from ethereum_consensus_tpu.ops.merkle import zero_hash_words
from ethereum_consensus_tpu.parallel import chip_mesh, make_chain_step
from ethereum_consensus_tpu.parallel.step import (
    make_epoch_sweep_step, run_chain_step, u64_to_be_words)

mesh = chip_mesh(4)
out = {"chain": {}, "epoch": {}}
step = make_chain_step(mesh)
zero = jnp.asarray(zero_hash_words())
for n in CHAIN_SIZES:
    bal, eff, act = chain_columns(n, n)
    new_eff, total, root = run_chain_step(step, mesh, bal, eff, act, zero)
    out["chain"][str(n)] = {
        "new_eff": [int(v) for v in np.asarray(new_eff)], "total": int(total),
        "root": np.asarray(root).astype(">u4").tobytes().hex(),
        "words": np.asarray(u64_to_be_words(jnp.asarray(bal))).astype(np.uint32).tolist()}
ctx = Context.for_mainnet()
for label, (edges, leaking, checked) in EPOCH_CASES.items():
    sweep = make_epoch_sweep_step(mesh, ctx, is_leaking=leaking, check_score_bound=checked)
    try:
        nb, ns, total = sweep(*(jnp.asarray(c) for c in epoch_columns(edges)))
    except OverflowError:
        out["epoch"][label] = "overflow"
        continue
    out["epoch"][label] = {"balances": [int(v) for v in np.asarray(nb)],
                           "scores": [int(v) for v in np.asarray(ns)], "total": int(total)}
print("REFERENCE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    code = f"CHAIN_SIZES = {CHAIN_SIZES!r}\nEPOCH_CASES = {EPOCH_CASES!r}\n" + REFERENCE
    out = run_in_cpu_mesh(code, n_devices=4)
    line = next(x for x in out.splitlines() if x.startswith("REFERENCE "))
    return json.loads(line[len("REFERENCE "):])


def _u64(values) -> np.ndarray:
    return np.asarray(values, dtype=np.uint64)


# ---------------------------------------------------------------------------
# the chain step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", CHAIN_SIZES)
@pytest.mark.parametrize("n_dev", MESHES)
def test_chain_step_matches_reference(reference, n_dev, n):
    bal, eff, act = chain_columns(n, n)
    mesh = virtual_mesh(n_dev, "cpu")
    new_eff, total, root = port_step.run_chain_step(make_chain_step(mesh), mesh, bal, eff, act,
                                                    zero_hash_words("cpu"))
    want = reference["chain"][str(n)]
    assert np.array_equal(new_eff, _u64(want["new_eff"]))
    assert total == want["total"]
    assert root.dtype == np.uint32 and root.astype(">u4").tobytes().hex() == want["root"]
    assert root.astype(">u4").tobytes() == List[uint64, 2**40].hash_tree_root(
        [int(b) for b in bal])
    # the edge rows: a wrapped threshold compare, and a total past 2^64
    assert new_eff[3] == 32 * INC and total < sum(int(e) for e, a in zip(new_eff, act) if a)


@pytest.mark.parametrize("n", CHAIN_SIZES)
def test_u64_to_be_words_matches_reference(reference, n):
    bal, _, _ = chain_columns(n, n)
    words = port_step.u64_to_be_words(torch.from_numpy(bal.view(np.int64)))
    assert words.numpy().view(np.uint32).tolist() == reference["chain"][str(n)]["words"]


def test_pad_registry_for_mesh_matches_reference():
    for n in (1, 4, 37, (1 << 13) + 5, 1 << 20):
        for n_dev in MESHES:
            assert port_step.pad_registry_for_mesh(n, n_dev) == \
                ref_step.pad_registry_for_mesh(n, n_dev)
    assert port_step._length_words(1029).tolist() == ref_step._length_words(1029).tolist()


def test_chain_step_rejects_unaligned_shards():
    zero = zero_hash_words("cpu")
    length = port_step._length_words(24)
    cols = (np.zeros(24, np.uint64), np.zeros(24, np.uint64), np.ones(24, bool))
    with pytest.raises(ValueError, match="not divisible"):
        make_chain_step(virtual_mesh(5, "cpu"))(*cols, zero, length)
    with pytest.raises(ValueError, match="multiple of 4"):
        make_chain_step(virtual_mesh(4, "cpu"))(*cols, zero, length)
    with pytest.raises(ValueError, match="power of two"):
        make_chain_step(virtual_mesh(2, "cpu"))(*cols, zero, length)


def test_step_factories_are_cached():
    mesh = virtual_mesh(2, "cpu")
    assert make_chain_step(mesh) is make_chain_step(virtual_mesh(2, "cpu"))
    ctx = Context.for_mainnet()
    assert port_step.make_epoch_sweep_step(mesh, ctx) is port_step.make_epoch_sweep_step(mesh, ctx)


# ---------------------------------------------------------------------------
# the epoch sweep step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", EPOCH_CASES)
@pytest.mark.parametrize("n_dev", MESHES)
def test_epoch_step_matches_reference(reference, n_dev, label):
    edges, leaking, checked = EPOCH_CASES[label]
    sweep = port_step.make_epoch_sweep_step(virtual_mesh(n_dev, "cpu"), Context.for_mainnet(),
                                            is_leaking=leaking, check_score_bound=checked)
    want = reference["epoch"][label]
    if want == "overflow":
        with pytest.raises(OverflowError):
            sweep(*epoch_columns(edges))
        return
    new_balances, new_scores, total = sweep(*epoch_columns(edges))
    assert np.array_equal(new_balances.numpy().view(np.uint64), _u64(want["balances"]))
    assert np.array_equal(new_scores.numpy().view(np.uint64), _u64(want["scores"]))
    assert total == want["total"]
    if edges:
        assert total == M64  # the active total at 2^64 - 1: isqrt's quirk


def test_edge_rows_part_the_step_from_the_fused_kernel():
    """Flag 0's sum wraps below one increment: the step's increments are 0,
    the fused epoch kernel's 1 (it floors the sum at one increment), so
    B3's element pass on the step's scalars gives other balances."""
    balances, eff, part, slashed, active_prev, active_cur, eligible, scores = (
        torch.from_numpy(np.ascontiguousarray(c).view(np.int64) if c.dtype == np.uint64
                         else np.ascontiguousarray(c))
        for c in epoch_columns(True))
    sums = port_ops.epoch_step_sums(eff, part, slashed, active_prev, active_cur).tolist()
    assert sums[0] == 5 and sums[3] == -1
    s = port_ops.epoch_step_scalars(sums, INC, 64, 4, 16, 3 * 2**24)
    assert s["increments"][0] == 0 and s["total_active"] == M64
    columns = (balances, eff, part, slashed, active_prev, eligible, scores)
    step_balances, step_scores = port_ops.epoch_step_apply(
        *columns, sums, INC, 64, 4, 16, 3 * 2**24, (14, 26, 14), 64, False, 2, 1)
    fused_scores, fused_balances, _ = ops_epoch.fused_epoch_apply(
        *columns, sums[:3], INC, s["brpi"], s["active_increments"], s["denominator"], 4, 16,
        (14, 26, 14), 64, False, 2, 1)
    assert torch.equal(fused_scores, step_scores)
    assert int((fused_balances != step_balances).sum()) == 8


# ---------------------------------------------------------------------------
# the kernels' arithmetic, built with g++
# ---------------------------------------------------------------------------

_HOST_SHIM = r"""
#include <stdint.h>
#include "chain_step_core.h"
#include "masked_sums.h"

extern "C" uint64_t chain_host(const uint64_t* balances, const uint64_t* effective,
                               const bool* active, int64_t n, uint64_t increment,
                               uint64_t max_effective, uint64_t down, uint64_t up,
                               uint64_t* new_effective, uint32_t* words) {
  const chain_step_core::Hysteresis h{increment, max_effective, down, up};
  const int64_t chunks = n / 4;
  uint64_t total = 0;
  for (int64_t c = 0; c < chunks; ++c) {
    uint32_t w[8];
    total += chain_step_core::chunk_lane(h, balances + 4 * c, effective + 4 * c, active + 4 * c,
                                         new_effective + 4 * c, w);
    for (int r = 0; r < 8; ++r) words[r * chunks + c] = w[r];
  }
  return total;
}

// The epoch step over whole columns: the four sums, the scalars
// (epoch_step_scalars on consts: increment, base reward factor, bias,
// recovery rate, inactivity quotient, three weights, weight denominator),
// then the element pass with the divisions as written (form 0) or on the
// reciprocals the launcher makes (form 1, K3's lane). increments receives
// the step's unslashed increments, floored the fused kernel's
// (floored_increments) for the same sums.
extern "C" void epoch_host(int form, const uint64_t* balances, const uint64_t* eff,
                           const uint8_t* part, const bool* slashed, const bool* active_prev,
                           const bool* active_cur, const bool* eligible,
                           const uint64_t* scores, int64_t n, const uint64_t* consts,
                           int leaking, uint64_t* out_scores, uint64_t* out_balances,
                           uint64_t* total_active, uint64_t* increments, uint64_t* floored) {
  uint64_t sums[4] = {0, 0, 0, 0};
  for (int64_t i = 0; i < n; ++i) {
    masked_sums::lane<4>(eff[i], part[i], slashed[i], active_prev[i], active_cur[i], sums);
  }
  const chain_step_core::EpochConstants c{
      consts[0], consts[1], consts[2], consts[3], consts[4], {consts[5], consts[6], consts[7]},
      consts[8], leaking != 0, 2, 1};
  const altair_core::FusedScalars s = chain_step_core::epoch_step_scalars(c, sums, total_active);
  const altair_core::FusedSweep sweep = altair_core::fused_sweep(s);
  for (int f = 0; f < 3; ++f) {
    increments[f] = sweep.unslashed_increments[f];
    floored[f] = altair_core::floored_increments(sweep, sums[f]);
  }
  for (int64_t i = 0; i < n; ++i) {
    if (form == 0) {
      altair_core::fused_epoch_lane(s, balances[i], eff[i], part[i], slashed[i], active_prev[i],
                                    eligible[i], scores[i], &out_scores[i], &out_balances[i]);
    } else {
      altair_core::fused_epoch_lane(sweep, balances[i], eff[i], part[i], slashed[i],
                                    active_prev[i], eligible[i], scores[i], &out_scores[i],
                                    &out_balances[i]);
    }
  }
}
"""

_P, _I64, _U64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("chain_step_core")
    shim = tmp / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    lib_path = tmp / "libchain_step_core.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
         f"-I{CSRC}", str(shim), "-o", str(lib_path)],
        check=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.chain_host.argtypes = [_P, _P, _P, _I64] + [_U64] * 4 + [_P, _P]
    lib.chain_host.restype = _U64
    lib.epoch_host.argtypes = [ctypes.c_int] + [_P] * 8 + [_I64, _P, ctypes.c_int] + [_P] * 5
    lib.epoch_host.restype = None
    return lib


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


@pytest.mark.parametrize("n", CHAIN_SIZES)
def test_header_chain_lane_matches_reference(reference, core, n):
    bal, eff, act = (np.ascontiguousarray(c) for c in chain_columns(n, n))
    padded = port_step.pad_registry_for_mesh(n, 4)
    cols = [np.zeros(padded, c.dtype) for c in (bal, eff, act)]
    for col, c in zip(cols, (bal, eff, act)):
        col[:n] = c
    new_eff = np.zeros(padded, np.uint64)
    words = np.zeros((8, padded // 4), np.uint32)
    total = core.chain_host(*(_ptr(c) for c in cols), padded, INC, 32 * INC, INC // 4,
                            5 * INC // 4, _ptr(new_eff), _ptr(words))
    want = reference["chain"][str(n)]
    assert np.array_equal(new_eff[:n], _u64(want["new_eff"])) and total == want["total"]
    assert words.T.reshape(-1)[:2 * n].tolist() == want["words"]


MAINNET_CONSTS = (INC, 64, 4, 16, 3 * 2**24, 14, 26, 14, 64)
STEP_FORMS = {"divided": 0, "reciprocals": 1}


def _run_epoch_host(core, form: int, cols: list, consts: tuple, leaking: bool) -> dict:
    n = len(cols[0])
    out_scores, out_balances = np.zeros(n, np.uint64), np.zeros(n, np.uint64)
    total, increments, floored = np.zeros(1, np.uint64), np.zeros(3, np.uint64), np.zeros(3,
                                                                                          np.uint64)
    consts_arr = _u64(consts)
    core.epoch_host(form, *(_ptr(c) for c in cols), n, _ptr(consts_arr), int(leaking),
                    _ptr(out_scores), _ptr(out_balances), _ptr(total), _ptr(increments),
                    _ptr(floored))
    return {"scores": out_scores, "balances": out_balances, "total": int(total[0]),
            "increments": increments.tolist(), "floored": floored.tolist()}


@pytest.mark.parametrize("form", STEP_FORMS)
@pytest.mark.parametrize("label", [k for k, v in EPOCH_CASES.items() if v[2] is False or
                                   not v[0]])
def test_header_epoch_lanes_match_reference(reference, core, label, form):
    """K3's scalars and lane (the divisions as written, and on the
    reciprocals K3's launcher makes) against the reference's step."""
    edges, leaking, _ = EPOCH_CASES[label]
    cols = [np.ascontiguousarray(c) for c in epoch_columns(edges)]
    got = _run_epoch_host(core, STEP_FORMS[form], cols, MAINNET_CONSTS, leaking)
    want = reference["epoch"][label]
    assert np.array_equal(got["balances"], _u64(want["balances"]))
    assert np.array_equal(got["scores"], _u64(want["scores"]))
    assert got["total"] == want["total"]


def test_header_step_and_fused_increments_part_below_one_increment(core):
    """The edge rows' flag 0 sum wraps to 5, below one increment: the step's
    scalars (K3's, no floor) give 0 increments, the fused kernel's floor
    (floored_increments) 1; at or above one increment they agree."""
    cols = [np.ascontiguousarray(c) for c in epoch_columns(True)]
    got = _run_epoch_host(core, 1, cols, MAINNET_CONSTS, False)
    assert got["increments"][0] == 0 and got["floored"][0] == 1
    assert got["increments"][1:] == got["floored"][1:] and min(got["increments"][1:]) > 0


# The step's constants (increment, base reward factor, bias, recovery rate,
# inactivity quotient, three weights, weight denominator) with its divisors
# (the increment, the reward divisor, the weight denominator, bias x
# quotient) at 1, at powers of two and above 2^63.
STEP_EDGE_CONSTS = {
    "divisors_one": (1, 64, 1, 16, 1, 14, 26, 14, 1),
    "powers_of_two": (1 << 30, 64, 4, 16, 1 << 24, 14, 26, 14, 64),
    "above_2_63": ((1 << 63) + 9, 1 << 20, 3, 16, (1 << 62) + 1, 14, 26, 14, 3),
}


@pytest.mark.parametrize("consts", STEP_EDGE_CONSTS)
def test_header_epoch_lane_on_reciprocals_matches_plain_on_edge_divisors(core, consts):
    """K3's lane on reciprocals against the lane with the divisions as
    written and the plain version (ops/chain_step.py), both leak states,
    on the edge rows (flag sums past 2^64 and below one increment, products
    past 2^64)."""
    words = STEP_EDGE_CONSTS[consts]
    cols = [np.ascontiguousarray(c) for c in epoch_columns(True)]
    tensors = [torch.from_numpy(c.view(np.int64) if c.dtype == np.uint64 else c) for c in cols]
    sums = port_ops.epoch_step_sums_plain(*tensors[1:6]).tolist()
    for leaking in (False, True):
        got = _run_epoch_host(core, 1, cols, words, leaking)
        divided = _run_epoch_host(core, 0, cols, words, leaking)
        plain_balances, plain_scores = port_ops.epoch_step_apply_plain(
            *tensors[:5], tensors[6], tensors[7], sums, *words[:5], words[5:8], words[8],
            leaking, 2, 1)
        for key, plain in (("balances", plain_balances), ("scores", plain_scores)):
            assert np.array_equal(got[key], divided[key]), (key, leaking)
            assert np.array_equal(got[key], plain.numpy().view(np.uint64)), (key, leaking)
