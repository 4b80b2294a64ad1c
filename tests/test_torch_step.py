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
reference outputs; so is K1's schedule (``chain_step_core::chain_step_host``:
block by block, thread by thread, step by step, then the finish in block
order), at n in {0, 4, 8, 12, 4100, 65540}, on the launcher's grid and on
grids smaller than the work, on columns offset by 1 to 7 rows (the
one-a-thread path), and on edge rows (balances at 0, at each threshold and
one either side, at 2^63 and 2^64 - 1) at increments 1, 2, 2^32, 2^63, 10^9
and 2^64 - 1, the hysteresis remainder on the increment's reciprocal; and
the reciprocal hysteresis form against the divided one on seeded rows.
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
# K1's schedule: one shard's rows (a multiple of 4)
SCHEDULE_SIZES = (0, 4, 8, 12, 4100, 65540)
# increment -> the cap of the edge rows' chain step (hysteresis quotient 4,
# multipliers 1 and 5)
EDGE_INCREMENTS = {1: 32, 2: 64, 2**32: 2**37, 2**63: M64, INC: 32 * INC, M64: M64}


def schedule_columns(n):
    # chain_columns' rows, edge rows included where n reaches them
    return tuple(c[:n] for c in chain_columns(max(n, 12), 100 + n))


def thresholds(increment):
    quarter = increment // 4
    return quarter, quarter * 5 & M64


def edge_chain_columns(increment):
    # balances at 0, 2^63, 2^64 - 1 and at each threshold of a few
    # effective balances and one either side (the compares wrap near 2^64)
    down, up = thresholds(increment)
    cap = EDGE_INCREMENTS[increment]
    rows = []
    for e in (0, increment, 3 * increment & M64, cap, 2**63, M64):
        for b in (0, 2**63, M64, e - down - 1, e - down, e - down + 1, e + up - 1, e + up,
                  e + up + 1):
            rows.append((b & M64, e))
    rows += [(M64, M64)] * (-len(rows) % 4)
    balances = np.array([b for b, _ in rows], dtype=np.uint64)
    eff = np.array([e for _, e in rows], dtype=np.uint64)
    active = np.arange(len(rows)) % 3 != 1
    return balances, eff, active


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
exec(INPUTS)  # chain_columns, epoch_columns, edge_chain_columns, M64, INC, ...  # noqa: S102

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
out["schedule"] = {}
for n in SCHEDULE_SIZES:
    bal, eff, act = schedule_columns(n)
    new_eff, total, _ = run_chain_step(step, mesh, bal, eff, act, zero)
    out["schedule"][str(n)] = {
        "new_eff": [int(v) for v in np.asarray(new_eff)], "total": int(total),
        "words": np.asarray(u64_to_be_words(jnp.asarray(bal))).astype(np.uint32).tolist()}
out["edges"] = {}
for increment, cap in EDGE_INCREMENTS.items():
    edge_step = make_chain_step(mesh, effective_balance_increment=increment,
                                max_effective_balance=cap)
    bal, eff, act = edge_chain_columns(increment)
    new_eff, total, _ = run_chain_step(edge_step, mesh, bal, eff, act, zero)
    out["edges"][str(increment)] = {"new_eff": [int(v) for v in np.asarray(new_eff)],
                                    "total": int(total)}
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
  const chain_step_core::Hysteresis h =
      chain_step_core::hysteresis(increment, max_effective, down, up);
  const int64_t chunks = n / 4;
  uint64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t lo, hi;
    total += chain_step_core::validator_lane(h, balances[i], effective[i], active[i],
                                             &new_effective[i], &lo, &hi);
    words[2 * (i % 4) * chunks + i / 4] = lo;
    words[(2 * (i % 4) + 1) * chunks + i / 4] = hi;
  }
  return total;
}

// K1's schedule on the columns as they lie in memory (the launcher's
// alignment test picks the path): on `grid` blocks, or (0) the launcher's
// grid. shape receives the grid and the whole warp chunks; visits counts
// each validator's visits. Returns the total.
extern "C" uint64_t chain_schedule_host(const uint64_t* balances, const uint64_t* effective,
                                        const uint8_t* active, int64_t n, uint64_t increment,
                                        uint64_t max_effective, uint64_t down, uint64_t up,
                                        int64_t grid, uint64_t* new_effective, uint32_t* words,
                                        uint8_t* visits, int64_t* shape) {
  const chain_step_core::ChainColumns c =
      chain_step_core::chain_columns(balances, effective, active, n, new_effective, words);
  if (grid == 0) grid = altair_core::chunk_grid(n);
  shape[0] = grid;
  shape[1] = c.chunks;
  return chain_step_core::chain_step_host(
      c, chain_step_core::hysteresis(increment, max_effective, down, up), grid, visits);
}

// The hysteresis update in its two forms over (n,) rows: the divided
// remainder (sweeps.cu) into divided, on the increment's reciprocal
// (chain_step.cu) into reciprocal.
extern "C" void hysteresis_forms_host(const uint64_t* balances, const uint64_t* effective,
                                      int64_t n, uint64_t increment, uint64_t max_effective,
                                      uint64_t down, uint64_t up, uint64_t* divided,
                                      uint64_t* reciprocal) {
  const udiv64_core::UDiv64 by_increment = udiv64_core::prepare(increment);
  for (int64_t i = 0; i < n; ++i) {
    divided[i] = sweeps_core::effective_balance_update(balances[i], effective[i], increment,
                                                       max_effective, down, up);
    reciprocal[i] = sweeps_core::effective_balance_update(
        balances[i], effective[i], increment, by_increment, max_effective, down, up);
  }
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
    lib.chain_schedule_host.argtypes = [_P, _P, _P, _I64] + [_U64] * 4 + [_I64] + [_P] * 4
    lib.chain_schedule_host.restype = _U64
    lib.hysteresis_forms_host.argtypes = [_P, _P, _I64] + [_U64] * 4 + [_P, _P]
    lib.hysteresis_forms_host.restype = None
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
    total = core.chain_host(*(_ptr(c) for c in cols), padded, *MAINNET_HYSTERESIS,
                            _ptr(new_eff), _ptr(words))
    want = reference["chain"][str(n)]
    assert np.array_equal(new_eff[:n], _u64(want["new_eff"])) and total == want["total"]
    assert words.T.reshape(-1)[:2 * n].tolist() == want["words"]


def _placed(cols, offset: int) -> list:
    """Copies of the columns starting `offset` rows past a 64-byte boundary
    (the arrays keep their buffers alive)."""
    out = []
    for c in cols:
        raw = np.zeros((len(c) + offset) * c.itemsize + 64, np.uint8)
        start = (-raw.ctypes.data) % 64 + offset * c.itemsize
        placed = raw[start:start + len(c) * c.itemsize].view(c.dtype)
        placed[:] = c
        out.append(placed)
    return out


def _run_schedule(core, cols, hysteresis: tuple, grid: int = 0) -> dict:
    bal, eff, act = cols
    n = len(bal)
    new_eff = np.zeros(n, np.uint64)
    words = np.zeros((8, n // 4), np.uint32)
    visits = np.zeros(max(n, 1), np.uint8)
    shape = np.zeros(2, np.int64)
    total = core.chain_schedule_host(_ptr(bal), _ptr(eff), _ptr(act.view(np.uint8)), n,
                                     *hysteresis, grid, _ptr(new_eff), _ptr(words),
                                     _ptr(visits), _ptr(shape))
    return {"new_eff": new_eff, "words": words, "total": int(total), "visits": visits[:n],
            "grid": int(shape[0]), "chunks": int(shape[1])}


def _hysteresis(increment: int, cap: int) -> tuple:
    return (increment, cap, *thresholds(increment))


MAINNET_HYSTERESIS = _hysteresis(INC, 32 * INC)


# grid 0: the launcher's; 1 and 3: fewer blocks than the work wants
@pytest.mark.parametrize("grid", [0, 1, 3])
@pytest.mark.parametrize("n", SCHEDULE_SIZES)
def test_header_chain_schedule_matches_reference(reference, core, n, grid):
    """K1's partition run on the host (whole warp chunks, then one a
    thread) against the reference's chain step: new effective balances, the
    (8, n/4) words and the total, every validator visited once."""
    cols = _placed(schedule_columns(n), 0)
    got = _run_schedule(core, cols, MAINNET_HYSTERESIS, grid)
    want = reference["schedule"][str(n)]
    assert got["chunks"] == n // 256
    assert np.array_equal(got["new_eff"], _u64(want["new_eff"])) and got["total"] == want["total"]
    assert got["words"].T.reshape(-1).tolist() == want["words"]
    assert np.all(got["visits"] == 1)


@pytest.mark.parametrize("offset", range(1, 8))
def test_header_chain_schedule_offset_columns(reference, core, offset):
    """Columns offset by 1..7 rows: the word columns 16-byte aligned and
    the flags 2-byte aligned only at even offsets, so the validators go one
    a thread at odd offsets, on the launcher's grid and on one block."""
    n = 65540
    cols = _placed(schedule_columns(n), offset)
    want = reference["schedule"][str(n)]
    for grid in (0, 1):
        got = _run_schedule(core, cols, MAINNET_HYSTERESIS, grid)
        assert got["chunks"] == (n // 256 if offset % 2 == 0 else 0)
        assert np.array_equal(got["new_eff"], _u64(want["new_eff"]))
        assert got["total"] == want["total"] and np.all(got["visits"] == 1)
        assert got["words"].T.reshape(-1).tolist() == want["words"]


@pytest.mark.parametrize("increment", EDGE_INCREMENTS)
def test_header_chain_schedule_on_edge_increments(reference, core, increment):
    """Balances at 0, at each threshold and one either side, at 2^63 and
    2^64 - 1, at increments whose reciprocals take each of the division's
    paths (1, powers of two, 10^9, 2^64 - 1), against the reference's chain
    step at the same constants."""
    cols = _placed(edge_chain_columns(increment), 0)
    want = reference["edges"][str(increment)]
    for grid in (0, 1):
        got = _run_schedule(core, cols, _hysteresis(increment, EDGE_INCREMENTS[increment]), grid)
        assert np.array_equal(got["new_eff"], _u64(want["new_eff"]))
        assert got["total"] == want["total"]
    moved = _u64(want["new_eff"]) != cols[1]
    assert moved.any() and not moved.all()


def test_header_chain_grid(core):
    """The launcher's grid: a warp chunk a warp (512 blocks at 2^20, one
    wave at 4 blocks an SM; 128 at 2^18; 1,025 at 2^21 + 4), the same off
    the vector path, one block for no validators."""
    def grid(n, offset=0):
        cols = _placed((np.zeros(n, np.uint64), np.zeros(n, np.uint64), np.zeros(n, bool)),
                       offset)
        return _run_schedule(core, cols, MAINNET_HYSTERESIS)
    assert grid(1 << 20)["grid"] == 512 and grid(1 << 18)["grid"] == 128
    assert grid((1 << 21) + 4)["grid"] == 1025
    unaligned = grid(1 << 20, offset=1)
    assert unaligned["grid"] == 512 and unaligned["chunks"] == 0
    assert grid(0)["grid"] == 1


# increments: each edge increment, and seeded ones over the whole u64 range
HYSTERESIS_FORM_INCREMENTS = (*EDGE_INCREMENTS, 3, 10**9 + 7, 2**63 + 1, 12345678901234567)


@pytest.mark.parametrize("increment", HYSTERESIS_FORM_INCREMENTS)
def test_header_hysteresis_reciprocal_form_matches_divided(core, increment):
    """sweeps_core.h's update on the increment's reciprocal (K1's) against
    the divided form (B5-hysteresis's) on seeded rows over the whole u64
    range, balances near multiples of the increment among them."""
    rng = np.random.default_rng(increment % 2**32)
    n = 1 << 14
    balances = rng.integers(0, M64, n, dtype=np.uint64, endpoint=True)
    multiples = rng.integers(0, M64 // increment + 1, n, dtype=np.uint64) * np.uint64(increment)
    near = multiples + rng.integers(-2, 3, n).astype(np.uint64)
    balances = np.where(rng.random(n) < 0.5, balances, near)
    eff = np.where(rng.random(n) < 0.5, rng.integers(0, M64, n, dtype=np.uint64, endpoint=True),
                   balances + rng.integers(-3, 3, n).astype(np.uint64) * np.uint64(increment))
    divided, reciprocal = np.zeros(n, np.uint64), np.zeros(n, np.uint64)
    cap = int(rng.integers(0, M64, dtype=np.uint64, endpoint=True))
    core.hysteresis_forms_host(_ptr(balances), _ptr(eff), n, increment, cap,
                               *thresholds(increment), _ptr(divided), _ptr(reciprocal))
    assert np.array_equal(divided, reciprocal)
    assert (divided != eff).any()


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
