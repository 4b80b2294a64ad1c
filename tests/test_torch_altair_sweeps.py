"""The port's altair sweeps and fused epoch kernel against the reference.

The plain versions of the three altair sweep kernels (flag deltas,
inactivity updates, inactivity penalties) are held against the reference's
device programs run on the CPU (``ethereum_consensus_tpu.ops.sweeps``), on
seeded numpy columns whose products reach [2^63, 2^64) and wrap past 2^64;
``isqrt_u64`` against the reference's ``_isqrt_u64`` on its edge cases; the
fused epoch kernel's plain version against the reference's
``fused_epoch_kernel`` under numpy and its jitted twin. Exact: the results
are integers. The kernels' shared header ``csrc/altair_core.h`` is built
here with g++ and held against the same reference outputs, the inactivity
penalties' schedule (``altair_core::inactivity_penalties_host``: block by
block, thread by thread, step by step, the warp chunks and the
one-a-thread path, the quotient on the denominator's reciprocal) among
them, at n in {0, 1, 2, 63, 64, 65, 4099, 65541}, on the launcher's grid and
on grids smaller than the work, on columns offset by 1 to 7 rows, and at
denominators 1, 2^26, 3 * 2^26 (altair's bias times quotient) and 2^64 - 1
with products that wrap; the inactivity updates' schedule
(``altair_core::inactivity_updates_host``) likewise at n in {0, 1, 255, 256,
257, 4099, 65541, 2^17}, leaking and not, with scores that wrap past 2^64;
the kernels themselves run only where a CUDA card is present.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ethereum_consensus_tpu.config import Context as RefContext
from ethereum_consensus_tpu.models import epoch_vector as ref_epoch_vector
from ethereum_consensus_tpu.ops import sweeps as ref_sweeps
from ethereum_consensus_tpu_torch.config import Context as PortContext
from ethereum_consensus_tpu_torch.ops import epoch as port_epoch
from ethereum_consensus_tpu_torch.ops import sweeps as port_sweeps
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CSRC = Path(port_sweeps.__file__).resolve().parents[1] / "csrc"
SIZES = [0, 1, 255, 257, 4099]
INC = 10**9
TOP = 1 << 64
WEIGHTS = (14, 26, 14)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _packed(n: int, seed: int, wide: bool) -> dict:
    """``pack_registry``-shaped columns: mixed flags, slashed and
    ineligible lanes, inactivity scores around zero and near 2^64, and
    (``wide``) effective balances across the whole u64 range, so that the
    flag-delta products pass 2^63 and wrap past 2^64."""
    rng = np.random.default_rng(seed)
    eff = rng.integers(0, 33, n, dtype=np.uint64) * np.uint64(INC)
    if wide:
        words = rng.integers(0, TOP, n, dtype=np.uint64, endpoint=False)
        eff = np.where(rng.integers(0, 3, n) == 0, words, eff)
    scores = rng.integers(0, 64, n, dtype=np.uint64)
    near_top = np.uint64(TOP - 1) - rng.integers(0, 8, n, dtype=np.uint64)
    scores = np.where(rng.integers(0, 16, n) == 0, near_top, scores)
    return {
        "effective_balance": eff,
        "inactivity_scores": scores,
        "previous_participation": rng.integers(0, 8, n, dtype=np.uint8),
        "slashed": rng.random(n) < 0.1,
        "active_previous": rng.random(n) < 0.9,
        "eligible": rng.random(n) < 0.9,
    }


def _u64(values) -> np.ndarray:
    return np.asarray(values, dtype=np.uint64)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("leaking", [False, True])
def test_flag_deltas_plain_matches_reference(n, leaking):
    for flag_index in range(3):
        packed = _packed(n, seed=n * 7 + flag_index, wide=True)
        # a small total keeps the base reward per increment large: the
        # reward products of the wide lanes pass 2^64
        total = 64 * INC + 12345
        want = ref_sweeps.flag_deltas_device(packed, flag_index, total, RefContext.for_mainnet(),
                                             leaking)
        got = port_sweeps.flag_deltas_device(packed, flag_index, total, PortContext.for_mainnet(),
                                             leaking, device="cpu")
        for g, w in zip(got, want):
            assert g.dtype == np.uint64 and np.array_equal(g, _u64(w)), (n, flag_index, leaking)
        if n >= 257 and not leaking and flag_index != 2:
            assert got[0].any() and got[1].any()


def test_flag_deltas_products_wrap_like_reference():
    """The plain version on tensors, with products at and above 2^63 and
    past 2^64, against the reference's XLA program."""
    rng = np.random.default_rng(3)
    n = 4099
    eff = rng.integers(1 << 62, TOP, n, dtype=np.uint64, endpoint=False)
    part = rng.random(n) < 0.5
    elig = rng.random(n) < 0.9
    total = INC
    got = port_sweeps.flag_deltas_plain(
        torch.from_numpy(eff.view(np.int64)), torch.from_numpy(part), torch.from_numpy(elig),
        total, 26, INC, 64, 64, False, False,
    )
    want = ref_sweeps._flag_deltas(
        jnp.asarray(eff), jnp.asarray(part), jnp.asarray(elig), jnp.uint64(total),
        jnp.uint64(26), flag_index=1, increment=INC, base_reward_factor=64,
        weight_denominator=64, is_leaking=False,
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint64), _u64(w))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("leaking", [False, True])
def test_inactivity_updates_plain_matches_reference(n, leaking):
    packed = _packed(n, seed=100 + n, wide=False)
    want = ref_sweeps.inactivity_updates_device(packed, RefContext.for_mainnet(), leaking)
    got = port_sweeps.inactivity_updates_device(packed, PortContext.for_mainnet(), leaking,
                                                device="cpu")
    assert got.dtype == np.uint64 and np.array_equal(got, _u64(want))
    if n >= 257:
        assert (got != packed["inactivity_scores"]).any()


@pytest.mark.parametrize("n", SIZES)
def test_inactivity_penalties_plain_matches_reference(n):
    """Products below 2^64 (some at or above 2^63) through the kernel's
    plain version, and, with one score past the guard, through the exact
    host path both packages keep."""
    ctx_ref, ctx_port = RefContext.for_mainnet(), PortContext.for_mainnet()
    quotient = int(ctx_ref.INACTIVITY_PENALTY_QUOTIENT_ALTAIR)
    packed = _packed(n, seed=200 + n, wide=False)
    rng = np.random.default_rng(n)
    packed["effective_balance"] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    packed["inactivity_scores"] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    if n:
        packed["effective_balance"][0] = packed["inactivity_scores"][0] = np.uint64((1 << 32) - 1)
    want = ref_sweeps.inactivity_penalties_device(packed, ctx_ref, quotient)
    got = port_sweeps.inactivity_penalties_device(packed, ctx_port, quotient, device="cpu")
    assert got.dtype == np.uint64 and np.array_equal(got, _u64(want))
    if n:
        packed["inactivity_scores"][-1] = np.uint64(1 << 40)  # max product past 2^64
        want = ref_sweeps.inactivity_penalties_device(packed, ctx_ref, quotient)
        got = port_sweeps.inactivity_penalties_device(packed, ctx_port, quotient, device="cpu")
        assert np.array_equal(got, _u64(want))


def test_inactivity_penalties_products_wrap_like_reference():
    rng = np.random.default_rng(9)
    n = 4099
    eff = rng.integers(0, TOP, n, dtype=np.uint64, endpoint=False)
    scores = rng.integers(0, TOP, n, dtype=np.uint64, endpoint=False)
    not_target = rng.random(n) < 0.8
    got = port_sweeps.inactivity_penalties_plain(
        torch.from_numpy(eff.view(np.int64)), torch.from_numpy(scores.view(np.int64)),
        torch.from_numpy(not_target), 4 * 50331648,
    )
    want = ref_sweeps._inactivity_penalties(
        jnp.asarray(eff), jnp.asarray(scores), jnp.asarray(not_target), bias=4,
        quotient=50331648,
    )
    assert np.array_equal(got.numpy().view(np.uint64), _u64(want))


def _isqrt_cases() -> list:
    cases = {0, 1, 2, 3, TOP - 1, TOP - 2, (1 << 63) - 1, 1 << 63}
    for k in range(64):
        cases.add(1 << k)
        cases.add((1 << k) - 1)
    for r in (2, 3, 1000, 31622, 10**6, (1 << 32) - 1, (1 << 31) + 7):
        for d in (-1, 0, 1):
            if 0 <= r * r + d < TOP:
                cases.add(r * r + d)
    for d in range(1, 40):
        cases.add(TOP - d)
        cases.add(((1 << 32) - 1) ** 2 + d)
    return sorted(cases)


def test_isqrt_matches_reference():
    cases = _isqrt_cases()
    want = _u64(ref_sweeps._isqrt_u64(jnp.asarray(_u64(cases))))
    got = [port_sweeps.isqrt_u64(x) for x in cases]
    assert got == [int(w) for w in want]


def test_isqrt_follows_the_reference_near_two_to_the_64():
    """The reference's last clamp squares g + 1 in u64, which wraps: at
    x = 2^64 - 1 it returns 2^32, one above the exact root. The port keeps
    that."""
    assert port_sweeps.isqrt_u64(TOP - 1) == 1 << 32
    assert int(ref_sweeps._isqrt_u64(jnp.uint64(TOP - 1))) == 1 << 32


def _fused_inputs(n: int, seed: int, wrap: bool = False) -> dict:
    """The reference's fused-kernel inputs (tests/test_epoch_vector.py:443),
    with low balances (a penalty that saturates before a later reward) and,
    for ``wrap``, balances near 2^64 whose adds wrap."""
    rng = np.random.default_rng(seed)
    balances = rng.integers(0, 1 << 45, n, dtype=np.uint64)
    balances = np.where(rng.integers(0, 8, n) == 0, rng.integers(0, 1 << 22, n,
                                                                 dtype=np.uint64), balances)
    if wrap:
        balances = np.where(rng.integers(0, 8, n) == 0,
                            np.uint64(TOP - 1) - rng.integers(0, 1 << 10, n, dtype=np.uint64),
                            balances)
    return dict(
        balances=balances,
        eff=rng.integers(1 << 30, 1 << 35, n, dtype=np.uint64),
        prev_part=rng.integers(0, 8, n, dtype=np.uint8),
        slashed=rng.random(n) < 0.05,
        active_prev=rng.random(n) < 0.95,
        eligible=rng.random(n) < 0.96,
        scores=rng.integers(0, 1 << 20, n, dtype=np.uint64),
    )


def _fused_scalars(k: dict) -> tuple:
    increment, brpi = INC, 907
    active_increments = max(1, int(k["eff"].sum()) // increment)
    denominator = 4 * (3 * 10**7)
    return increment, brpi, active_increments, denominator


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("leaking", [False, True])
@pytest.mark.parametrize("wrap", [False, True])
def test_fused_plain_matches_reference(n, leaking, wrap):
    k = _fused_inputs(n, seed=13 + n, wrap=wrap)
    increment, brpi, active_increments, denominator = _fused_scalars(k)
    columns = [k[c] for c in ("balances", "eff", "prev_part", "slashed", "active_prev",
                              "eligible", "scores")]
    want_scores, want_balances, want_wrapped = ref_epoch_vector.fused_epoch_kernel(
        np, *columns, np.uint64(increment), np.uint64(brpi), np.uint64(active_increments),
        np.uint64(denominator), 4, 16, WEIGHTS, 64, leaking, 2, 1,
    )
    got_scores, got_balances, got_wrapped = port_epoch.fused_epoch_device(
        *columns, increment, brpi, active_increments, denominator, 4, 16, WEIGHTS, 64,
        leaking, 2, 1, device="cpu",
    )
    assert np.array_equal(got_scores, want_scores)
    assert np.array_equal(got_balances, want_balances)
    assert got_wrapped == int(want_wrapped)
    if wrap and n >= 257 and not leaking:  # a leak pays no rewards, so nothing wraps
        assert got_wrapped > 0
    if n == 4099 and not wrap:
        jitted = ref_epoch_vector.jitted_kernels()["fused_epoch"]
        dev_scores, dev_balances, dev_wrapped = jitted(
            *(jnp.asarray(c) for c in columns), jnp.uint64(increment), jnp.uint64(brpi),
            jnp.uint64(active_increments), jnp.uint64(denominator), 4, 16, WEIGHTS, 64,
            leaking, 2, 1,
        )
        assert np.array_equal(got_scores, np.asarray(dev_scores))
        assert np.array_equal(got_balances, np.asarray(dev_balances))
        assert got_wrapped == int(dev_wrapped) == 0


@pytest.mark.parametrize("leaking", [False, True])
def test_staged_host_kernels_compose_to_the_fused_kernel(leaking):
    """The engine's staged numpy kernels (its host route), composed as the
    reference's test composes them, equal the fused kernel's plain version
    (its device route)."""
    from ethereum_consensus_tpu_torch.models import epoch_vector as port_epoch_vector

    k = _fused_inputs(4099, seed=17)
    increment, brpi, active_increments, denominator = _fused_scalars(k)
    n = k["balances"].shape[0]
    target = ((k["prev_part"] >> np.uint8(1)) & np.uint8(1)).astype(bool)
    participating = k["active_prev"] & ~k["slashed"] & target
    scores = port_epoch_vector.inactivity_scores_kernel(
        np, k["scores"], k["eligible"], participating, 4, 16, leaking)
    base_reward = (k["eff"] // np.uint64(increment)) * np.uint64(brpi)
    pairs = []
    for flag_index, weight in enumerate(WEIGHTS):
        bit = ((k["prev_part"] >> np.uint8(flag_index)) & np.uint8(1)).astype(bool)
        unslashed = k["active_prev"] & ~k["slashed"] & bit
        increments = max(increment, int(k["eff"][unslashed].sum())) // increment
        pairs.append(port_epoch_vector.flag_deltas_kernel(
            np, base_reward, k["eligible"], unslashed, weight, increments, active_increments,
            64, leaking, flag_index == 2))
    missed = k["eligible"] & ~participating
    pairs.append((np.zeros(n, dtype=np.uint64),
                  np.where(missed, k["eff"] * scores // np.uint64(denominator), np.uint64(0))))
    balances = port_epoch_vector.apply_delta_pairs_kernel(np, k["balances"], pairs)
    fused = port_epoch.fused_epoch_device(
        *(k[c] for c in ("balances", "eff", "prev_part", "slashed", "active_prev", "eligible",
                         "scores")),
        increment, brpi, active_increments, denominator, 4, 16, WEIGHTS, 64, leaking, 2, 1,
        device="cpu",
    )
    assert np.array_equal(fused[0], scores) and np.array_equal(fused[1], balances)


def test_wrappers_refuse_bad_inputs():
    words = torch.zeros(8, dtype=torch.int64)
    flags = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        port_sweeps.inactivity_updates(words, flags.to(torch.int64), flags, 4, 16, False)
    with pytest.raises(ValueError):
        port_sweeps.inactivity_penalties(words, words[:5], flags, 4)
    with pytest.raises(ValueError, match="denominator"):
        port_sweeps.inactivity_penalties(words, words, flags, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_sweeps.flag_deltas_cuda(words, flags, flags, 32 * INC, 26, INC, 64, 64, False, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_sweeps.inactivity_updates_cuda(words, flags, flags, 4, 16, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_sweeps.inactivity_penalties_cuda(words, words, flags, 4)
    part = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_epoch.fused_epoch_cuda(words, words, part, flags, flags, flags, words,
                                    INC, 907, 8, 4 * 3 * 10**7, 4, 16, WEIGHTS, 64, False, 2, 1)
    with pytest.raises(ValueError, match="nonzero"):
        port_epoch.fused_epoch(words, words, part, flags, flags, flags, words,
                               INC, 907, 0, 4, 4, 16, WEIGHTS, 64, False, 2, 1)


_HOST_SHIM = r"""
#include "altair_core.h"
#include "epoch_pass.h"
// The kernels' per-validator arithmetic over whole columns, on the host.
extern "C" uint64_t isqrt_host(uint64_t x) { return altair_core::isqrt_u64(x); }

extern "C" void flag_deltas_host(const uint64_t* eff, const bool* part, const bool* elig,
                                 int64_t n, uint64_t total_active, uint64_t weight,
                                 uint64_t increment, uint64_t factor, uint64_t wd,
                                 int leaking, int is_head, uint64_t* rewards,
                                 uint64_t* penalties) {
  uint64_t sum = 0;
  for (int64_t i = 0; i < n; ++i) sum += part[i] ? eff[i] : 0;
  const altair_core::FlagScalars s =
      altair_core::flag_scalars(total_active, sum, increment, factor, wd);
  for (int64_t i = 0; i < n; ++i) {
    altair_core::flag_delta(eff[i], part[i], elig[i], s, weight, increment, wd,
                            leaking != 0, is_head != 0, &rewards[i], &penalties[i]);
  }
}

// The kernel's lane in its two phases: the scalars and reciprocals made
// once (flag_sweep); the base rewards, the penalties and the masked sum; the
// increments from the sum by one multiply-high; the rewards.
extern "C" void flag_lanes_host(const uint64_t* eff, const bool* part, const bool* elig,
                                int64_t n, uint64_t total_active, uint64_t weight,
                                uint64_t increment, uint64_t factor, uint64_t wd,
                                int leaking, int is_head, uint64_t* rewards,
                                uint64_t* penalties) {
  const altair_core::FlagSweep s = altair_core::flag_sweep(total_active, increment, factor, wd);
  uint64_t sum = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t base = altair_core::flag_base_reward(eff[i], s);
    sum += part[i] ? eff[i] : 0;
    penalties[i] = altair_core::flag_penalty(base, part[i], elig[i], s, weight, is_head != 0);
  }
  const uint64_t increments = udiv64_core::divide(sum, s.increment);
  for (int64_t i = 0; i < n; ++i) {
    rewards[i] = altair_core::flag_reward(altair_core::flag_base_reward(eff[i], s), part[i],
                                          elig[i], s, increments, weight, leaking != 0);
  }
}

extern "C" void inactivity_updates_host(const uint64_t* scores, const bool* part,
                                        const bool* elig, int64_t n, uint64_t bias,
                                        uint64_t recovery, int leaking, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = altair_core::inactivity_update(scores[i], part[i], elig[i], bias, recovery,
                                            leaking != 0);
  }
}

extern "C" void inactivity_penalties_host(const uint64_t* eff, const uint64_t* scores,
                                          const bool* not_target, int64_t n,
                                          uint64_t denominator, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = altair_core::inactivity_penalty(eff[i], scores[i], not_target[i], denominator);
  }
}

// The inactivity penalties' kernel schedule on the columns as they lie in
// memory (the launcher's alignment test picks the path), the quotient on
// the denominator's reciprocal: on `grid` blocks, or (0) the launcher's
// grid. shape receives the grid and the whole warp chunks; visits counts
// each validator's visits.
extern "C" void penalties_schedule_host(const uint64_t* eff, const uint64_t* scores,
                                        const uint8_t* not_target, int64_t n,
                                        uint64_t denominator, int64_t grid, uint64_t* out,
                                        uint8_t* visits, int64_t* shape) {
  const altair_core::PenaltyColumns c =
      altair_core::penalty_columns(eff, scores, not_target, n, out);
  if (grid == 0) grid = altair_core::chunk_grid(n);
  shape[0] = grid;
  shape[1] = c.chunks;
  altair_core::inactivity_penalties_host(c, udiv64_core::prepare(denominator), grid, visits);
}

// The inactivity updates' kernel schedule on the columns as they lie in
// memory, as penalties_schedule_host, on the launcher's chunks
// (kUpdateSteps steps); shape gets the grid, the chunks and the steps.
extern "C" void updates_schedule_host(const uint64_t* scores, const uint8_t* part,
                                      const uint8_t* elig, int64_t n, uint64_t bias,
                                      uint64_t recovery, int leaking, int64_t grid, uint64_t* out,
                                      uint8_t* visits, int64_t* shape) {
  constexpr int kSteps = altair_core::kUpdateSteps;
  const altair_core::UpdateColumns c =
      altair_core::update_columns<kSteps>(scores, part, elig, n, out);
  if (grid == 0) grid = altair_core::chunk_grid<kSteps>(n);
  shape[0] = grid;
  shape[1] = c.chunks;
  shape[2] = kSteps;
  altair_core::inactivity_updates_host(c, bias, recovery, leaking != 0, grid, visits);
}

// The fused pass's scalars from ten words (increment, brpi, active
// increments, penalty denominator, bias, recovery rate, three weights,
// weight denominator) and the flags; the increments wait for the sums.
static altair_core::FusedScalars fused_scalars(const uint64_t* w, int leaking, int head,
                                               int target) {
  altair_core::FusedScalars s;
  s.increment = w[0];
  s.brpi = w[1];
  s.divisor = w[2] * w[9];
  s.denominator = w[3];
  s.bias = w[4];
  s.recovery_rate = w[5];
  for (int f = 0; f < 3; ++f) {
    s.weights[f] = w[6 + f];
    s.unslashed_increments[f] = 0;
  }
  s.weight_denominator = w[9];
  s.leaking = leaking != 0;
  s.head_flag_index = head;
  s.target_flag_index = target;
  return s;
}

// The fused pass over whole columns in one of three forms: 0, the lane with
// the divisions as written (fused_flag_increments, fused_epoch_lane on
// FusedScalars); 1, the lane on reciprocals (fused_sweep, floored_increments,
// fused_epoch_lane on FusedSweep); 2, the kernel's schedule
// (epoch_pass::fused_pass_host on the grid its launcher picks for `fit`
// co-resident blocks, the columns `vector` or not; visits counted). With
// `update` 0 (forms 0 and 1) the rewards lane alone off the given scores.
// sums receives the three flag sums; returns the wrap census.
extern "C" uint64_t fused_host(int form, const uint64_t* balances, const uint64_t* eff,
                               const uint8_t* part, const bool* slashed, const bool* active,
                               const bool* elig, const uint64_t* scores, int64_t n,
                               const uint64_t* words, int leaking, int head, int target,
                               int update, int64_t fit, int vector, uint64_t* out_scores,
                               uint64_t* out_balances, uint64_t* sums, uint8_t* visits) {
  altair_core::FusedScalars s = fused_scalars(words, leaking, head, target);
  if (form == 2) {
    const epoch_pass::Columns c{balances, eff, part,
                                reinterpret_cast<const uint8_t*>(slashed),
                                reinterpret_cast<const uint8_t*>(active),
                                reinterpret_cast<const uint8_t*>(elig), scores, n,
                                epoch_pass::chunk_count(n, vector != 0), out_scores,
                                out_balances};
    const int64_t grid = epoch_pass::fused_grid(n, fit, 2048);
    return epoch_pass::fused_pass_host(c, altair_core::fused_sweep(s), grid, sums, visits);
  }
  for (int f = 0; f < 3; ++f) sums[f] = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!active[i] || slashed[i]) continue;
    for (int f = 0; f < 3; ++f) sums[f] += ((part[i] >> f) & 1) ? eff[i] : 0;
  }
  altair_core::fused_flag_increments(&s, sums);
  const altair_core::FusedSweep sweep = altair_core::fused_sweep(s);
  uint64_t wrapped = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (update == 0) {
      out_scores[i] = scores[i];
      wrapped += form == 0 ? altair_core::rewards_lane(s, balances[i], eff[i], part[i],
                                                       slashed[i], active[i], elig[i],
                                                       scores[i], &out_balances[i])
                           : altair_core::rewards_lane(sweep, balances[i], eff[i], part[i],
                                                       slashed[i], active[i], elig[i],
                                                       scores[i], &out_balances[i]);
    } else {
      wrapped += form == 0 ? altair_core::fused_epoch_lane(s, balances[i], eff[i], part[i],
                                                           slashed[i], active[i], elig[i],
                                                           scores[i], &out_scores[i],
                                                           &out_balances[i])
                           : altair_core::fused_epoch_lane(sweep, balances[i], eff[i],
                                                           part[i], slashed[i], active[i],
                                                           elig[i], scores[i], &out_scores[i],
                                                           &out_balances[i]);
    }
  }
  return wrapped;
}
"""

_P, _I64, _U64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64


@pytest.fixture(scope="session")
def core(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("altair_core")
    shim = tmp / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    lib_path = tmp / "libaltair_core.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
         f"-I{CSRC}", str(shim), "-o", str(lib_path)],
        check=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.isqrt_host.argtypes, lib.isqrt_host.restype = [_U64], _U64
    lib.flag_deltas_host.argtypes = [_P, _P, _P, _I64] + [_U64] * 5 + [ctypes.c_int] * 2 + [_P, _P]
    lib.flag_deltas_host.restype = None
    lib.flag_lanes_host.argtypes = lib.flag_deltas_host.argtypes
    lib.flag_lanes_host.restype = None
    lib.inactivity_updates_host.argtypes = [_P, _P, _P, _I64, _U64, _U64, ctypes.c_int, _P]
    lib.inactivity_updates_host.restype = None
    lib.inactivity_penalties_host.argtypes = [_P, _P, _P, _I64, _U64, _P]
    lib.inactivity_penalties_host.restype = None
    lib.penalties_schedule_host.argtypes = [_P, _P, _P, _I64, _U64, _I64, _P, _P, _P]
    lib.penalties_schedule_host.restype = None
    lib.updates_schedule_host.argtypes = [_P, _P, _P, _I64, _U64, _U64, ctypes.c_int, _I64, _P,
                                          _P, _P]
    lib.updates_schedule_host.restype = None
    lib.fused_host.argtypes = ([ctypes.c_int] + [_P] * 7 + [_I64, _P] + [ctypes.c_int] * 4
                               + [_I64, ctypes.c_int] + [_P] * 4)
    lib.fused_host.restype = _U64
    return lib


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


def test_header_isqrt_matches_reference(core):
    cases = _isqrt_cases()
    want = _u64(ref_sweeps._isqrt_u64(jnp.asarray(_u64(cases))))
    assert [core.isqrt_host(x) for x in cases] == [int(w) for w in want]


@pytest.mark.parametrize("n", SIZES)
def test_header_sweeps_match_reference(core, n):
    ctx = RefContext.for_mainnet()
    for leaking in (False, True):
        packed = _packed(n, seed=300 + n, wide=True)
        eff = np.ascontiguousarray(packed["effective_balance"])
        elig = np.ascontiguousarray(packed["eligible"])
        for flag_index in range(3):
            part = np.ascontiguousarray(port_sweeps._participating(packed, flag_index))
            rewards, penalties = np.zeros(n, np.uint64), np.zeros(n, np.uint64)
            total = 64 * INC + 12345
            core.flag_deltas_host(_ptr(eff), _ptr(part), _ptr(elig), n, total,
                                  WEIGHTS[flag_index], INC, 64, 64, int(leaking),
                                  int(flag_index == 2), _ptr(rewards), _ptr(penalties))
            want = ref_sweeps.flag_deltas_device(packed, flag_index, total, ctx, leaking)
            assert np.array_equal(rewards, _u64(want[0])) and np.array_equal(penalties,
                                                                             _u64(want[1]))
        part = np.ascontiguousarray(port_sweeps._participating(packed, 1))
        scores = np.ascontiguousarray(packed["inactivity_scores"])
        out = np.zeros(n, np.uint64)
        core.inactivity_updates_host(_ptr(scores), _ptr(part), _ptr(elig), n, 4, 16,
                                     int(leaking), _ptr(out))
        assert np.array_equal(out, _u64(ref_sweeps.inactivity_updates_device(packed, ctx,
                                                                             leaking)))
    rng = np.random.default_rng(n)
    eff = rng.integers(0, TOP, n, dtype=np.uint64, endpoint=False)
    scores = rng.integers(0, TOP, n, dtype=np.uint64, endpoint=False)
    not_target = rng.random(n) < 0.8
    out = np.zeros(n, np.uint64)
    core.inactivity_penalties_host(_ptr(eff), _ptr(scores), _ptr(not_target), n,
                                   4 * 50331648, _ptr(out))
    want = ref_sweeps._inactivity_penalties(jnp.asarray(eff), jnp.asarray(scores),
                                            jnp.asarray(not_target), bias=4, quotient=50331648)
    assert np.array_equal(out, _u64(want))


def _flag_outputs(fn, eff, part, elig, total: int, weight: int, leaking: bool,
                  is_head: bool) -> tuple:
    n = eff.shape[0]
    rewards, penalties = np.zeros(n, np.uint64), np.zeros(n, np.uint64)
    fn(_ptr(eff), _ptr(part), _ptr(elig), n, total, weight, INC, 64, 64, int(leaking),
       int(is_head), _ptr(rewards), _ptr(penalties))
    return rewards, penalties


@pytest.mark.parametrize("n", SIZES)
def test_header_flag_lane_on_reciprocals_matches_reference(core, n):
    """The kernel's lane (flag_sweep, then flag_base_reward, flag_penalty
    and flag_reward: every division a multiply-high) against the lane with
    the reference's divisions
    (flag_scalars, flag_delta) and the reference, both leak settings and all
    three flags, with products past 2^64."""
    ctx = RefContext.for_mainnet()
    for leaking in (False, True):
        packed = _packed(n, seed=700 + n, wide=True)
        eff = np.ascontiguousarray(packed["effective_balance"])
        elig = np.ascontiguousarray(packed["eligible"])
        for flag_index in range(3):
            part = np.ascontiguousarray(port_sweeps._participating(packed, flag_index))
            args = (eff, part, elig, 64 * INC + 12345, WEIGHTS[flag_index], leaking,
                    flag_index == 2)
            got = _flag_outputs(core.flag_lanes_host, *args)
            divided = _flag_outputs(core.flag_deltas_host, *args)
            want = ref_sweeps.flag_deltas_device(packed, flag_index, 64 * INC + 12345, ctx,
                                                 leaking)
            for g, d, w in zip(got, divided, want):
                assert np.array_equal(g, d) and np.array_equal(g, _u64(w)), (n, flag_index)


def test_header_flag_lane_products_wrap_like_reference(core):
    """test_flag_deltas_products_wrap_like_reference's columns (balances at
    and above 2^62, products past 2^64) through the kernel's lane."""
    rng = np.random.default_rng(3)
    n = 4099
    eff = rng.integers(1 << 62, TOP, n, dtype=np.uint64, endpoint=False)
    part = rng.random(n) < 0.5
    elig = rng.random(n) < 0.9
    got = _flag_outputs(core.flag_lanes_host, eff, part, elig, INC, 26, False, False)
    divided = _flag_outputs(core.flag_deltas_host, eff, part, elig, INC, 26, False, False)
    want = ref_sweeps._flag_deltas(
        jnp.asarray(eff), jnp.asarray(part), jnp.asarray(elig), jnp.uint64(INC),
        jnp.uint64(26), flag_index=1, increment=INC, base_reward_factor=64,
        weight_denominator=64, is_leaking=False,
    )
    for g, d, w in zip(got, divided, want):
        assert np.array_equal(g, d) and np.array_equal(g, _u64(w))
    assert got[0].any() and got[1].any()


FUSED_FORMS = {"divided": 0, "reciprocals": 1, "schedule": 2}
# The scalar words of the fused pass (increment, brpi, active increments,
# penalty denominator, bias, recovery rate, three weights, weight
# denominator) with each of its four divisors at 1, at powers of two, and
# above 2^63 (the reward divisor, active increments x weight denominator,
# wraps there).
EDGE_SCALARS = {
    "mainnet": (INC, 907, 1 << 15, 4 * 3 * 10**7, 4, 16, *WEIGHTS, 64),
    "divisors_one": (1, 3, 1, 1, 4, 16, *WEIGHTS, 1),
    "powers_of_two": (1 << 30, 1025, 1 << 20, 1 << 26, 4, 16, *WEIGHTS, 64),
    "above_2_63": ((1 << 63) + 12345, (1 << 40) + 3, (1 << 62) + 5, TOP - 59, 4, 16, *WEIGHTS,
                   3),
}
COLUMN_NAMES = ("balances", "eff", "prev_part", "slashed", "active_prev", "eligible", "scores")


def _fused_words(k: dict) -> tuple:
    increment, brpi, active_increments, denominator = _fused_scalars(k)
    return (increment, brpi, active_increments, denominator, 4, 16, *WEIGHTS, 64)


def _reference_fused(columns: list, words: tuple, leaking: bool) -> tuple:
    """The reference's fused_epoch_kernel under numpy (head flag 2, target
    flag 1): (new scores, new balances, wrapped)."""
    with np.errstate(over="ignore"):
        return ref_epoch_vector.fused_epoch_kernel(
            np, *columns, *(np.uint64(w) for w in words[:4]), words[4], words[5],
            tuple(words[6:9]), words[9], leaking, 2, 1)


def _run_fused(core, form: int, columns: list, words: tuple, leaking: bool, update: bool = True,
               fit: int = 528, vector: bool = True) -> dict:
    """fused_host in one form: the outputs, the flag sums, the census and
    (the schedule) each validator's visits."""
    n = len(columns[0])
    out_scores, out_balances = np.zeros(n, np.uint64), np.zeros(n, np.uint64)
    sums, visits = np.zeros(3, np.uint64), np.zeros(n, np.uint8)
    word_arr = _u64(words)
    wrapped = core.fused_host(form, *(_ptr(c) for c in columns), n, _ptr(word_arr), int(leaking),
                              2, 1, int(update), fit, int(vector), _ptr(out_scores),
                              _ptr(out_balances), _ptr(sums), _ptr(visits))
    return {"scores": out_scores, "balances": out_balances, "sums": sums, "wrapped": wrapped,
            "visits": visits}


def _flag_sums(columns: list) -> list:
    eff, part, slashed, active = columns[1], columns[2], columns[3], columns[4]
    unslashed = active & ~slashed
    return [sum(int(v) for v in eff[unslashed & ((part >> f) & 1).astype(bool)]) % TOP
            for f in range(3)]


@pytest.mark.parametrize("form", FUSED_FORMS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("wrap", [False, True])
def test_header_fused_matches_reference(core, n, wrap, form):
    """The division-as-written lane, the lane on reciprocals and the
    kernel's schedule run on the host, against the reference."""
    for leaking in (False, True):
        k = _fused_inputs(n, seed=500 + n, wrap=wrap)
        words = _fused_words(k)
        columns = [np.ascontiguousarray(k[c]) for c in COLUMN_NAMES]
        got = _run_fused(core, FUSED_FORMS[form], columns, words, leaking)
        want = _reference_fused(columns, words, leaking)
        assert np.array_equal(got["scores"], want[0]) and np.array_equal(got["balances"], want[1])
        assert got["wrapped"] == int(want[2])
        assert got["sums"].tolist() == _flag_sums(columns)


def _edge_sum_columns(n: int, seed: int, increment: int, case: str) -> list:
    """_fused_inputs with balances that wrap, effective balances across the
    whole u64 range on a third of the rows (their reward products pass
    2^64), and flag 0's sum at an edge: "zero" (no participant), "below"
    (one participant, below one increment) or "wrapped" (past 2^64, to 5)."""
    k = _fused_inputs(n, seed, wrap=True)
    rng = np.random.default_rng(seed + 1)
    k["eff"] = np.where(rng.integers(0, 3, n) == 0,
                        rng.integers(0, TOP, n, dtype=np.uint64, endpoint=False), k["eff"])
    k["prev_part"] &= np.uint8(6)
    k["active_prev"][0], k["slashed"][0], k["eligible"][0] = True, False, True
    if case == "below":
        k["prev_part"][0] |= np.uint8(1)
        k["eff"][0] = np.uint64((increment - 1) // 3)
    elif case == "wrapped":
        unslashed = k["active_prev"] & ~k["slashed"]
        k["prev_part"][1:] |= (rng.integers(0, 2, n - 1) * (unslashed[1:])).astype(np.uint8)
        k["prev_part"][0] |= np.uint8(1)
        k["eff"][0] = 0
        columns = [k[c] for c in COLUMN_NAMES]
        k["eff"][0] = np.uint64((5 - _flag_sums(columns)[0]) % TOP)
    return [np.ascontiguousarray(k[c]) for c in COLUMN_NAMES]


@pytest.mark.parametrize("form", FUSED_FORMS)
@pytest.mark.parametrize("scalars", EDGE_SCALARS)
def test_header_fused_forms_on_edge_scalars(core, scalars, form):
    """Each form against the reference with every divisor at 1, at powers of
    two and above 2^63, products past 2^64, both leak states, and a flag
    sum of 0, below one increment and wrapped; the rewards lane alone
    (forms on lanes) off the reference's new scores gives its balances."""
    words = EDGE_SCALARS[scalars]
    for case in ("zero", "below", "wrapped"):
        columns = _edge_sum_columns(4099, 41, words[0], case)
        sums = _flag_sums(columns)
        assert sums[0] == {"zero": 0, "below": (words[0] - 1) // 3, "wrapped": 5}[case]
        for leaking in (False, True):
            want = _reference_fused(columns, words, leaking)
            got = _run_fused(core, FUSED_FORMS[form], columns, words, leaking)
            assert np.array_equal(got["scores"], want[0]), (case, leaking)
            assert np.array_equal(got["balances"], want[1]), (case, leaking)
            assert got["wrapped"] == int(want[2]) and got["sums"].tolist() == sums
            if form != "schedule":
                rewards = _run_fused(core, FUSED_FORMS[form], [*columns[:6], want[0]], words,
                                     leaking, update=False)
                assert np.array_equal(rewards["balances"], want[1])
                assert rewards["wrapped"] == int(want[2])
            if not leaking and scalars == "mainnet":
                assert got["wrapped"] > 0


# A block's chunks, and the co-resident grids of one H100 at 4 and 3 blocks
# an SM and of a grid of 3 blocks, on which a warp takes several chunks.
SCHEDULE_SIZES = [0, 1, 255, 256, 257, 2047, 2048, 2049, (1 << 16) + 3, (1 << 21) + 5]
SCHEDULE_GRIDS = [(528, True), (396, True), (3, True), (3, False)]


@pytest.mark.parametrize("n", SCHEDULE_SIZES)
def test_header_fused_schedule_covers_each_validator_once(core, n):
    """The kernel's partition into blocks, warps and chunks, run on the
    host: phase 1 and phase 2 each visit every validator once, on the
    vector path and one validator a thread, and the outputs, sums and
    census equal the reference's."""
    k = _fused_inputs(n, seed=900 + n % 1000, wrap=True)
    words = _fused_words(k)
    columns = [np.ascontiguousarray(k[c]) for c in COLUMN_NAMES]
    want = _reference_fused(columns, words, False)
    sums = _flag_sums(columns)
    for fit, vector in SCHEDULE_GRIDS:
        got = _run_fused(core, FUSED_FORMS["schedule"], columns, words, False, fit=fit,
                         vector=vector)
        assert np.all(got["visits"] == 17), (fit, vector)
        assert np.array_equal(got["scores"], want[0]) and np.array_equal(got["balances"], want[1])
        assert got["wrapped"] == int(want[2]) and got["sums"].tolist() == sums
    if n >= 2049:
        assert int(want[2]) > 0


PENALTY_SIZES = [0, 1, 2, 63, 64, 65, 4099, 65541]
# (bias, quotient) of each penalty denominator: 1, 2^26, altair's 4 * 3 * 2^24
# and 2^64 - 1
PENALTY_DENOMINATORS = {"one": (1, 1), "two_26": (1, 2**26), "altair": (4, 3 * 2**24),
                        "top": (1, TOP - 1)}


def _penalty_columns(n: int, seed: int) -> list:
    """eff, scores, not_target: realistic effective balances and small
    scores beside words over the whole u64 range (the products pass 2^64
    and wrap), scores at 0 and 2^64 - 1, and row 3's product 2^64 - 1 (its
    quotient by 2^64 - 1 is 1)."""
    rng = np.random.default_rng(seed)
    eff = rng.integers(0, 33, n, dtype=np.uint64) * np.uint64(INC)
    scores = rng.integers(0, 1 << 12, n, dtype=np.uint64)
    wide = rng.random(n) < 0.5
    eff = np.where(wide, rng.integers(0, TOP, n, dtype=np.uint64, endpoint=False), eff)
    scores = np.where(wide, rng.integers(0, TOP, n, dtype=np.uint64, endpoint=False), scores)
    not_target = rng.random(n) < 0.7
    scores[::7] = 0
    scores[3::11] = np.uint64(TOP - 1)
    if n > 3:
        eff[3], not_target[3] = 1, True
    return [eff, scores, not_target]


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


def _run_penalties(core, cols, denominator: int, grid: int = 0) -> dict:
    eff, scores, not_target = cols
    n = len(eff)
    out = np.zeros(n, np.uint64)
    visits = np.zeros(max(n, 1), np.uint8)
    shape = np.zeros(2, np.int64)
    core.penalties_schedule_host(_ptr(eff), _ptr(scores), _ptr(not_target.view(np.uint8)), n,
                                 denominator, grid, _ptr(out), _ptr(visits), _ptr(shape))
    return {"out": out, "visits": visits[:n], "grid": int(shape[0]), "chunks": int(shape[1])}


def _reference_penalties(cols, bias: int, quotient: int) -> np.ndarray:
    return _u64(ref_sweeps._inactivity_penalties(*(jnp.asarray(c) for c in cols), bias=bias,
                                                 quotient=quotient))


# grid 0: the launcher's; 1 and 3: fewer blocks than the work wants
@pytest.mark.parametrize("denominator", PENALTY_DENOMINATORS)
@pytest.mark.parametrize("n", PENALTY_SIZES)
def test_header_penalties_schedule_matches_reference(core, n, denominator):
    """The inactivity penalties' partition run on the host (whole warp
    chunks, then one a thread) against the reference's
    _inactivity_penalties, every validator visited once."""
    bias, quotient = PENALTY_DENOMINATORS[denominator]
    cols = _placed(_penalty_columns(n, seed=300 + n), 0)
    want = _reference_penalties(cols, bias, quotient)
    for grid in (0, 1, 3):
        got = _run_penalties(core, cols, bias * quotient, grid)
        assert got["chunks"] == n // 256
        assert np.array_equal(got["out"], want) and np.all(got["visits"] == 1), grid
    if n >= 4099:
        products = [int(e) * int(s) for e, s, t in zip(*cols) if t]
        assert max(products) >= TOP and (want != 0).any()


@pytest.mark.parametrize("offset", range(1, 8))
def test_header_penalties_offset_columns(core, offset):
    """Columns offset by 1..7 rows: the words 16-byte aligned and the flags
    2-byte aligned only at even offsets, so the validators go one a thread
    at odd offsets, on the launcher's grid and on one block."""
    n = 65541
    bias, quotient = PENALTY_DENOMINATORS["altair"]
    cols = _placed(_penalty_columns(n, seed=400), offset)
    want = _reference_penalties(cols, bias, quotient)
    for grid in (0, 1):
        got = _run_penalties(core, cols, bias * quotient, grid)
        assert got["chunks"] == (n // 256 if offset % 2 == 0 else 0)
        assert np.array_equal(got["out"], want) and np.all(got["visits"] == 1)


def test_header_penalties_grid(core):
    """The launcher's grid: a chunk a warp (2,048 validators a block: 512
    blocks at 2^20, 128 at 2^18), the validators past the chunks in the
    last block, one block for fewer validators or none."""
    def grid(n):
        return _run_penalties(core, _placed(_penalty_columns(n, seed=1), 0), 7)
    assert grid(1 << 20)["grid"] == 512
    assert grid(1 << 18)["grid"] == 128 and grid(2049)["grid"] == 2
    assert grid(300)["grid"] == grid(1)["grid"] == grid(0)["grid"] == 1


UPDATE_SIZES = [0, 1, 255, 256, 257, 4099, 65541, 1 << 17]
UPDATE_BIAS, UPDATE_RECOVERY = 4, 16


def _update_columns(n: int, seed: int) -> list:
    """scores, participating, eligible: scores at 0, 1, around the recovery
    rate, far above it and near 2^64 (where adding the bias wraps), mixed
    flags."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 5, n)
    cases = [rng.integers(0, 3, n, dtype=np.uint64),
             np.uint64(UPDATE_RECOVERY) + rng.integers(0, 5, n, dtype=np.uint64) - np.uint64(2),
             rng.integers(0, 1 << 32, n, dtype=np.uint64),
             np.uint64(TOP - 1) - rng.integers(0, 8, n, dtype=np.uint64),
             rng.integers(0, TOP, n, dtype=np.uint64, endpoint=False)]
    scores = np.zeros(n, np.uint64)
    for k, case in enumerate(cases):
        scores = np.where(kind == k, case, scores)
    return [scores, rng.random(n) < 0.6, rng.random(n) < 0.9]


def _run_updates(core, cols, leaking: bool, grid: int = 0) -> dict:
    scores, part, elig = cols
    n = len(scores)
    out = np.zeros(n, np.uint64)
    visits = np.zeros(max(n, 1), np.uint8)
    shape = np.zeros(3, np.int64)
    core.updates_schedule_host(_ptr(scores), _ptr(part.view(np.uint8)), _ptr(elig.view(np.uint8)),
                               n, UPDATE_BIAS, UPDATE_RECOVERY, int(leaking), grid, _ptr(out),
                               _ptr(visits), _ptr(shape))
    return {"out": out, "visits": visits[:n], "grid": int(shape[0]), "chunks": int(shape[1]),
            "steps": int(shape[2])}


def _reference_updates(cols, leaking: bool) -> np.ndarray:
    return _u64(ref_sweeps._inactivity_updates(*(jnp.asarray(c) for c in cols), bias=UPDATE_BIAS,
                                               recovery_rate=UPDATE_RECOVERY,
                                               is_leaking=leaking))


# grid 0: the launcher's; 1 and 3: fewer blocks than the work wants
@pytest.mark.parametrize("leaking", [False, True])
@pytest.mark.parametrize("n", UPDATE_SIZES)
def test_header_updates_schedule_matches_reference(core, n, leaking):
    """The inactivity updates' partition run on the host (whole warp chunks
    of one step, then one a thread) against the reference's
    _inactivity_updates, every validator visited once."""
    cols = _placed(_update_columns(n, seed=500 + n), 0)
    want = _reference_updates(cols, leaking)
    for grid in (0, 1, 3):
        got = _run_updates(core, cols, leaking, grid)
        assert got["chunks"] == n // 64
        assert np.array_equal(got["out"], want) and np.all(got["visits"] == 1), grid
    if n >= 4099:
        # scores fall, stay, rise under a leak, and wrap past 2^64
        assert (want < cols[0]).any() and (want == cols[0]).any()
        assert (want > cols[0]).any() == leaking
        assert (want[cols[0] >= np.uint64(TOP - UPDATE_BIAS)] < np.uint64(UPDATE_BIAS)).any()


@pytest.mark.parametrize("offset", range(1, 8))
def test_header_updates_offset_columns(core, offset):
    """Columns offset by 1..7 rows: the scores 16-byte aligned and the flags
    2-byte aligned only at even offsets, so the validators go one a thread at
    odd offsets, on the launcher's grid and on one block."""
    n = 65541
    cols = _placed(_update_columns(n, seed=600), offset)
    for leaking in (False, True):
        want = _reference_updates(cols, leaking)
        for grid in (0, 1):
            got = _run_updates(core, cols, leaking, grid)
            assert got["chunks"] == (n // 64 if offset % 2 == 0 else 0)
            assert np.array_equal(got["out"], want) and np.all(got["visits"] == 1)


def test_header_updates_grid(core):
    """The launcher's steps and grid: one step a chunk, a chunk a warp
    (2,048 blocks at 2^20, 512 at 2^18), one block for fewer than 513
    validators or none."""
    def launch(n):
        got = _run_updates(core, _placed(_update_columns(n, seed=2), 0), False)
        return got["steps"], got["grid"]
    assert launch(1 << 20) == (1, 2048) and launch(1 << 18) == (1, 512)
    assert launch(513) == (1, 2)
    assert launch(512) == launch(300) == launch(1) == launch(0) == (1, 1)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1 << 17])
def test_kernels_match_plain_on_card(cuda, n):
    packed = _packed(n, seed=n, wide=True)
    eff = torch.from_numpy(packed["effective_balance"].view(np.int64))
    scores = torch.from_numpy(packed["inactivity_scores"].view(np.int64))
    part = torch.from_numpy(port_sweeps._participating(packed, 1))
    elig = torch.from_numpy(packed["eligible"])
    args = (64 * INC + 12345, 26, INC, 64, 64, False, False)
    for got, want in zip(port_sweeps.flag_deltas(eff.to(cuda), part.to(cuda), elig.to(cuda),
                                                 *args),
                         port_sweeps.flag_deltas_plain(eff, part, elig, *args)):
        assert torch.equal(got.cpu(), want)
    got = port_sweeps.inactivity_updates(scores.to(cuda), part.to(cuda), elig.to(cuda), 4, 16,
                                         False)
    assert torch.equal(got.cpu(), port_sweeps.inactivity_updates_plain(scores, part, elig, 4,
                                                                       16, False))
    # one and two rows in: off the warp chunks, then on them again
    for offset in (1, 2):
        cols = (scores.to(cuda)[offset:], part.to(cuda)[offset:], elig.to(cuda)[offset:])
        got = port_sweeps.inactivity_updates(*cols, 4, 16, True)
        assert torch.equal(got.cpu(), port_sweeps.inactivity_updates_plain(
            scores[offset:], part[offset:], elig[offset:], 4, 16, True))
    got = port_sweeps.inactivity_penalties(eff.to(cuda), scores.to(cuda), elig.to(cuda), 4 * 7)
    assert torch.equal(got.cpu(), port_sweeps.inactivity_penalties_plain(eff, scores, elig, 4 * 7))
    # one row in: every column off the warp chunks
    got = port_sweeps.inactivity_penalties(eff[1:].to(cuda), scores[1:].to(cuda),
                                           elig[1:].to(cuda), 4 * 3 * 2**24)
    assert torch.equal(got.cpu(), port_sweeps.inactivity_penalties_plain(
        eff[1:], scores[1:], elig[1:], 4 * 3 * 2**24))
    k = _fused_inputs(n, seed=n, wrap=True)
    scalars = (*_fused_scalars(k), 4, 16, WEIGHTS, 64, False, 2, 1)
    columns = [k[c] for c in ("balances", "eff", "prev_part", "slashed", "active_prev",
                              "eligible", "scores")]
    on_card = port_epoch.fused_epoch_device(*columns, *scalars, device="cuda")
    plain = port_epoch.fused_epoch_device(*columns, *scalars, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(on_card[:2], plain[:2]))
    assert on_card[2] == plain[2]
