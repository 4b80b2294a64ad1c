"""The device observatory (telemetry/device.py) and the epoch pass's device
entries (``models/epoch_vector.py jitted_kernels``) against the reference.

The staged entries' plain versions (``ops/epoch.py staged_*``) are held
bit-exact against the reference's numpy-bound kernels
(``epoch_vector.inactivity_scores_kernel(np, ...)`` and the rest; the
reference's jitted route would switch JAX to x64 for the whole worker) at
n = 64, 257 and 2^16 + 5 on u64 edge rows, and so is a g++ build of the
lane code of ``csrc/epoch_staged.cu`` (``epoch_staged_core.h`` and
``altair_core.h``'s inactivity lane on ``warp_chunks::schedule_host``). The
ledgers: logical transfer bytes, the call ledger's signatures and its drift
sentinel, the compile ledger of ``_kernels.load``, the launch ledger beside
every launch count, the routing journal of the ``_device_flags`` gates and
the epoch engine, and the off path's cost as calls into the recorder.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ethereum_consensus_tpu.models import epoch_vector as ref_ev
from ethereum_consensus_tpu_torch import _device_flags, _kernels
from ethereum_consensus_tpu_torch.models import epoch_vector
from ethereum_consensus_tpu_torch.ops import epoch as ops_epoch
from ethereum_consensus_tpu_torch.telemetry import device as device_obs
from ethereum_consensus_tpu_torch.telemetry import metrics, spans
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ethereum_consensus_tpu_torch"
CSRC = PORT / "csrc"
TOP = (1 << 64) - 1
SIZES = [64, 257, (1 << 16) + 5]


@pytest.fixture(autouse=True)
def _observatory_off_between_tests():
    yield
    device_obs.stop()
    if spans.RECORDER.enabled:
        spans.stop_recording()


def _metric(name):
    return metrics.counter(name).value()


def _words(arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, np.uint64).view(np.int64))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# edge rows: seeded columns whose first rows are the u64 edges
# ---------------------------------------------------------------------------

SCORE_EDGES = [0, 1, 15, 16, 17, 1 << 32, (1 << 63) - 1, 1 << 63, TOP - 3, TOP - 4, TOP]
BALANCE_EDGES = [0, 1, 32 * 10**9, 1 << 63, TOP - 5, TOP, (1 << 62) + 7, 2 * 10**9]


def _column(rng, n: int, edges, high: int) -> np.ndarray:
    col = rng.integers(0, high, n, dtype=np.uint64)
    k = min(n, len(edges))
    col[:k] = np.asarray(edges[:k], np.uint64)
    return col


def _flags(rng, n: int, p: float) -> np.ndarray:
    flags = rng.random(n) < p
    # every combination of the two flags on the edge rows
    flags[: min(n, 4)] = [True, False, True, False][: min(n, 4)]
    return flags


def _staged_inputs(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    eligible = _flags(rng, n, 0.9)
    participating = _flags(rng, n, 0.6)
    participating[: min(n, 4)] = [True, True, False, False][: min(n, 4)]
    return {
        "scores": _column(rng, n, SCORE_EDGES, 1 << 12),
        "base_reward": _column(rng, n, BALANCE_EDGES + [TOP // 14, 1 << 58], 1 << 40),
        "balances": _column(rng, n, BALANCE_EDGES, 64 * 10**9),
        "eligible": eligible,
        "participating": participating,
        "pairs": [
            (_column(rng, n, [TOP, 1, 0, 1 << 63, TOP], 1 << 31),
             _column(rng, n, [0, TOP, 1 << 63, 0, 5], 1 << 31))
            for _ in range(4)
        ],
    }


INACTIVITY_CASES = {
    "altair": (4, 16, False),
    "leaking": (4, 16, True),
    "wrapping_bias": (TOP, 1, False),
    "big_recovery": (1, TOP, False),
}
FLAG_CASES = {
    "source": dict(weight=14, unslashed_increments=977, active_increments=1 << 20,
                   weight_denominator=64, leaking=False, is_head_flag=False),
    "head": dict(weight=14, unslashed_increments=977, active_increments=1 << 20,
                 weight_denominator=64, leaking=False, is_head_flag=True),
    "leaking": dict(weight=26, unslashed_increments=5, active_increments=3,
                    weight_denominator=64, leaking=True, is_head_flag=False),
    "product_past_2_64": dict(weight=TOP, unslashed_increments=TOP - 1,
                              active_increments=(1 << 57) + 3, weight_denominator=97,
                              leaking=False, is_head_flag=False),
    "zero_divisor": dict(weight=14, unslashed_increments=9, active_increments=0,
                         weight_denominator=0, leaking=False, is_head_flag=False),
}


def _ref_flag(inputs, case):
    with np.errstate(divide="ignore"):
        return ref_ev.flag_deltas_kernel(
            np, inputs["base_reward"], inputs["eligible"], inputs["participating"],
            case["weight"], case["unslashed_increments"], case["active_increments"],
            case["weight_denominator"], case["leaking"], case["is_head_flag"],
        )


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", sorted(INACTIVITY_CASES))
def test_staged_inactivity_plain_matches_reference(n, case):
    k = _staged_inputs(n, seed=n)
    bias, recovery, leaking = INACTIVITY_CASES[case]
    want = ref_ev.inactivity_scores_kernel(
        np, k["scores"], k["eligible"], k["participating"], bias, recovery, leaking)
    got = ops_epoch.staged_inactivity_scores(
        _words(k["scores"]), torch.from_numpy(k["eligible"]),
        torch.from_numpy(k["participating"]), bias, recovery, leaking)
    assert np.array_equal(_host(got), want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_staged_flag_deltas_plain_matches_reference(n, case):
    k = _staged_inputs(n, seed=7 * n)
    want_r, want_p = _ref_flag(k, FLAG_CASES[case])
    got_r, got_p = ops_epoch.staged_flag_deltas(
        _words(k["base_reward"]), torch.from_numpy(k["eligible"]),
        torch.from_numpy(k["participating"]), **FLAG_CASES[case])
    assert np.array_equal(_host(got_r), want_r)
    assert np.array_equal(_host(got_p), want_p)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k_pairs", [1, 4])
def test_staged_apply_plain_matches_reference(n, k_pairs):
    k = _staged_inputs(n, seed=3 * n + k_pairs)
    pairs = k["pairs"][:k_pairs]
    want = ref_ev.apply_delta_pairs_kernel(np, k["balances"], pairs)
    got = ops_epoch.staged_apply_delta_pairs(
        _words(k["balances"]), _words(np.stack([r for r, _ in pairs])),
        _words(np.stack([p for _, p in pairs])))
    assert np.array_equal(_host(got), want)
    if k_pairs == 1:
        assert want[1] == 0  # 1 + 1, then a penalty of 2^64 - 1 saturates


def test_staged_edges_hit_the_wraps_and_saturations():
    """The edge rows do what they are there for: the bias add wraps, a
    reward product passes 2^64, a pair's add wraps and a penalty
    saturates."""
    k = _staged_inputs(64, seed=1)
    scores = ref_ev.inactivity_scores_kernel(
        np, k["scores"], k["eligible"], k["participating"], 4, 16, True)
    assert scores[10] < k["scores"][10]  # 2^64 - 1 + 4 wrapped (row 10: eligible, absent)
    b = int(k["base_reward"][5])
    assert b * TOP * (TOP - 1) >= 1 << 64
    with np.errstate(over="ignore"):
        raised = k["balances"] + k["pairs"][0][0]
    assert (raised < k["balances"]).any()
    out = ref_ev.apply_delta_pairs_kernel(np, k["balances"], k["pairs"][:1])
    assert (out == 0).any()


@pytest.mark.parametrize("field, value", [
    ("weight", 1 << 64), ("unslashed_increments", -1), ("active_increments", 1 << 60),
])
def test_staged_flag_deltas_overflow_raises_as_reference(field, value):
    """A scalar outside u64 raises the reference's OverflowError, from the
    reference's branch: the reward divisor active_increments *
    weight_denominator above 2^64 - 1 among them."""
    k = _staged_inputs(64, seed=2)
    case = dict(FLAG_CASES["source"], **{field: value})
    with pytest.raises(OverflowError):
        _ref_flag(k, case)
    cols = (_words(k["base_reward"]), torch.from_numpy(k["eligible"]),
            torch.from_numpy(k["participating"]))
    with pytest.raises(OverflowError):
        ops_epoch.staged_flag_deltas(*cols, **case)
    # in a leak the reward branch is not read: neither raises on its scalars
    if field != "weight":
        leak = dict(case, leaking=True)
        want = _ref_flag(k, leak)
        got = ops_epoch.staged_flag_deltas(*cols, **leak)
        assert np.array_equal(_host(got[1]), want[1])


def test_staged_inactivity_overflow_raises_as_reference():
    k = _staged_inputs(64, seed=4)
    cols = (_words(k["scores"]), torch.from_numpy(k["eligible"]),
            torch.from_numpy(k["participating"]))
    for bias, recovery, leaking in [(1 << 64, 16, False), (4, -1, False)]:
        with pytest.raises(OverflowError):
            ref_ev.inactivity_scores_kernel(np, k["scores"], k["eligible"],
                                            k["participating"], bias, recovery, leaking)
        with pytest.raises(OverflowError):
            ops_epoch.staged_inactivity_scores(*cols, bias, recovery, leaking)
    # a leak never reads the recovery rate
    ops_epoch.staged_inactivity_scores(*cols, 4, -1, True)


def test_staged_cuda_wrappers_refuse_cpu_tensors():
    k = _staged_inputs(64, seed=5)
    with pytest.raises(ValueError, match="CUDA"):
        ops_epoch.staged_inactivity_scores_cuda(
            _words(k["scores"]), torch.from_numpy(k["eligible"]),
            torch.from_numpy(k["participating"]), 4, 16, False)


# ---------------------------------------------------------------------------
# the entries of jitted_kernels()
# ---------------------------------------------------------------------------


def test_jitted_kernels_has_the_reference_keys_and_names():
    kernels = epoch_vector.jitted_kernels()
    assert set(kernels) == {"inactivity_scores", "flag_deltas", "apply_delta_pairs",
                            "fused_epoch"}
    assert {fn.__qualname__ for fn in kernels.values()} == {
        "epoch_vector.inactivity_scores_kernel", "epoch_vector.flag_deltas_kernel",
        "epoch_vector.apply_delta_pairs_kernel", "epoch_vector.fused_epoch_kernel"}


def test_jitted_entries_on_cpu_match_reference():
    """The reference's test_jitted_epoch_kernels_bit_identical_to_numpy, on
    the port's entries with the plain versions."""
    k = _staged_inputs(257, seed=11)
    kernels = epoch_vector.jitted_kernels()
    got = kernels["inactivity_scores"](k["scores"], k["eligible"], k["participating"],
                                       4, 16, True, device="cpu")
    assert got.dtype == np.uint64
    assert np.array_equal(got, ref_ev.inactivity_scores_kernel(
        np, k["scores"], k["eligible"], k["participating"], 4, 16, True))
    case = FLAG_CASES["source"]
    got_r, got_p = kernels["flag_deltas"](
        k["base_reward"], k["eligible"], k["participating"], *case.values(), device="cpu")
    want_r, want_p = _ref_flag(k, case)
    assert np.array_equal(got_r, want_r) and np.array_equal(got_p, want_p)
    got = kernels["apply_delta_pairs"](k["balances"], k["pairs"], device="cpu")
    assert np.array_equal(got, ref_ev.apply_delta_pairs_kernel(np, k["balances"], k["pairs"]))


def test_jitted_entries_default_to_the_card():
    k = _staged_inputs(64, seed=12)
    with pytest.raises((RuntimeError, AssertionError)):
        epoch_vector.jitted_kernels()["inactivity_scores"](
            k["scores"], k["eligible"], k["participating"], 4, 16, False)


# ---------------------------------------------------------------------------
# the lane code built with g++ (the kernels' schedules on the host)
# ---------------------------------------------------------------------------

_HOST_SHIM = r"""
#include "altair_core.h"
#include "epoch_staged_core.h"

// The three staged kernels' schedules on the columns as they lie in
// memory (the launchers' alignment tests pick the path), on the launchers'
// grids (grid 0) or on `grid` blocks; visits counts each validator's visits.
extern "C" void staged_inactivity_host(const uint64_t* scores, const uint8_t* eligible,
                                       const uint8_t* participating, int64_t n, uint64_t bias,
                                       uint64_t recovery, int leaking, int64_t grid,
                                       uint64_t* out, uint8_t* visits) {
  constexpr int kSteps = altair_core::kUpdateSteps;
  const altair_core::UpdateColumns c =
      altair_core::update_columns<kSteps>(scores, participating, eligible, n, out);
  if (grid == 0) grid = warp_chunks::chunk_grid<kSteps>(n);
  altair_core::inactivity_updates_host<kSteps>(c, bias, recovery, leaking != 0, grid, visits);
}

extern "C" void staged_flag_deltas_host(const uint64_t* base, const uint8_t* eligible,
                                        const uint8_t* unslashed, int64_t n, uint64_t weight,
                                        uint64_t increments, uint64_t divisor,
                                        uint64_t weight_denominator, int leaking, int is_head,
                                        int64_t grid, uint64_t* rewards, uint64_t* penalties,
                                        uint8_t* visits, int64_t* chunks) {
  const epoch_staged::FlagColumns c =
      epoch_staged::flag_columns(base, eligible, unslashed, n, rewards, penalties);
  const epoch_staged::StagedFlag s = epoch_staged::staged_flag(
      weight, increments, divisor, weight_denominator, leaking != 0, is_head != 0);
  *chunks = c.chunks;
  epoch_staged::flag_deltas_host(c, s, grid == 0 ? warp_chunks::chunk_grid(n) : grid, visits);
}

extern "C" void staged_apply_host(const uint64_t* balances, const uint64_t* rewards,
                                  const uint64_t* penalties, int64_t n, int64_t k, int64_t grid,
                                  uint64_t* out, uint8_t* visits, int64_t* chunks) {
  const epoch_staged::PairColumns c =
      epoch_staged::pair_columns(balances, rewards, penalties, n, k, out);
  *chunks = c.chunks;
  epoch_staged::apply_pairs_host(c, grid == 0 ? warp_chunks::chunk_grid(n) : grid, visits);
}
"""

_P, _I64, _U64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("epoch_staged")
    shim = tmp / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    lib_path = tmp / "libepoch_staged.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
         f"-I{CSRC}", str(shim), "-o", str(lib_path)],
        check=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.staged_inactivity_host.argtypes = [_P, _P, _P, _I64, _U64, _U64, _INT, _I64, _P, _P]
    lib.staged_flag_deltas_host.argtypes = ([_P, _P, _P, _I64] + [_U64] * 4
                                            + [_INT, _INT, _I64] + [_P] * 4)
    lib.staged_apply_host.argtypes = [_P, _P, _P, _I64, _I64, _I64, _P, _P, _P]
    for fn in (lib.staged_inactivity_host, lib.staged_flag_deltas_host, lib.staged_apply_host):
        fn.restype = None
    return lib


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


def _placed(arr: np.ndarray, offset: int) -> np.ndarray:
    """``arr`` copied ``offset`` elements into a 64-byte aligned buffer: a
    column the vector path must refuse when offset is odd."""
    buf = np.zeros(arr.shape[0] + offset + 64 // arr.itemsize, arr.dtype)
    start = (-(buf.ctypes.data // arr.itemsize)) % (64 // arr.itemsize) + offset
    out = buf[start:start + arr.shape[0]]
    out[:] = arr
    return out


HOST_SIZES = [1, 63, 64, 257, 4099, (1 << 16) + 5]
GRIDS = [0, 1, 3]


@pytest.mark.parametrize("n", HOST_SIZES)
@pytest.mark.parametrize("offset", [0, 1])
def test_header_staged_inactivity_matches_reference(core, n, offset):
    k = _staged_inputs(n, seed=100 + n)
    scores = _placed(k["scores"], offset)
    elig = _placed(k["eligible"].astype(np.uint8), offset)
    part = _placed(k["participating"].astype(np.uint8), offset)
    for bias, recovery, leaking in INACTIVITY_CASES.values():
        want = ref_ev.inactivity_scores_kernel(
            np, k["scores"], k["eligible"], k["participating"], bias, recovery, leaking)
        for grid in GRIDS:
            out = np.zeros(n, np.uint64)
            visits = np.zeros(n, np.uint8)
            core.staged_inactivity_host(_ptr(scores), _ptr(elig), _ptr(part), n, bias,
                                        recovery, int(leaking), grid, _ptr(out), _ptr(visits))
            assert np.all(visits == 1) and np.array_equal(out, want), (bias, grid)


def _flag_words(case) -> tuple:
    weight, inc, divisor, wd = ops_epoch._flag_words(
        case["weight"], case["unslashed_increments"], case["active_increments"],
        case["weight_denominator"], case["leaking"], case["is_head_flag"])
    return weight, inc, divisor, wd, int(case["leaking"]), int(case["is_head_flag"])


@pytest.mark.parametrize("n", HOST_SIZES)
@pytest.mark.parametrize("offset", [0, 1])
def test_header_staged_flag_deltas_matches_reference(core, n, offset):
    k = _staged_inputs(n, seed=200 + n)
    base = _placed(k["base_reward"], offset)
    elig = _placed(k["eligible"].astype(np.uint8), offset)
    unsl = _placed(k["participating"].astype(np.uint8), offset)
    for name, case in FLAG_CASES.items():
        want_r, want_p = _ref_flag(k, case)
        for grid in GRIDS:
            rewards, penalties = np.zeros(n, np.uint64), np.zeros(n, np.uint64)
            visits = np.zeros(n, np.uint8)
            chunks = np.zeros(1, np.int64)
            core.staged_flag_deltas_host(_ptr(base), _ptr(elig), _ptr(unsl), n,
                                         *_flag_words(case), grid, _ptr(rewards),
                                         _ptr(penalties), _ptr(visits), _ptr(chunks))
            assert np.all(visits == 1), (name, grid)
            assert np.array_equal(rewards, want_r) and np.array_equal(penalties, want_p), name
            assert (chunks[0] > 0) == (offset == 0 and n >= 256)


@pytest.mark.parametrize("n", HOST_SIZES)
@pytest.mark.parametrize("k_pairs", [1, 4])
def test_header_staged_apply_matches_reference(core, n, k_pairs):
    k = _staged_inputs(n, seed=300 + n)
    pairs = k["pairs"][:k_pairs]
    want = ref_ev.apply_delta_pairs_kernel(np, k["balances"], pairs)
    rewards = _placed(np.concatenate([r for r, _ in pairs]), 0)
    penalties = _placed(np.concatenate([p for _, p in pairs]), 0)
    balances = _placed(k["balances"], 0)
    for grid in GRIDS:
        out = np.zeros(n, np.uint64)
        visits = np.zeros(n, np.uint8)
        chunks = np.zeros(1, np.int64)
        core.staged_apply_host(_ptr(balances), _ptr(rewards), _ptr(penalties), n, k_pairs,
                               grid, _ptr(out), _ptr(visits), _ptr(chunks))
        assert np.all(visits == 1) and np.array_equal(out, want), grid
        # odd n with several pairs: the rows are not 16-byte aligned
        assert (chunks[0] > 0) == (n >= 256 and (k_pairs == 1 or n % 2 == 0))


# ---------------------------------------------------------------------------
# the ledgers
# ---------------------------------------------------------------------------


def test_transfer_ledger_counts_logical_bytes_per_site():
    """A u64 column counts 8 bytes a word though it travels as int64, a
    flag 1 byte; the returned tensors are on the asked device."""
    words = np.arange(100, dtype=np.uint64)
    flags = np.ones(100, bool)
    with device_obs.observing() as obs:
        h2d_bytes0 = _metric("device.transfer.h2d_bytes")
        out, out_flags = device_obs.h2d("test.site", words, flags, device="cpu")
        back = device_obs.d2h("test.site", out, np.uint64)
        assert _metric("device.transfer.h2d_bytes") == h2d_bytes0 + 900
        summary = obs.transfer_summary()
    assert out.dtype == torch.int64 and out_flags.dtype == torch.bool
    assert out.device.type == "cpu" and back.dtype == np.uint64
    assert np.array_equal(back, words)
    site = summary["sites"]["test.site"]
    assert site == {"h2d_count": 2, "h2d_bytes": 900, "d2h_count": 1, "d2h_bytes": 800}


def test_transfers_and_launches_render_on_the_device_lane():
    arr = np.arange(64, dtype=np.uint64)
    spans.start_recording()
    with device_obs.observing() as obs:
        device_obs.d2h("lane.site", device_obs.h2d("lane.site", arr, device="cpu"))
        device_obs.launch("fused_epoch")
        device_obs.launch("g1_sum_sets", 2)
        launches = obs.launches()
    doc = spans.RECORDER.chrome_trace()
    spans.stop_recording()
    assert launches == {"fused_epoch": 1, "g1_sum_sets": 2}
    lanes = {e["args"]["name"]: e["tid"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    lane = lanes["device"]
    on_lane = [e for e in doc["traceEvents"] if e.get("tid") == lane and e.get("ph") in "Xi"]
    h2d = [e for e in on_lane if e["name"] == "device.h2d"]
    assert h2d and h2d[0]["args"] == {"site": "lane.site", "bytes": 512, "count": 1,
                                      "span_id": h2d[0]["args"]["span_id"],
                                      "trace_id": h2d[0]["args"]["trace_id"]}
    assert sorted(e["args"]["kernel"] for e in on_lane if e["name"] == "device.launch") == [
        "fused_epoch", "g1_sum_sets"]


def test_signature_ledger_uses_logical_dtypes():
    kernels = epoch_vector.jitted_kernels()
    k = _staged_inputs(64, seed=21)
    with device_obs.observing() as obs:
        hits0 = _metric("device.jit_cache.hits")
        for _ in range(2):
            kernels["inactivity_scores"](k["scores"], k["eligible"], k["participating"],
                                         4, 16, False, device="cpu")
        assert _metric("device.jit_cache.hits") == hits0 + 1
        sigs = obs.signatures()["epoch_vector.inactivity_scores_kernel"]
        calls = obs.calls()["epoch_vector.inactivity_scores_kernel"]
    assert sigs == ["(uint64[64], bool[64], bool[64], 4, 16, False, device='cpu')"]
    assert calls == 2
    # a torch word column reads by its logical dtype where the wrapper names it
    sig = device_obs.signature_of((torch.zeros(3, dtype=torch.int64), torch.zeros(3)), {},
                                  ("uint64",))
    assert sig == "(uint64[3], float32[3])"


def test_recompile_sentinel_fires_once_with_both_signatures():
    """The reference's acceptance check on the port's call ledger: a drift
    of the same entry's signature counts every time and names the first
    drift once."""
    kernel = epoch_vector.jitted_kernels()["inactivity_scores"]

    def run(n):
        return kernel(np.zeros(n, np.uint64), np.ones(n, bool), np.ones(n, bool), 4, 16, False,
                      device="cpu")

    spans.start_recording()
    with device_obs.observing():
        recompiles0 = _metric("device.recompiles")
        run(64)
        assert _metric("device.recompiles") == recompiles0
        run(96)
        assert _metric("device.recompiles") == recompiles0 + 1
        run(128)
        assert _metric("device.recompiles") == recompiles0 + 2
        run(96)
        assert _metric("device.recompiles") == recompiles0 + 2
        doc = spans.RECORDER.chrome_trace()
    spans.stop_recording()
    ours = [e for e in doc["traceEvents"] if e.get("ph") == "i"
            and e["name"] == "device.recompile"
            and e["args"]["fn"] == "epoch_vector.inactivity_scores_kernel"]
    assert len(ours) == 1
    assert "uint64[64]" in ours[0]["args"]["old_signature"]
    assert "uint64[96]" in ours[0]["args"]["new_signature"]


def test_kernels_load_records_each_library_once(tmp_path, monkeypatch):
    """``_kernels.load`` is the port's compile: the first load of a library
    is recorded with its seconds and whether it was built; a cached load
    records nothing."""
    if shutil.which("gcc") is None:
        pytest.skip("needs gcc")
    src = tmp_path / "k.c"
    src.write_text("int probe_launch(void) { return 0; }\n")
    lib = tmp_path / "k.so"
    subprocess.run(["gcc", "-shared", "-fPIC", str(src), "-o", str(lib)], check=True)
    monkeypatch.setitem(_kernels._LIBRARIES, "probe", (("k.c",),
                        {"probe_launch": ([], ctypes.c_int)}))
    monkeypatch.setattr(_kernels, "_paths", lambda name: (str(lib), str(lib) + ".log"))
    monkeypatch.delitem(_kernels._LOADED, "probe", raising=False)
    with device_obs.observing() as obs:
        compiles0 = _metric("device.compiles")
        assert _kernels.load("probe").probe_launch() == 0
        _kernels.load("probe")
        ledger = obs.compiles()
    assert _metric("device.compiles") == compiles0 + 1
    assert [(c["fn"], c["built"]) for c in ledger] == [("probe", False)]
    assert ledger[0]["compile_s"] >= 0
    monkeypatch.delitem(_kernels._LOADED, "probe")


def test_every_launch_count_records_in_the_launch_ledger():
    """Each wrapper that adds to a launch count records the same launches
    in the ledger on the next line: the ledger and ``launch_counts`` agree
    kernel by kernel."""
    bumps = 0
    for path in sorted((PORT / "ops").glob("*.py")):
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            m = re.match(r"\s*(launch_counts?(?:_mxu)?)(\[[^\]]+\])? \+= (\w+)", line)
            if not m:
                continue
            bumps += 1
            follow = "\n".join(lines[i + 1:i + 3])
            assert "_obs.launch(" in follow, f"{path.name}:{i + 1} {line.strip()}"
    assert bumps >= 18


def test_device_flags_journal_threshold_decisions(monkeypatch):
    monkeypatch.setattr(_device_flags, "SWEEPS_MIN_N", 100)
    with device_obs.observing() as obs:
        assert not _device_flags.sweeps_enabled(10)
        assert _device_flags.sweeps_enabled(1000)
        routes = obs.routes()
    mine = [r for r in routes if r["kind"] == "sweeps"]
    assert [(r["choice"], r["reason"], r["inputs"]) for r in mine] == [
        ("host", "below_threshold", {"n": 10, "threshold": 100}),
        ("device", "routed", {"n": 1000, "threshold": 100}),
    ]
    assert obs.route_tallies()["sweeps"] == {"host": 1, "device": 1}


def test_epoch_vector_decline_journaled_and_one_shot(monkeypatch):
    """The reference's decline contract: a counter per occurrence, one
    trace event per reason, the routing journal with the threshold
    inputs."""
    import torch_genesis

    from ethereum_consensus_tpu.models.phase0 import containers as ref_containers
    from ethereum_consensus_tpu_torch.config import Context
    from ethereum_consensus_tpu_torch.models.phase0 import containers

    ref_state, ref_ctx = torch_genesis.fresh_genesis(64, "minimal")
    data = ref_containers.build(ref_ctx.preset).BeaconState.serialize(ref_state)
    ctx = Context.for_minimal()
    state = containers.build(ctx.preset).BeaconState.deserialize(data)
    monkeypatch.setattr(epoch_vector, "_FALLBACK_SEEN", set())
    spans.start_recording()
    with device_obs.observing() as obs:
        below0 = _metric("epoch_vector.fallback.below_threshold")
        assert not epoch_vector.process_epoch_columnar(state, ctx, "phase0")
        assert not epoch_vector.process_epoch_columnar(state, ctx, "phase0")
        assert _metric("epoch_vector.fallback.below_threshold") == below0 + 2
        monkeypatch.setattr(epoch_vector, "EPOCH_VECTOR_MIN_VALIDATORS", 0)
        monkeypatch.setattr(_device_flags, "SWEEPS_MIN_N", 1)
        assert not epoch_vector.process_epoch_columnar(state, ctx, "phase0")
        journal = [r for r in obs.routes() if r["kind"] == "epoch_vector"]
        doc = spans.RECORDER.chrome_trace()
    spans.stop_recording()
    events = [e["args"]["reason"] for e in doc["traceEvents"]
              if e.get("ph") == "i" and e["name"] == "epoch_vector.fallback"]
    assert sorted(events) == ["below_threshold", "device_sweeps"]
    assert [(r["reason"], r["inputs"]) for r in journal] == [
        ("below_threshold", {"validators": 64, "threshold": 1 << 12}),
        ("below_threshold", {"validators": 64, "threshold": 1 << 12}),
        ("device_sweeps", {"validators": 64, "sweeps_min_n": 1}),
    ]


def test_pairing_route_journaled_with_threshold():
    from ethereum_consensus_tpu_torch.crypto import bls

    sks = [bls.SecretKey(i + 31) for i in range(3)]
    sets = [bls.SignatureSet([sk.public_key()], b"msg-%d" % i, sk.sign(b"msg-%d" % i))
            for i, sk in enumerate(sks)]
    with device_obs.observing() as obs:
        host0 = _metric("bls.pairing_route.host")
        assert bls.verify_signature_sets(sets) == [True, True, True]
        routes = [r for r in obs.routes() if r["kind"] == "pairing"]
    assert bls.last_batch_route() == "host"
    assert _metric("bls.pairing_route.host") == host0 + 1
    assert [(r["choice"], r["reason"], r["inputs"]) for r in routes] == [
        ("host", "not_installed", {"sets": 3, "threshold": None})]


def test_a_failing_device_route_raises_and_is_journaled(monkeypatch):
    """The port's divergence: the decline is journaled (choice ``raised``)
    and the fault goes on up; no route answers for another."""
    from ethereum_consensus_tpu_torch.crypto import bls

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(bls, "_batch_device_pairing", broken)
    monkeypatch.setattr(_device_flags, "PAIRING_MIN_SETS", 2)
    sks = [bls.SecretKey(i + 41) for i in range(2)]
    sets = [bls.SignatureSet([sk.public_key()], b"m%d" % i, sk.sign(b"m%d" % i))
            for i, sk in enumerate(sks)]
    with device_obs.observing() as obs:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            bls.verify_signature_sets(sets)
        routes = [r for r in obs.routes() if r["kind"] == "bls_device"]
    assert [(r["choice"], r["reason"], r["inputs"]) for r in routes] == [
        ("raised", "pairing", {"cause": "RuntimeError"})]


def test_snapshot_has_every_ledger():
    with device_obs.observing():
        device_obs.route("pairing", "host", "below_threshold", sets=2, threshold=512)
        doc = device_obs.snapshot()
    assert doc["observing"] is True
    assert set(doc) >= {"compile_ledger", "call_ledger", "launch_ledger", "transfer_ledger",
                        "routing_journal", "jit_cache"}
    assert doc["routing_journal"]["tallies"]["pairing"]["host"] == 1


def test_inactive_observatory_calls_nothing(monkeypatch):
    """With the observatory off the seams call no recorder: every record_*
    and the recorder's appends are patched to fail."""
    def forbidden(*args, **kwargs):
        raise AssertionError("recorded while off")

    for name in ("record_call", "record_launch", "record_transfer", "record_route",
                 "record_library"):
        monkeypatch.setattr(device_obs.OBSERVATORY, name, forbidden)
    monkeypatch.setattr(spans.RECORDER, "add_complete", forbidden)
    monkeypatch.setattr(spans.RECORDER, "add_instant", forbidden)
    assert not device_obs.is_observing()
    k = _staged_inputs(64, seed=31)
    epoch_vector.jitted_kernels()["inactivity_scores"](
        k["scores"], k["eligible"], k["participating"], 4, 16, False, device="cpu")
    device_obs.route("pairing", "host", "below_threshold")
    device_obs.launch("fused_epoch")
    _device_flags.sweeps_enabled(10)
