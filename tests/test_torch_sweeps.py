"""The port's effective-balance hysteresis sweep against the reference.

``effective_balance_updates_plain`` (the CUDA kernel's plain version) is
held against the reference's device program ``effective_balance_updates_device``
run on the CPU, on seeded numpy columns that hit every threshold ±1,
balances at and above 2^63, and sums that wrap past 2^64. Exact: the
results are integers. The kernel's header is built here with g++ and held
against the same reference outputs: the update with the floor divided, and
the kernel's schedule (``sweeps_core::effective_balance_host``: the warp
chunks, then one a thread, the floor on the increment's reciprocal) at n in
{0, 1, 255, 256, 257, 4099, 65541, 2^17} on the launcher's grid and on
grids smaller than the work, on columns offset by 1 to 7 rows, at every
threshold edge and at increments 1, 2, 2^32 + 1, 2^63 + 1 and 10^9; the
kernel itself runs only where a CUDA card is present. The port's ``pack_registry`` is held
against the reference's on a scrambled state.
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_genesis
from ethereum_consensus_tpu.config import Context as RefContext
from ethereum_consensus_tpu.models.phase0 import containers as ref_containers
from ethereum_consensus_tpu.ops import registry_columns as ref_registry_columns
from ethereum_consensus_tpu.ops import sweeps as ref_sweeps
from ethereum_consensus_tpu.primitives import FAR_FUTURE_EPOCH
from ethereum_consensus_tpu_torch.config import Context as PortContext
from ethereum_consensus_tpu_torch.models.phase0 import containers as port_containers
from ethereum_consensus_tpu_torch.ops import registry_columns as port_registry_columns
from ethereum_consensus_tpu_torch.ops import sweeps as port_sweeps
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CSRC = Path(port_sweeps.__file__).resolve().parents[1] / "csrc"
SIZES = [0, 1, 255, 257, 4099]
INC = 10**9
DOWN = INC // 4
UP = 5 * INC // 4
TOP = 1 << 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _columns(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(balances, effective) uint64 columns: random words, every threshold
    ±1, balances at and above 2^63, and sums that wrap past 2^64."""
    rng = np.random.default_rng(seed)
    eff = rng.integers(0, 33, n, dtype=np.uint64) * np.uint64(INC)
    bal = eff + rng.integers(0, 2 * INC, n, dtype=np.uint64)
    bal = np.where(rng.integers(0, 2, n) == 1, bal, eff - rng.integers(0, INC, n, dtype=np.uint64))
    kind = rng.integers(0, 8, n)
    near = rng.integers(-1, 2, n).astype(np.int64).view(np.uint64)  # -1, 0, +1 as words
    words = rng.integers(0, TOP, n, dtype=np.uint64, endpoint=False)
    high = rng.integers(1 << 63, TOP, n, dtype=np.uint64, endpoint=False)
    small = rng.integers(0, UP + 2, n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        cases = [
            (bal, eff),                                     # realistic
            (words, rng.integers(0, TOP, n, dtype=np.uint64)),  # any words
            (eff - np.uint64(DOWN) + near, eff),            # downward threshold ±1
            (eff + np.uint64(UP) + near, eff),              # upward threshold ±1
            (high, eff),                                    # balances >= 2^63
            (np.uint64(TOP - 1) - small, eff),              # bal + down wraps
            (bal, np.uint64(TOP - 1) - small),              # eff + up wraps
            (high, high ^ near),                            # both high
        ]
    out_bal = np.empty(n, dtype=np.uint64)
    out_eff = np.empty(n, dtype=np.uint64)
    for k, (b, e) in enumerate(cases):
        sel = kind == k
        out_bal[sel] = b[sel]
        out_eff[sel] = e[sel]
    return out_bal, out_eff


def _reference(bal: np.ndarray, eff: np.ndarray, ctx=None) -> np.ndarray:
    packed = {"balances": bal, "effective_balance": eff}
    return np.asarray(
        ref_sweeps.effective_balance_updates_device(packed, ctx or RefContext.for_mainnet()),
        dtype=np.uint64,
    )


def _plain(bal: np.ndarray, eff: np.ndarray, ctx=None) -> np.ndarray:
    out = port_sweeps.effective_balance_updates_plain(
        torch.from_numpy(bal.view(np.int64)), torch.from_numpy(eff.view(np.int64)),
        ctx or PortContext.for_mainnet(),
    )
    return out.numpy().view(np.uint64)


@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_reference(n):
    bal, eff = _columns(n, seed=n)
    want = _reference(bal, eff)
    got = _plain(bal, eff)
    assert got.shape == (n,) and got.dtype == np.uint64
    assert np.array_equal(got, want)
    if n >= 257:
        # the columns really cross the thresholds both ways and wrap
        assert (got != eff).any() and (got == eff).any()
        assert (bal >= np.uint64(1 << 63)).any()


def test_plain_matches_reference_at_every_threshold():
    """Each threshold and the cap, exactly and one either side, for a grid
    of effective balances including the top of the u64 range."""
    effs = [0, 1, INC - 1, INC, 16 * INC, 32 * INC, 33 * INC, (1 << 63) - 1, 1 << 63, TOP - 1]
    bal, eff = [], []
    for e in effs:
        for base in (e - DOWN, e + UP, e, 32 * INC, 32 * INC + UP, TOP - DOWN, TOP - UP):
            for d in (-1, 0, 1):
                bal.append((base + d) % TOP)
                eff.append(e)
    bal = np.array(bal, dtype=np.uint64)
    eff = np.array(eff, dtype=np.uint64)
    assert np.array_equal(_plain(bal, eff), _reference(bal, eff))


def test_plain_matches_reference_without_a_cap():
    """Under the mainnet cap a balance of 2^63 or more always lands on the
    cap; with the cap at 2^64 - 1 and an odd increment its remainder shows
    in the output."""
    ctx = SimpleNamespace(
        EFFECTIVE_BALANCE_INCREMENT=10**9 + 7, MAX_EFFECTIVE_BALANCE=TOP - 1,
        HYSTERESIS_QUOTIENT=4, HYSTERESIS_DOWNWARD_MULTIPLIER=1,
        HYSTERESIS_UPWARD_MULTIPLIER=5,
    )
    bal, eff = _columns(4099, seed=11)
    got = _plain(bal, eff, ctx)
    assert np.array_equal(got, _reference(bal, eff, ctx))
    assert (got[bal >= np.uint64(1 << 63)] != np.uint64(TOP - 1)).any()


def test_device_entry_point_on_cpu_matches_reference():
    bal, eff = _columns(4099, seed=7)
    got = port_sweeps.effective_balance_updates_device(
        {"balances": bal, "effective_balance": eff}, PortContext.for_mainnet(), device="cpu"
    )
    assert got.dtype == np.uint64
    assert np.array_equal(got, _reference(bal, eff))


def test_wrappers_refuse_bad_inputs():
    ctx = PortContext.for_mainnet()
    words = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(TypeError):
        port_sweeps.effective_balance_updates(words.to(torch.int32), words, ctx)
    with pytest.raises(ValueError):
        port_sweeps.effective_balance_updates(words, words[:5], ctx)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_sweeps.effective_balance_updates_cuda(words, words, ctx)


_HOST_SHIM = r"""
#include "sweeps_core.h"
// The kernel's per-validator arithmetic over its (n,) output, on the host:
// the divided form.
extern "C" void effective_balance_host(const uint64_t* balances,
                                       const uint64_t* effective, int64_t n,
                                       uint64_t increment, uint64_t max_effective,
                                       uint64_t down, uint64_t up, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = sweeps_core::effective_balance_update(balances[i], effective[i], increment,
                                                   max_effective, down, up);
  }
}

// The kernel's schedule on the columns as they lie in memory (the
// launcher's alignment test picks the path), the floor on the increment's
// reciprocal: on `grid` blocks, or (0) the launcher's grid. shape receives
// the grid and the whole warp chunks; visits counts each validator's visits.
extern "C" void effective_balance_schedule_host(const uint64_t* balances,
                                                const uint64_t* effective, int64_t n,
                                                uint64_t increment, uint64_t max_effective,
                                                uint64_t down, uint64_t up, int64_t grid,
                                                uint64_t* out, uint8_t* visits,
                                                int64_t* shape) {
  const sweeps_core::BalanceColumns c = sweeps_core::balance_columns(balances, effective, n, out);
  if (grid == 0) grid = warp_chunks::chunk_grid(n);
  shape[0] = grid;
  shape[1] = c.chunks;
  sweeps_core::effective_balance_host(
      c, sweeps_core::hysteresis(increment, max_effective, down, up), grid, visits);
}
"""

_P, _I64, _U64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("sweeps_core")
    shim = tmp / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    lib_path = tmp / "libsweeps_core.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
         f"-I{CSRC}", str(shim), "-o", str(lib_path)],
        check=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.effective_balance_host.argtypes = [_P, _P, _I64] + [_U64] * 4 + [_P]
    lib.effective_balance_host.restype = None
    lib.effective_balance_schedule_host.argtypes = [_P, _P, _I64] + [_U64] * 4 + [_I64] + [_P] * 3
    lib.effective_balance_schedule_host.restype = None
    return lib


def test_kernel_header_host_build_matches_reference(core):
    scalars = port_sweeps.hysteresis_scalars(PortContext.for_mainnet())
    assert scalars == (INC, 32 * INC, DOWN, UP)
    for n in SIZES:
        bal, eff = _columns(n, seed=1000 + n)
        out = np.zeros(n, dtype=np.uint64)
        core.effective_balance_host(bal.ctypes.data, eff.ctypes.data, n, *scalars,
                                    out.ctypes.data)
        assert np.array_equal(out, _reference(bal, eff))


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


def _run_schedule(core, bal, eff, scalars: tuple, grid: int = 0) -> dict:
    n = len(bal)
    out = np.zeros(n, np.uint64)
    visits = np.zeros(max(n, 1), np.uint8)
    shape = np.zeros(2, np.int64)
    core.effective_balance_schedule_host(bal.ctypes.data, eff.ctypes.data, n, *scalars, grid,
                                         out.ctypes.data, visits.ctypes.data, shape.ctypes.data)
    return {"out": out, "visits": visits[:n], "grid": int(shape[0]), "chunks": int(shape[1])}


def _divided(core, bal, eff, scalars: tuple) -> np.ndarray:
    out = np.zeros(len(bal), np.uint64)
    core.effective_balance_host(bal.ctypes.data, eff.ctypes.data, len(bal), *scalars,
                                out.ctypes.data)
    return out


MAINNET_SCALARS = (INC, 32 * INC, DOWN, UP)
SCHEDULE_SIZES = [0, 1, 255, 256, 257, 4099, 65541, 1 << 17]


# grid 0: the launcher's; 1 and 3: fewer blocks than the work wants
@pytest.mark.parametrize("n", SCHEDULE_SIZES)
def test_header_schedule_matches_reference(core, n):
    """The kernel's partition run on the host (whole warp chunks, then one a
    thread; the floor on the increment's reciprocal) against the
    reference's _effective_balance_updates, every validator visited once."""
    bal, eff = _placed(_columns(n, seed=2000 + n), 0)
    want = _reference(bal, eff)
    for grid in (0, 1, 3):
        got = _run_schedule(core, bal, eff, MAINNET_SCALARS, grid)
        assert got["chunks"] == n // 256
        assert np.array_equal(got["out"], want) and np.all(got["visits"] == 1), grid
    if n >= 4099:
        assert (want != eff).any() and (want == eff).any()


@pytest.mark.parametrize("offset", range(1, 8))
def test_header_schedule_offset_columns(core, offset):
    """Columns offset by 1..7 rows: the words 16-byte aligned only at even
    offsets, so the validators go one a thread at odd offsets, on the
    launcher's grid and on one block."""
    n = 65541
    bal, eff = _placed(_columns(n, seed=2100), offset)
    want = _reference(bal, eff)
    for grid in (0, 1):
        got = _run_schedule(core, bal, eff, MAINNET_SCALARS, grid)
        assert got["chunks"] == (n // 256 if offset % 2 == 0 else 0)
        assert np.array_equal(got["out"], want) and np.all(got["visits"] == 1)


def test_header_schedule_at_every_threshold_edge(core):
    """Each threshold and the cap, exactly and one either side, and
    balances and effective balances near 2^64 whose sums with a threshold
    wrap, through the schedule on the vector path and one a thread."""
    effs = [0, 1, INC - 1, INC, 16 * INC, 32 * INC, 33 * INC, (1 << 63) - 1, 1 << 63,
            TOP - DOWN, TOP - UP, TOP - 1]
    bal, eff = [], []
    for e in effs:
        for base in (e - DOWN, e + UP, e, 32 * INC, 32 * INC + UP, TOP - DOWN, TOP - UP, TOP - 1):
            for d in (-1, 0, 1):
                bal.append((base + d) % TOP)
                eff.append(e)
    bal, eff = np.array(bal, dtype=np.uint64), np.array(eff, dtype=np.uint64)
    reps = -(-4099 // len(bal))
    bal, eff = np.tile(bal, reps)[:4099], np.tile(eff, reps)[:4099]
    want = _reference(bal, eff)
    for offset in (0, 1):
        placed = _placed([bal, eff], offset)
        got = _run_schedule(core, *placed, MAINNET_SCALARS)
        assert got["chunks"] == (4099 // 256 if offset == 0 else 0)
        assert np.array_equal(got["out"], want) and np.all(got["visits"] == 1)
    assert (want != eff).any() and (want == eff).any()


# increment -> the cap of the edge context (hysteresis quotient 4,
# multipliers 1 and 5): the mainnet increment, and increments whose
# reciprocals take each of the division's shifts
EDGE_INCREMENTS = {"mainnet": (INC, 32 * INC), "one": (1, 32), "two": (2, 64),
                   "two_32_plus_1": ((1 << 32) + 1, TOP - 1),
                   "two_63_plus_1": ((1 << 63) + 1, TOP - 1)}


@pytest.mark.parametrize("increment", EDGE_INCREMENTS)
def test_header_schedule_on_edge_increments(core, increment):
    """The schedule's floor on the increment's reciprocal, bit-equal to the
    divided form and to the reference, at the mainnet increment and at
    increments 1, 2, 2^32 + 1 and 2^63 + 1, on balances over the whole u64
    range and at each threshold of the increment."""
    inc, cap = EDGE_INCREMENTS[increment]
    ctx = SimpleNamespace(EFFECTIVE_BALANCE_INCREMENT=inc, MAX_EFFECTIVE_BALANCE=cap,
                          HYSTERESIS_QUOTIENT=4, HYSTERESIS_DOWNWARD_MULTIPLIER=1,
                          HYSTERESIS_UPWARD_MULTIPLIER=5)
    scalars = (inc, cap, inc // 4 % TOP, 5 * (inc // 4) % TOP)
    rng = np.random.default_rng(inc % 1000)
    n = 4099
    eff = rng.integers(0, TOP, n, dtype=np.uint64, endpoint=False)
    bal = rng.integers(0, TOP, n, dtype=np.uint64, endpoint=False)
    with np.errstate(over="ignore"):
        near = rng.integers(-1, 2, n).astype(np.int64).view(np.uint64)
        edges = np.where(rng.random(n) < 0.5, eff - np.uint64(scalars[2]),
                         eff + np.uint64(scalars[3])) + near
    bal = np.where(rng.random(n) < 0.5, edges, bal)
    want = _reference(bal, eff, ctx)
    got = _run_schedule(core, *_placed([bal, eff], 0), scalars)
    assert np.array_equal(got["out"], want) and np.all(got["visits"] == 1)
    assert np.array_equal(_divided(core, bal, eff, scalars), want)
    assert (want != eff).any()


def test_header_schedule_grid(core):
    """The launcher's grid: a chunk a warp (2,048 validators a block: 512
    blocks at 2^20, 128 at 2^18), one block for fewer than 2,049 validators
    or none."""
    def grid(n):
        bal, eff = _placed(_columns(n, seed=3), 0)
        return _run_schedule(core, bal, eff, MAINNET_SCALARS)["grid"]
    assert grid(1 << 20) == 512 and grid(1 << 18) == 128
    assert grid(2049) == 2 and grid(2048) == grid(300) == grid(1) == grid(0) == 1


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1 << 17])
def test_kernel_matches_plain_on_card(cuda, n):
    bal, eff = _columns(n, seed=n)
    ctx = PortContext.for_mainnet()
    b = torch.from_numpy(bal.view(np.int64))
    e = torch.from_numpy(eff.view(np.int64))
    got = port_sweeps.effective_balance_updates(b.to(cuda), e.to(cuda), ctx)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), port_sweeps.effective_balance_updates_plain(b, e, ctx))
    # one and two rows in: off the warp chunks, then on them again
    for offset in (1, 2):
        got = port_sweeps.effective_balance_updates(b.to(cuda)[offset:], e.to(cuda)[offset:], ctx)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), port_sweeps.effective_balance_updates_plain(
            b[offset:], e[offset:], ctx))


def _scrambled_state():
    """A minimal-preset phase0 state past genesis with slashed, exited,
    pending and high-balance validators (reference package)."""
    state, ctx = torch_genesis.fresh_genesis(64, "minimal")
    rng = random.Random(5)
    for i in rng.sample(range(64), 20):
        v = state.validators[i]
        v.slashed = rng.random() < 0.5
        v.activation_epoch = rng.choice([0, 1, 3, FAR_FUTURE_EPOCH])
        v.exit_epoch = rng.choice([2, 4, FAR_FUTURE_EPOCH])
        v.withdrawable_epoch = rng.choice([3, 5, FAR_FUTURE_EPOCH])
        v.effective_balance = rng.randrange(0, 33) * INC
        state.balances[i] = rng.randrange(0, TOP)
    return state, ctx


@pytest.mark.parametrize("previous_epoch", [0, 2, 4])
def test_pack_registry_matches_reference(previous_epoch):
    state, ctx = _scrambled_state()
    data = ref_containers.build(ctx.preset).BeaconState.serialize(state)
    port_state = port_containers.build(
        PortContext.for_minimal().preset
    ).BeaconState.deserialize(data)
    want = ref_registry_columns.pack_registry(state, previous_epoch)
    got = port_sweeps.pack_registry(port_state, previous_epoch)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key
    # phase0 states carry no participation flags: every flag mask is empty
    for flag in range(3):
        assert not port_registry_columns.unslashed_flag_mask(got, flag).any()
        assert np.array_equal(port_registry_columns.unslashed_flag_mask(got, flag),
                              ref_registry_columns.unslashed_flag_mask(want, flag))
