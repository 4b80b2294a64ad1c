"""The port's effective-balance hysteresis sweep against the reference.

``effective_balance_updates_plain`` (the CUDA kernel's plain version) is
held against the reference's device program ``effective_balance_updates_device``
run on the CPU, on seeded numpy columns that hit every threshold ±1,
balances at and above 2^63, and sums that wrap past 2^64. Exact: the
results are integers. The kernel's per-validator header is built here with
g++ and held against the same reference outputs; the kernel itself runs
only where a CUDA card is present. The port's ``pack_registry`` is held
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

import chain_utils
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
// The kernel's per-validator arithmetic over its (n,) output, on the host.
extern "C" void effective_balance_host(const uint64_t* balances,
                                       const uint64_t* effective, int64_t n,
                                       uint64_t increment, uint64_t max_effective,
                                       uint64_t down, uint64_t up, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = sweeps_core::effective_balance_update(balances[i], effective[i], increment,
                                                   max_effective, down, up);
  }
}
"""


def test_kernel_header_host_build_matches_reference(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    shim = tmp_path / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    lib_path = tmp_path / "libsweeps_core.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
         f"-I{CSRC}", str(shim), "-o", str(lib_path)],
        check=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.effective_balance_host.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
    ]
    lib.effective_balance_host.restype = None
    scalars = port_sweeps.hysteresis_scalars(PortContext.for_mainnet())
    assert scalars == (INC, 32 * INC, DOWN, UP)
    for n in SIZES:
        bal, eff = _columns(n, seed=1000 + n)
        out = np.zeros(n, dtype=np.uint64)
        lib.effective_balance_host(bal.ctypes.data, eff.ctypes.data, n, *scalars,
                                   out.ctypes.data)
        assert np.array_equal(out, _reference(bal, eff))


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1 << 17])
def test_kernel_matches_plain_on_card(cuda, n):
    bal, eff = _columns(n, seed=n)
    ctx = PortContext.for_mainnet()
    b = torch.from_numpy(bal.view(np.int64))
    e = torch.from_numpy(eff.view(np.int64))
    got = port_sweeps.effective_balance_updates(b.to(cuda), e.to(cuda), ctx)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), port_sweeps.effective_balance_updates_plain(b, e, ctx))


def _scrambled_state():
    """A minimal-preset phase0 state past genesis with slashed, exited,
    pending and high-balance validators (reference package)."""
    state, ctx = chain_utils.fresh_genesis(64, "minimal")
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
