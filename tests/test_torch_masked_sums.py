"""The masked sums of the epoch passes against the reference.

K2 (the epoch step's four sums, ``ops/chain_step.py epoch_step_sums``) and
the B9-epoch flag sums (``ops/epoch.py fused_flag_sums``) are one kernel,
``csrc/masked_sums.h``, at four and three sums. The reference computes them
inside its shard_map bodies and psums them: ``parallel/step.py``'s epoch
sweep step (the active-current total, then the three flag sums) and
``parallel/epoch.py _fused_sharded`` (the three flag sums). One subprocess
on a virtual 4-device JAX CPU mesh (``conftest.run_in_cpu_mesh``) runs both
on seeded numpy columns made the same way here, with ``jax.lax.psum``
wrapped so that every psum'd value is reported through a host callback;
those values are the reference's sums.

The header is built here with g++ and its host schedule
(``masked_sums_host``: block by block, thread by thread, step by step, the
vector and one-a-thread paths, then the finish in block order) held against
those sums, with the plain versions, exactly: at n in {0, 1, 7, 8, 9, 4099,
65541}, on the launcher's grid and on grids smaller than the work (a thread
takes several steps), on the kernel's blocks and on blocks of 64 threads,
on columns offset by 1 to 7 rows (the one-a-thread path), with sums that
wrap past 2^64, a flag sum below one increment, every flag set, none set
and every validator slashed. The kernels themselves run only where a CUDA card is present.
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
from ethereum_consensus_tpu_torch.ops import chain_step as port_step_ops
from ethereum_consensus_tpu_torch.ops import epoch as port_epoch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CSRC = Path(port_epoch.__file__).resolve().parents[1] / "csrc"
SIZES = (0, 1, 7, 8, 9, 4099, 65541)
# variants at 4099 validators beside the seeded mix at every size
VARIANTS = ("all_flags", "no_flags", "all_slashed", "below_increment")
CASES = [f"mixed_{n}" for n in SIZES] + [f"{v}_4099" for v in VARIANTS]
# an H100's co-resident blocks (4 an SM) and SMs, as the launcher finds them
FIT, SMS = 528, 132

INPUTS = r"""
import numpy as np

M64 = (1 << 64) - 1
INC = 10**9


def sum_columns(case):
    # eff, part, slashed, active_prev, active_cur of a case "<variant>_<n>":
    # effective balances over the whole u64 range, so that the sums wrap
    variant, n = case.rsplit("_", 1)
    n = int(n)
    rng = np.random.default_rng(1000 + n)
    eff = rng.integers(0, M64, n, dtype=np.uint64, endpoint=True)
    part = rng.integers(0, 8, n, dtype=np.uint8)
    slashed = rng.random(n) < 0.1
    active_prev = rng.random(n) < 0.9
    active_cur = rng.random(n) < 0.9
    if variant == "all_flags":
        part[:] = 7
        slashed[:] = False
        active_prev[:] = active_cur[:] = True
    elif variant == "no_flags":
        part[:] = 0
    elif variant == "all_slashed":
        slashed[:] = True
    elif variant == "below_increment":
        # flag 0's sum wraps to 5, below one increment (row 3: flag 0 only)
        part[3], slashed[3], active_prev[3] = 1, False, True
        eff[3] = 0
        mask = active_prev & ~slashed & ((part & 1) == 1)
        eff[3] = np.uint64((5 - sum(int(e) for e in eff[mask])) & M64)
    return eff, part, slashed, active_prev, active_cur
"""
exec(INPUTS)  # sum_columns, M64, INC  # noqa: S102

REFERENCE = INPUTS + r"""
import functools
import json
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

# every psum'd value, by its place among the psums of one trace, reported
# from each shard through a host callback
_psum = jax.lax.psum
_seen = {}
_slot = [0]


def _record(k, value):
    _seen.setdefault(k, set()).add(int(value))


def _reporting_psum(x, axis_name, **kwargs):
    out = _psum(x, axis_name, **kwargs)
    k = _slot[0]
    _slot[0] += 1
    jax.debug.callback(functools.partial(_record, k), out)
    return out


jax.lax.psum = _reporting_psum

from ethereum_consensus_tpu.config import Context
from ethereum_consensus_tpu.parallel import chip_mesh
from ethereum_consensus_tpu.parallel.epoch import _fused_sharded
from ethereum_consensus_tpu.parallel.step import make_epoch_sweep_step


def psums(fn, count):
    _seen.clear()
    _slot[0] = 0
    jax.block_until_ready(fn())
    jax.effects_barrier()
    values = [_seen[k] for k in range(count)]
    assert all(len(v) == 1 for v in values), values
    return [v.pop() for v in values]


mesh = chip_mesh(4)
step = make_epoch_sweep_step(mesh, Context.for_mainnet(), is_leaking=False,
                             check_score_bound=False)
fused = _fused_sharded(mesh, 4, 16, (14, 26, 14), 64, False, 2, 1)
out = {}
for case in CASES:
    cols = sum_columns(case)
    n = len(cols[0])
    padded = max(4, -(-n // 4) * 4)  # the shards' rows; zero rows add nothing
    eff, part, slashed, active_prev, active_cur = (
        np.concatenate([c, np.zeros(padded - n, c.dtype)]) for c in cols)
    zeros = np.zeros(padded, np.uint64)
    # the step's psums: the active-current total, then the three flag sums
    total, *flags = psums(lambda: step(*(jnp.asarray(c) for c in (
        zeros, eff, part, slashed, active_prev, active_cur, active_prev, zeros))), 4)
    # the fused pass's: the three flag sums, then the wrap census
    fused_flags = psums(lambda: fused(*(jnp.asarray(c) for c in (
        zeros, eff, part, slashed, active_prev, active_prev, zeros)),
        jnp.uint64(INC), jnp.uint64(1), jnp.uint64(1), jnp.uint64(1)), 4)[:3]
    out[case] = {"step": [*flags, total], "fused": fused_flags}
print("REFERENCE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    out = run_in_cpu_mesh(f"CASES = {CASES!r}\n" + REFERENCE, n_devices=4)
    line = next(x for x in out.splitlines() if x.startswith("REFERENCE "))
    return json.loads(line[len("REFERENCE "):])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _exact_sums(case) -> list:
    """The four sums in Python integers, unwrapped."""
    eff, part, slashed, active_prev, active_cur = sum_columns(case)
    unslashed = active_prev & ~slashed
    flags = [sum(int(e) for e in eff[unslashed & (((part >> f) & 1) == 1)]) for f in range(3)]
    return flags + [sum(int(e) for e in eff[active_cur])]


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _tensors(cols) -> list:
    return [torch.from_numpy(c.view(np.int64) if c.dtype == np.uint64 else c) for c in cols]


@pytest.mark.parametrize("case", CASES)
def test_plain_versions_match_reference(reference, case):
    cols = _tensors(sum_columns(case))
    want = reference[case]
    got = port_step_ops.epoch_step_sums_plain(*cols).tolist()
    assert [v & M64 for v in got] == want["step"]
    got = port_epoch.fused_flag_sums_plain(*cols[:4]).tolist()
    assert [v & M64 for v in got] == want["fused"] == want["step"][:3]
    exact = _exact_sums(case)
    assert [v & M64 for v in exact] == want["step"]


def test_cases_reach_the_edges(reference):
    """The seeded sums pass 2^64; flag 0's sum lands below one increment; the
    all-flag, no-flag and all-slashed cases give what they say."""
    assert all(v >= 1 << 64 for v in _exact_sums("mixed_65541"))
    assert reference["below_increment_4099"]["step"][0] == 5 < INC
    assert reference["no_flags_4099"]["fused"] == [0, 0, 0]
    assert reference["all_slashed_4099"]["fused"] == [0, 0, 0]
    assert reference["all_slashed_4099"]["step"][3] != 0
    flags = reference["all_flags_4099"]["step"]
    assert flags[0] == flags[1] == flags[2] == flags[3]


# ---------------------------------------------------------------------------
# the kernel's schedule, built with g++
# ---------------------------------------------------------------------------

_HOST_SHIM = r"""
#include <stdint.h>
#include "masked_sums.h"

template <int K>
static void run(const uint8_t* const* cols, int64_t n, int threads, int64_t grid, int64_t fit,
                int64_t sms, uint64_t* sums, uint8_t* visits, int64_t* shape) {
  const masked_sums::Columns c = masked_sums::make_columns(
      cols[0], cols[1], cols[2], cols[3], K == 4 ? cols[4] : nullptr, n);
  if (grid == 0) grid = masked_sums::grid_for(c, threads, fit, sms, 2048);
  shape[0] = grid;
  shape[1] = c.steps;
  masked_sums::masked_sums_host<K>(c, grid, threads, sums, visits);
}

// The kernel's schedule at K sums and blocks of `threads` on the columns (eff, part, slashed, active_prev, active_cur) as
// they lie in memory (the launcher's alignment test picks the path): on
// `grid` blocks, or (0) the launcher's grid for `fit` co-resident blocks and
// `sms` SMs. shape receives the grid and the vector path's steps; visits
// counts each validator's visits.
extern "C" void sums_host(int k, const uint8_t* const* cols, int64_t n, int threads,
                          int64_t grid, int64_t fit, int64_t sms, uint64_t* sums,
                          uint8_t* visits, int64_t* shape) {
  if (k == 3) run<3>(cols, n, threads, grid, fit, sms, sums, visits, shape);
  if (k == 4) run<4>(cols, n, threads, grid, fit, sms, sums, visits, shape);
}

extern "C" int sums_step() { return masked_sums::kStep; }
extern "C" int sums_threads() { return masked_sums::kThreads; }
"""

_P, _I64 = ctypes.c_void_p, ctypes.c_int64


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("masked_sums")
    shim = tmp / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    lib_path = tmp / "libmasked_sums.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
         f"-I{CSRC}", str(shim), "-o", str(lib_path)],
        check=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.sums_host.argtypes = ([ctypes.c_int, _P, _I64, ctypes.c_int]
                              + [_I64] * 3 + [_P] * 3)
    lib.sums_host.restype = None
    lib.sums_step.restype = ctypes.c_int
    lib.sums_threads.restype = ctypes.c_int
    return lib


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


def _run_host(core, k: int, cols, grid: int = 0, threads: int = 0, fit: int = FIT,
              sms: int = SMS) -> dict:
    """The schedule on blocks of `threads` (0: the kernel's)."""
    n = len(cols[0])
    cols = [c.view(np.uint8) if c.dtype == np.bool_ else c for c in cols]
    pointers = (ctypes.c_void_p * 5)(*(c.ctypes.data for c in cols))
    sums = np.zeros(4, np.uint64)
    visits = np.zeros(max(n, 1), np.uint8)
    shape = np.zeros(2, np.int64)
    core.sums_host(k, ctypes.addressof(pointers), n, threads or core.sums_threads(), grid, fit,
                   sms, sums.ctypes.data, visits.ctypes.data, shape.ctypes.data)
    return {"sums": [int(x) for x in sums[:k]], "visits": visits[:n], "grid": int(shape[0]),
            "steps": int(shape[1])}


def test_header_kernel_shape(core):
    """The program's step width and block, as the card measured them best
    (tools/sums_forms.py) and as the grid expectations below assume; blocks
    of 64 are held below as well."""
    assert core.sums_step() == 8 and core.sums_threads() == 256


# grid 0: the launcher's grid; 1 and 3: fewer blocks than the work wants;
# threads 0: the kernel's block, 64: a narrower one (more blocks, ranges cut
# shorter)
@pytest.mark.parametrize("threads", [0, 64])
@pytest.mark.parametrize("grid", [0, 1, 3])
@pytest.mark.parametrize("case", CASES)
def test_header_schedule_matches_reference(reference, core, case, grid, threads):
    cols = _placed(sum_columns(case), 0)
    n = len(cols[0])
    want = reference[case]
    four = _run_host(core, 4, cols, grid, threads)
    three = _run_host(core, 3, cols, grid, threads)
    assert four["sums"] == want["step"]
    assert three["sums"] == want["fused"]
    for got in (four, three):
        assert got["steps"] == n // core.sums_step()
        assert np.all(got["visits"] == 1)  # every validator visited once


@pytest.mark.parametrize("offset", range(1, 8))
def test_header_offset_columns_take_one_a_thread(reference, core, offset):
    """Columns offset by 1..7 rows: some column misses the vector path's
    alignment, so every validator goes one a thread, on the launcher's grid
    and on one block."""
    case = "mixed_65541"
    cols = _placed(sum_columns(case), offset)
    want = reference[case]
    for grid in (0, 1):
        four = _run_host(core, 4, cols, grid)
        three = _run_host(core, 3, cols, grid)
        assert four["steps"] == three["steps"] == 0
        assert four["sums"] == want["step"] and three["sums"] == want["fused"]
        assert np.all(four["visits"] == 1) and np.all(three["visits"] == 1)
    # eight rows in, every column is aligned again
    assert _run_host(core, 4, _placed(sum_columns(case), 8))["steps"] == 65541 // 8


def test_header_grid_spreads_the_work(core):
    """The launcher's grid: a step a thread at 2^20 (512 blocks, one wave of
    528 co-resident), every SM busy at 2^18, the co-resident blocks off the
    vector path, one block for no validators, and a thread several steps
    where the card holds fewer blocks."""
    n = 1 << 20
    cols = _placed([np.zeros(n, np.uint64)] + [np.zeros(n, np.uint8)] * 4, 0)
    assert _run_host(core, 4, cols)["grid"] == 512
    assert _run_host(core, 4, [c[: n // 4] for c in cols])["grid"] == SMS
    assert _run_host(core, 4, [c[1:] for c in cols])["grid"] == FIT
    assert _run_host(core, 4, [c[:0] for c in cols])["grid"] == 1
    small = _run_host(core, 4, cols, fit=8, sms=8)
    assert small["grid"] == 8 and np.all(small["visits"] == 1)


@pytest.mark.parametrize("n", [1, 9, 4099, (1 << 17) + 5])
def test_kernels_match_plain_on_card(cuda, n):
    cols = _tensors(sum_columns(f"mixed_{n}"))
    on_card = [c.to(cuda) for c in cols]
    assert torch.equal(port_step_ops.epoch_step_sums(*on_card).cpu(),
                       port_step_ops.epoch_step_sums_plain(*cols))
    assert torch.equal(port_epoch.fused_flag_sums(*on_card[:4]).cpu(),
                       port_epoch.fused_flag_sums_plain(*cols[:4]))
    # one row in: every column off the vector path
    assert torch.equal(port_step_ops.epoch_step_sums(*(c[1:] for c in on_card)).cpu(),
                       port_step_ops.epoch_step_sums_plain(*(c[1:] for c in cols)))
    assert torch.equal(port_epoch.fused_flag_sums(*(c[1:] for c in on_card[:4])).cpu(),
                       port_epoch.fused_flag_sums_plain(*(c[1:] for c in cols[:4])))
