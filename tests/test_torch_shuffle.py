"""The port's committee shuffle against the reference package.

``shuffled_indices_plain`` (the CUDA kernel's plain version) is held
against the reference's per-index spec function ``compute_shuffled_index``
and against its whole-list device program ``shuffled_indices_device``, run
on the CPU as the reference's own tests run it. Exact: the results are
integers. The kernel's schedule (csrc/shuffle_core.h: each round's row, or
the half of it that the round's pivot allows, staged in a CTA's ring of
stage buffers, a span larger than a buffer looked up a window at a time)
is built here with g++ and run on the host, at the kernel's own plan and
at small budgets that cut each span into 1, 2 or 4 windows, and held
against the spec function; the kernel itself runs only where a CUDA card
is present.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ethereum_consensus_tpu.config import Context as RefContext
from ethereum_consensus_tpu.models.phase0 import helpers as ref_helpers
from ethereum_consensus_tpu.ops import shuffle as ref_shuffle
from ethereum_consensus_tpu_torch import ops
from ethereum_consensus_tpu_torch.config import Context as PortContext
from ethereum_consensus_tpu_torch.models.phase0 import helpers as port_helpers
from ethereum_consensus_tpu_torch.ops import shuffle as port_shuffle
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CSRC = Path(port_shuffle.__file__).resolve().parents[1] / "csrc"
COUNTS = [1, 2, 255, 256, 257, 1000, (1 << 15) + 3]
PRESETS = {"minimal": RefContext.for_minimal, "mainnet": RefContext.for_mainnet}


def _seed(count: int, preset: str) -> bytes:
    return np.random.default_rng([count, len(preset)]).bytes(32)


def _sample(count: int) -> list:
    rng = np.random.default_rng(count)
    picks = rng.integers(0, count, size=min(count, 48)).tolist()
    return sorted({0, count - 1, count // 2, *picks})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("count", COUNTS)
def test_plain_matches_reference(count, preset):
    ctx = PRESETS[preset]()
    seed = _seed(count, preset)
    rounds = ctx.SHUFFLE_ROUND_COUNT
    got = port_shuffle.shuffled_indices_plain(count, seed, rounds).numpy()
    assert got.shape == (count,) and got.dtype == np.int64
    device = np.asarray(ref_shuffle.shuffled_indices_device(count, seed, rounds))
    assert (got == device.astype(np.int64)).all()
    checked = range(count) if count <= 1000 else _sample(count)
    for i in checked:
        assert got[i] == ref_helpers.compute_shuffled_index(i, count, seed, ctx), i


@pytest.mark.parametrize("routed", [False, True], ids=["host", "device_routed"])
def test_committee_permutation_matches_reference(routed, monkeypatch):
    """The cached whole-set permutation behind every committee, on the host
    map and through the kernel's route (its plain version on the CPU)."""
    calls = []
    plain = port_shuffle.shuffle_plain
    monkeypatch.setattr(port_shuffle, "shuffle_plain",
                        lambda *args: calls.append(1) or plain(*args))
    ops.uninstall()
    if routed:
        ops.install(device="cpu", shuffle_min_n=1, bls_agg_min_n=1)
    try:
        ctx = PortContext.for_minimal()
        seed = _seed(777, "minimal")
        indices = tuple(range(3, 3 * 777 + 3, 3))  # a sparse active set
        got = port_helpers.shuffled_active_array(indices, seed, ctx)
        want = ref_helpers.compute_shuffled_indices(list(indices), seed, RefContext.for_minimal())
        assert got.tolist() == list(want)
        assert port_helpers.compute_committee(indices, seed, 2, 4, ctx) == list(
            want[2 * 777 // 4 : 3 * 777 // 4])
        assert len(calls) == int(routed)
    finally:
        ops.uninstall()


def test_tables_match_reference_precompute():
    seed = _seed(1000, "mainnet")
    pivots, sources = port_shuffle.shuffle_sources(1000, seed, 90)
    ref_pivots, ref_sources = ref_shuffle.shuffle_sources(1000, seed, 90)
    assert (pivots == ref_pivots.astype(np.int64)).all()
    assert (sources == ref_sources).all()


def test_dispatcher_takes_plain_version_for_cpu_tensor():
    pivots, sources = port_shuffle.shuffle_sources(300, b"\x01" * 32, 10)
    p, s = torch.from_numpy(pivots), torch.from_numpy(sources)
    before = port_shuffle.launch_count
    assert torch.equal(port_shuffle.shuffle(p, s, 300), port_shuffle.shuffle_plain(p, s, 300))
    assert port_shuffle.launch_count == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    pivots, sources = port_shuffle.shuffle_sources(300, b"\x02" * 32, 10)
    p, s = torch.from_numpy(pivots), torch.from_numpy(sources)
    with pytest.raises(TypeError):
        port_shuffle.shuffle(p.to(torch.int32), s, 300)
    with pytest.raises(ValueError):
        port_shuffle.shuffle(p, s[:, :32], 300)
    with pytest.raises(ValueError):
        port_shuffle.shuffle(p[:5], s, 300)
    with pytest.raises(ValueError, match="pivots must lie"):
        port_shuffle.shuffle(p + 300, s, 300)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_shuffle.shuffle_cuda(p, s, 300)
    with pytest.raises(ValueError):
        port_shuffle.shuffle_sources(0, b"\x02" * 32, 10)


_HOST_SHIM = r"""
#include "shuffle_core.h"
// The kernel's schedule on the host: the plan for `buffers` stage buffers
// in `budget` shared bytes a CTA, `blocks` CTAs of `threads` threads with
// `per` indices each. plan_out: windows a span, chunks a stage, stages, and
// 1 if every copy stayed inside its window and its row in 16-byte pieces.
extern "C" void shuffle_host(const int64_t* pivots, const uint8_t* sources, int64_t row_bytes,
                             int rounds, int64_t count, int buffers, int64_t budget, int blocks,
                             int threads, int per, int64_t* out, int* plan_out) {
  const shuffle_core::Plan p =
      shuffle_core::make_plan(count, rounds, row_bytes, buffers, budget);
  plan_out[0] = p.parts;
  plan_out[1] = p.per_stage;
  plan_out[2] = p.stages;
  plan_out[3] = shuffle_core::shuffle_host(p, pivots, sources, blocks, threads, per, out);
}

// The largest span of any pivot below count, and the bound the plan takes
extern "C" void spans(int64_t count, int64_t row_bytes, int64_t* out) {
  int64_t most = 0;
  for (int64_t pivot = 0; pivot < count; ++pivot) {
    const shuffle_core::Span s = shuffle_core::span_of(pivot, count, row_bytes);
    if (s.a_len + s.b_len > most) most = s.a_len + s.b_len;
  }
  out[0] = most;
  out[1] = shuffle_core::max_span(count, row_bytes);
}
"""
# the kernel's plan constants (csrc/shuffle.cu): 200 KB of stage buffers a
# CTA in 3 buffers, 512 index threads a CTA; rows of 16 KB or more go as
# half rows (csrc/shuffle_core.h kHalfRowMin)
KERNEL_BUDGET, KERNEL_BUFFERS, KERNEL_THREADS = 200 * 1024, 3, 512
HALF_ROW_MIN = 16384


@pytest.fixture(scope="module")
def schedule_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("shuffle_core")
    shim = tmp / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    lib_path = tmp / "libshuffle_core.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
         f"-I{CSRC}", str(shim), "-o", str(lib_path)],
        check=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.shuffle_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.shuffle_host.restype = None
    lib.spans.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.spans.restype = None
    return lib


def _host_schedule(lib, count, seed, rounds, buffers, budget, blocks, threads, per,
                   row_bytes=None):
    """The schedule on the host; ``row_bytes`` pads the source rows (zeros
    past the bytes the count reads) to that width."""
    pivots, sources = port_shuffle.shuffle_sources(count, seed, rounds)
    if row_bytes is not None:
        sources = np.pad(sources, ((0, 0), (0, row_bytes - sources.shape[1])))
    out = np.zeros(count, dtype=np.int64)
    plan = np.zeros(4, dtype=np.int32)
    lib.shuffle_host(pivots.ctypes.data, sources.ctypes.data, sources.shape[1], rounds, count,
                     buffers, budget, blocks, threads, per, out.ctypes.data, plan.ctypes.data)
    assert plan[3] == 1, "a copy left its window or its row, or was not in 16-byte pieces"
    return out, plan[:3].tolist()


def test_kernel_header_host_build_matches_spec(schedule_lib):
    """The kernel's schedule at its own plan (budget, buffers, threads) on
    the host: stages of many rounds at 2^15 and a grid of one CTA at small
    counts."""
    ctx = RefContext.for_mainnet()
    rounds = ctx.SHUFFLE_ROUND_COUNT
    for count in (1, 257, 1000, (1 << 15) + 3):
        seed = _seed(count, "mainnet")
        blocks = -(-count // KERNEL_THREADS)
        out, _ = _host_schedule(schedule_lib, count, seed, rounds, KERNEL_BUFFERS, KERNEL_BUDGET,
                                blocks, KERNEL_THREADS, 1)
        assert (out == port_shuffle.shuffled_indices_plain(count, seed, rounds).numpy()).all()
        for i in _sample(count):
            assert out[i] == ref_helpers.compute_shuffled_index(i, count, seed, ctx)


@pytest.mark.parametrize("count", [1, 2, 7, 8, 9, 255, 256, 257, 4099, 1 << 15])
@pytest.mark.parametrize("half", [False, True], ids=["whole_rows", "half_rows"])
def test_span_bound_holds_at_every_pivot(schedule_lib, count, half):
    """The part of a row a round reads (its span: the row, or the half that
    its pivot allows) is never longer than the bound the plan sizes windows
    by; rows of 16 KB or more take half rows, so the half-row case pads
    small rows up to that."""
    row_bytes = 32 * ((count + 255) // 256)
    if half:
        row_bytes = max(row_bytes, HALF_ROW_MIN)
    out = np.zeros(2, dtype=np.int64)
    schedule_lib.spans(count, row_bytes, out.ctypes.data)
    assert 0 < out[0] <= out[1]


@pytest.mark.parametrize("buffers", [2, 3])
@pytest.mark.parametrize("half", [False, True], ids=["whole_rows", "half_rows"])
@pytest.mark.parametrize("parts", [1, 2, 4], ids=lambda k: f"{k}_windows")
@pytest.mark.parametrize("count", [1, 255, 256, 257, (1 << 12) + 3, 1 << 15])
def test_split_schedule_matches_spec(schedule_lib, count, parts, half, buffers):
    """Each round's span (its whole row, or, with the rows padded to 16 KB,
    the half its pivot allows) split over 1, 2 or 4 windows of a small
    buffer in a ring of 2 or 3, stages of one to many rounds, and batches
    (8 indices a thread of 32 threads, 2 CTAs)."""
    ctx = RefContext.for_mainnet()
    rounds = ctx.SHUFFLE_ROUND_COUNT
    seed = _seed(count, "mainnet")
    row_bytes = max(32 * ((count + 255) // 256), HALF_ROW_MIN if half else 0)
    bound = np.zeros(2, dtype=np.int64)
    schedule_lib.spans(count, row_bytes, bound.ctypes.data)
    span = (int(bound[1]) + 15) // 16 * 16
    window = ((span + parts - 1) // parts + 15) // 16 * 16
    out, (got_parts, per_stage, stages) = _host_schedule(
        schedule_lib, count, seed, rounds, buffers, buffers * window, 2, 32, 8, row_bytes)
    assert got_parts == -(-span // window) and stages * per_stage >= rounds * got_parts
    assert (out == port_shuffle.shuffled_indices_plain(count, seed, rounds).numpy()).all()
    for i in _sample(count) if count > 300 else range(count):
        assert out[i] == ref_helpers.compute_shuffled_index(i, count, seed, ctx)


@pytest.mark.parametrize("count", [1, 255, 256, 257, 1 << 15, (1 << 21) + 5])
def test_kernel_matches_plain_on_card(cuda, count):
    seed = _seed(count, "mainnet")
    got = port_shuffle.shuffled_indices(count, seed, 90, device=cuda)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), port_shuffle.shuffled_indices_plain(count, seed, 90))
