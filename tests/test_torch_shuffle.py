"""The port's committee shuffle against the reference package.

``shuffled_indices_plain`` (the CUDA kernel's plain version) is held
against the reference's per-index spec function ``compute_shuffled_index``
and against its whole-list device program ``shuffled_indices_device``, run
on the CPU as the reference's own tests run it. Exact: the results are
integers. The kernel's per-index header is built here with g++ and held
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
// The kernel's per-index arithmetic over its (count,) output, on the host.
extern "C" void shuffle_host(const int64_t* pivots, const uint8_t* sources,
                             int64_t row_bytes, int rounds, int64_t count,
                             int64_t* out) {
  for (int64_t i = 0; i < count; ++i) {
    out[i] = static_cast<int64_t>(shuffle_core::shuffled_index(
        static_cast<uint64_t>(i), static_cast<uint64_t>(count), rounds, pivots,
        sources, row_bytes));
  }
}
"""


def test_kernel_header_host_build_matches_spec(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    shim = tmp_path / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    lib_path = tmp_path / "libshuffle_core.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
         f"-I{CSRC}", str(shim), "-o", str(lib_path)],
        check=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.shuffle_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
    lib.shuffle_host.restype = None
    ctx = RefContext.for_mainnet()
    for count in (1, 257, 1000, (1 << 15) + 3):
        seed = _seed(count, "mainnet")
        pivots, sources = port_shuffle.shuffle_sources(count, seed, ctx.SHUFFLE_ROUND_COUNT)
        out = np.zeros(count, dtype=np.int64)
        lib.shuffle_host(pivots.ctypes.data, sources.ctypes.data, sources.shape[1],
                         ctx.SHUFFLE_ROUND_COUNT, count, out.ctypes.data)
        assert (out == port_shuffle.shuffled_indices_plain(
            count, seed, ctx.SHUFFLE_ROUND_COUNT).numpy()).all()
        for i in _sample(count):
            assert out[i] == ref_helpers.compute_shuffled_index(i, count, seed, ctx)


@pytest.mark.parametrize("count", [1, 255, 256, 257, 1 << 15])
def test_kernel_matches_plain_on_card(cuda, count):
    seed = _seed(count, "mainnet")
    got = port_shuffle.shuffled_indices(count, seed, 90, device=cuda)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), port_shuffle.shuffled_indices_plain(count, seed, 90))
