"""The port's G1 set sums (pubkey aggregation) against the reference package.

``g1_sum_sets_plain`` (the CUDA kernel's plain version) on raw96 keys from
the reference's native ``SecretKey(i).public_key()`` is held against the
reference's native aggregation and its device program
``ops.pairing.g1_sum_sets`` (run on the CPU). Exact: affine coordinates
are compared as bytes. The edge cases are an infinity lane, a key repeated
in a set (doubling), P with -P (infinity), a set of infinity lanes only,
an empty set, and ragged widths. The kernel's field and point header is
built here with g++ and held against Python integers and the native point
addition; its schedule (csrc/g1_sum_lanes.h: a lane a crew of 4 threads on
tables of independent Fp steps; the chains 32 lanes a block, then a fold
block of 64 crews a set) runs on the host and is held against the plain
version limb for limb, also with chain blocks whose lanes straddle two
sets. The kernel itself runs only where a CUDA card is present.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ethereum_consensus_tpu.crypto import bls as ref_bls
from ethereum_consensus_tpu.native import bls as ref_native
from ethereum_consensus_tpu.ops import pairing as ref_pairing
from ethereum_consensus_tpu_torch.ops import g1 as port_g1
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CSRC = Path(port_g1.__file__).resolve().parents[1] / "csrc"
P = port_g1.P_INT
R = 1 << 384
INF = b"\x00" * 96


def _key(i: int) -> bytes:
    return ref_bls.SecretKey(i + 1).public_key().raw_uncompressed()


def _neg(raw: bytes) -> bytes:
    y = int.from_bytes(raw[48:], "big")
    return raw[:48] + ((P - y) % P).to_bytes(48, "big")


def _native_sum(raws) -> "tuple[bytes, bool]":
    acc, inf = INF, True
    for raw in raws:
        acc, inf = ref_native.g1_add_raw(acc, inf, raw, not any(raw))
    return (INF if inf else acc), inf


@pytest.fixture(scope="module")
def keys():
    return [_key(i) for i in range(24)]


def _edge_sets(keys):
    return [
        keys[:1],                              # one key
        keys[1:4],                             # three
        keys[4:12],                            # eight
        [keys[12], INF, keys[13]],             # an infinity lane
        [keys[14], keys[14]],                  # doubling
        [keys[15], keys[16], keys[15]],        # doubling after an addition
        [keys[17], _neg(keys[17])],            # P + -P
        [keys[18], keys[19], _neg(keys[18])],  # P + Q - P
        [INF, INF, INF],                       # only infinity
        [],                                    # empty
        keys[:23],                             # the widest, ragged against the rest
    ]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_plain_matches_native_on_edge_sets(keys):
    sets = _edge_sets(keys)
    got = port_g1.aggregate_pubkey_sets_device(sets, device="cpu")
    assert got == [_native_sum(s) for s in sets]


def test_plain_matches_native_aggregate_public_keys(keys):
    sets = [keys[:5], keys[5:6], keys[6:24]]
    for (raw, inf), s in zip(port_g1.aggregate_pubkey_sets_device(sets, device="cpu"), sets):
        rc, agg = ref_native.aggregate_public_keys([ref_native.g1_compress_raw(k) for k in s])
        assert rc == 0 and not inf
        assert ref_native.g1_compress_raw(raw) == agg


@pytest.mark.parametrize("widths", [(1,), (3,), (8,), (1, 3, 8)], ids=str)
def test_plain_matches_reference_device_program(keys, widths):
    sets, at = [], 0
    for w in widths:
        sets.append(keys[at : at + w])
        at += w
    sets.append([keys[0], _neg(keys[0])] + keys[1:2])
    assert port_g1.aggregate_pubkey_sets_device(sets, device="cpu") == ref_pairing.g1_sum_sets(sets)


def test_more_keys_than_lanes(keys):
    """Sets wider than the kernel's 128 threads: each lane adds several
    keys before the fold."""
    big = [keys[i % 24] for i in range(300)] + [INF] * 7
    sets = [big, big[:129], keys[:3]]
    assert port_g1.aggregate_pubkey_sets_device(sets, device="cpu") == [_native_sum(s) for s in sets]


def test_strict_twin_and_empty_input(keys):
    assert port_g1.aggregate_pubkeys_device(keys[:6], device="cpu") == _native_sum(keys[:6])
    assert port_g1.aggregate_pubkeys_device([], device="cpu") == (INF, True)
    assert port_g1.aggregate_pubkey_sets_device([], device="cpu") == []


def test_dispatcher_takes_plain_version_for_cpu_tensor(keys):
    points, offsets = port_g1.sets_to_csr([keys[:3], keys[3:4]])
    before = port_g1.launch_count
    assert torch.equal(port_g1.g1_sum_sets(points, offsets),
                       port_g1.g1_sum_sets_plain(points, offsets))
    assert port_g1.launch_count == before


def test_wrapper_rejects_what_the_kernel_does_not_take(keys):
    points, offsets = port_g1.sets_to_csr([keys[:3]])
    with pytest.raises(TypeError):
        port_g1.g1_sum_sets(points.to(torch.int64), offsets)
    with pytest.raises(TypeError):
        port_g1.g1_sum_sets(points, offsets.to(torch.int32))
    with pytest.raises(ValueError):
        port_g1.g1_sum_sets(points.reshape(-1, 4, 6), offsets)
    with pytest.raises(ValueError):
        port_g1.g1_sum_sets(points, offsets[:1])
    with pytest.raises(ValueError, match="offsets must rise"):
        port_g1.g1_sum_sets(points, torch.tensor([0, 4], dtype=torch.int64))
    with pytest.raises(ValueError, match="offsets must rise"):
        port_g1.g1_sum_sets(points, torch.tensor([0, 2, 1, 3], dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_g1.g1_sum_sets_cuda(points, offsets)


_HOST_SHIM = r"""
#include "fp381_core.h"
#include "g1_sum_lanes.h"
using namespace fp381;

static Fp load(const uint32_t* p) { Fp r; for (int i = 0; i < kLimbs; ++i) r.v[i] = p[i]; return r; }
static void store(uint32_t* p, const Fp& a) { for (int i = 0; i < kLimbs; ++i) p[i] = a.v[i]; }
static void store_jac(uint32_t* o, const G1Jac& j) {
  const G1Jac c = g1_to_canonical(j);
  store(o, c.x); store(o + kLimbs, c.y); store(o + 2 * kLimbs, c.z);
}

extern "C" void fp_mul(const uint32_t* a, const uint32_t* b, uint32_t* o) { store(o, mul(load(a), load(b))); }
extern "C" void fp_add(const uint32_t* a, const uint32_t* b, uint32_t* o) { store(o, add(load(a), load(b))); }
extern "C" void fp_sub(const uint32_t* a, const uint32_t* b, uint32_t* o) { store(o, sub(load(a), load(b))); }

// affine (x, y) canonical limbs -> canonical Jacobian limbs of p + q
extern "C" void g1_add_affine(const uint32_t* p, const uint32_t* q, uint32_t* o) {
  store_jac(o, g1_add(g1_from_affine(load(p), load(p + kLimbs)),
                      g1_from_affine(load(q), load(q + kLimbs))));
}

// The kernels' schedule on the host (g1_sum_lanes.h): chain_lanes lanes a
// chain block, a block's crews and a crew's ops in turn.
extern "C" void g1_sum_sets_host(const uint32_t* pts, const int64_t* offsets, int64_t n_sets,
                                 int chain_lanes, uint32_t* out) {
  g1sum::sum_sets_host(pts, offsets, n_sets, chain_lanes, out);
}

// The first step of the schedule's table whose ops are not independent, or -1
extern "C" int check_steps_h() {
  return lanes::check_steps(g1sum::kTableHost, g1sum::kSteps, g1sum::kSlots);
}
"""


@pytest.fixture(scope="module")
def core_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("fp381")
    shim = tmp / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    lib_path = tmp / "libfp381_core.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
         f"-I{CSRC}", str(shim), "-o", str(lib_path)],
        check=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    for name in ("fp_mul", "fp_add", "fp_sub", "g1_add_affine"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 3
        getattr(lib, name).restype = None
    lib.g1_sum_sets_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.g1_sum_sets_host.restype = None
    lib.check_steps_h.restype = ctypes.c_int
    return lib


def _limbs(x: int) -> np.ndarray:
    return np.array([(x >> (32 * i)) & 0xFFFFFFFF for i in range(12)], dtype=np.uint32)


def _int(limbs: np.ndarray) -> int:
    return sum(int(v) << (32 * i) for i, v in enumerate(limbs))


def _field_values():
    rng = np.random.default_rng(381)
    rand = [int.from_bytes(rng.bytes(48), "big") % P for _ in range(200)]
    return [0, 1, 2, P - 1, P - 2, (1 << 383) % P, R % P] + rand


def test_field_header_matches_python_integers(core_lib):
    values = _field_values()
    r_inv = pow(R, -1, P)
    out = np.zeros(12, dtype=np.uint32)
    for a, b in zip(values, reversed(values)):
        la, lb = _limbs(a), _limbs(b)
        core_lib.fp_mul(la.ctypes.data, lb.ctypes.data, out.ctypes.data)
        assert _int(out) == a * b * r_inv % P
        core_lib.fp_add(la.ctypes.data, lb.ctypes.data, out.ctypes.data)
        assert _int(out) == (a + b) % P
        core_lib.fp_sub(la.ctypes.data, lb.ctypes.data, out.ctypes.data)
        assert _int(out) == (a - b) % P


def _affine_limbs(raw: bytes) -> np.ndarray:
    return port_g1.points_from_raw([raw]).numpy().view(np.uint32).reshape(24).copy()


def test_point_header_matches_native_addition(core_lib, keys):
    cases = [
        (keys[0], keys[1]), (keys[2], keys[2]), (keys[3], _neg(keys[3])),
        (keys[4], INF), (INF, keys[5]), (INF, INF), (_neg(keys[6]), keys[7]),
    ]
    out = np.zeros(36, dtype=np.uint32)
    for a, b in cases:
        la, lb = _affine_limbs(a), _affine_limbs(b)
        core_lib.g1_add_affine(la.ctypes.data, lb.ctypes.data, out.ctypes.data)
        got = port_g1.jacobian_to_affine(torch.from_numpy(out.view(np.int32).reshape(1, 3, 12)))
        raw, inf = ref_native.g1_add_raw(a, not any(a), b, not any(b))
        assert got == [((INF if inf else raw), inf)]


# lanes a chain block of the kernel (csrc/g1_sum_lanes.h kChainLanes)
CHAIN_LANES = 32


def _host_schedule(lib, sets, chain_lanes=CHAIN_LANES) -> "tuple[np.ndarray, np.ndarray]":
    """The schedule's (S, 3, 12) sums on the host, and the plain version's."""
    points, offsets = port_g1.sets_to_csr(sets)
    out = np.zeros((len(sets), 3, 12), dtype=np.uint32)
    pts = np.ascontiguousarray(points.numpy())
    offs = np.ascontiguousarray(offsets.numpy())
    lib.g1_sum_sets_host(pts.ctypes.data, offs.ctypes.data, len(sets), chain_lanes,
                         out.ctypes.data)
    return out, port_g1.g1_sum_sets_plain(points, offsets).numpy().view(np.uint32)


def test_schedule_table_is_independent(core_lib):
    """No op of a step writes a slot that another op of the step (or the
    same op) reads, and no two write one slot: the host's order of a crew's
    threads cannot change a step's result."""
    assert core_lib.check_steps_h() == -1


def test_kernel_schedule_on_host_matches_plain_limb_for_limb(core_lib, keys):
    big = [keys[i % 24] for i in range(260)]
    sets = _edge_sets(keys) + [big, big[:128] + [_neg(keys[0])]]
    out, plain = _host_schedule(core_lib, sets)
    assert (out == plain).all()


@pytest.mark.parametrize("size", [1, 127, 128, 129, 300, 1000])
def test_kernel_schedule_on_host_at_set_sizes(core_lib, keys, size):
    """One set of `size` keys beside the edge sets: lanes with no key, one
    key, and up to eight, the repeated keys giving equal partial sums (the
    doubling) inside the chains and the fold."""
    sets = _edge_sets(keys) + [[keys[i % 24] for i in range(size)]]
    out, plain = _host_schedule(core_lib, sets)
    assert (out == plain).all()


@pytest.mark.parametrize("chain_lanes", [48, 80])
def test_kernel_schedule_with_two_sets_in_a_chain_block(core_lib, keys, chain_lanes):
    """Chain blocks whose lanes straddle sets (48 or 80 lanes a block, where
    the kernel takes 32, a divisor of a set's 128): each lane still finds
    its set, so the sums do not change."""
    a = [keys[i % 24] for i in range(300)]
    b = [keys[(5 * i + 3) % 24] for i in range(129)] + [_neg(keys[3])]
    sets = [a, keys[:3], b]
    out, plain = _host_schedule(core_lib, sets, chain_lanes)
    assert (out == plain).all()


def test_kernel_matches_plain_on_card(cuda, keys):
    big = [keys[i % 24] for i in range(1000)]
    sets = _edge_sets(keys) + [big]
    points, offsets = port_g1.sets_to_csr(sets)
    got = port_g1.g1_sum_sets(points.to(cuda), offsets.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), port_g1.g1_sum_sets_plain(points, offsets))
