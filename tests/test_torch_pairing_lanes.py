"""The crews of csrc/pairing_lanes.h (the u64 build's four pairing kernels
in csrc/pairing.cu) emulated on the host, against the tower, the native
library, the port's plain versions and the reference.

g++ builds the header with a shim. Its host driver runs each crew's
threads one after another inside every step of the schedule, which is the
kernels' result as long as the ops of a step are independent: the step
tables are checked for that first. The lanes are made from a numpy seed:
G1 points [a]G, G2 points [b]G2 (native scalar multiplications), 128-bit
blinders with the edges 1, 2^127 and 2^128 - 1. The reference runs on
JAX's CPU at each lane count:

  - the Miller loop at 1, 2, 3 and 64 lanes against tower::miller_loop,
    the native miller_loop_raw and the reference's miller_loop_batched;
  - [k] Q at the same counts against tower::g2_mul, the plain
    g2_mul_batched and the reference's g2_mul_batched, limb for limb in
    Jacobian form, and their fold (the kernels' pairing: neighbours inside
    64-point blocks, then the block partials) against the plain
    g2_sum_points and the reference's g2_sum_points;
  - the fold's special cases: infinity lanes, a pair P == Q (the doubling
    branch, with equal and with rescaled coordinates) and P == -Q;
  - [k] P in G1, affine, at the same counts against tower::g1_mul with
    tower::fp_inv, the plain g1_mul_affine and the reference's
    g1_mul_batched with _g1_jacobian_to_affine; a zero blinder, a point at
    infinity and both among other lanes; the crew's inverse (a binary
    extended Euclid) against Python's on the edges of the field;
  - the Fq12 product crew, and its fold (the kernel's pairing: 32 values a
    block, then the block partials) at the same counts and at odd counts
    past one block, against tower::fp12_mul in the same order, the plain
    fp12_product, the reference's fp12_product and Python's Fq12.

The kernels themselves run only where a CUDA card is present
(tests/test_torch_pairing.py, chip_smoke.py's pairing phase).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ethereum_consensus_tpu.native import bls as ref_native  # noqa: E402
from ethereum_consensus_tpu.ops import fql as ref_fql  # noqa: E402
from ethereum_consensus_tpu.ops import pairing as ref_pairing  # noqa: E402
from ethereum_consensus_tpu_torch import convert  # noqa: E402
from ethereum_consensus_tpu_torch.crypto.fields import Fq, Fq2, Fq6, Fq12  # noqa: E402
from ethereum_consensus_tpu_torch.ops import fq, pairing  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse fixture)

CSRC = Path(pairing.__file__).resolve().parents[1] / "csrc"
P = fq.P_INT
LANE_COUNTS = (1, 2, 3, 64)
EDGE_BLINDERS = (1, 1 << 127, (1 << 128) - 1)
# Fq12 values of the product's fold: the lane counts, and odd counts past
# one block of 32
FP12_COUNTS = LANE_COUNTS + (33, 97)

_SHIM = r"""
#include <vector>
#include "pairing_lanes.h"
using namespace tower;

static Fp ld(const uint32_t* p) { Fp r; for (int i = 0; i < 12; ++i) r.v[i] = p[i]; return fp381::to_mont(r); }
static void st(uint32_t* p, const Fp& a) { const Fp c = fp381::from_mont(a); for (int i = 0; i < 12; ++i) p[i] = c.v[i]; }
static Fp2 ld2(const uint32_t* p) { return Fp2{ld(p), ld(p + 12)}; }
static void st2(uint32_t* p, const Fp2& a) { st(p, a.c0); st(p + 12, a.c1); }
static void st12(uint32_t* p, const Fp12& a) {
  st2(p, a.c0.a0); st2(p + 24, a.c0.a1); st2(p + 48, a.c0.a2);
  st2(p + 72, a.c1.a0); st2(p + 96, a.c1.a1); st2(p + 120, a.c1.a2);
}
static G2Jac ldj(const uint32_t* p) { return G2Jac{ld2(p), ld2(p + 24), ld2(p + 48)}; }
static void stj(uint32_t* p, const G2Jac& a) { st2(p, a.x); st2(p + 24, a.y); st2(p + 48, a.z); }
static G2Jac affine(const uint32_t* p) { return G2Jac{ld2(p), ld2(p + 24), fp2_one()}; }
static Fp12 ld12(const uint32_t* p) {
  return Fp12{Fp6{ld2(p), ld2(p + 24), ld2(p + 48)}, Fp6{ld2(p + 72), ld2(p + 96), ld2(p + 120)}};
}

// the first dependent step of each table (-1: none)
extern "C" void check_steps_h(int* out) {
  out[0] = lanes::check_steps(lanes::kMillerDblHost, MILLER_DBL_STEPS, lanes::kMillerSlots);
  out[1] = lanes::check_steps(lanes::kMillerDblAddHost, MILLER_DBL_ADD_STEPS, lanes::kMillerSlots);
  out[2] = lanes::check_steps(lanes::kG2Host, lanes::kG2Steps, lanes::kG2Slots);
  out[3] = lanes::check_steps(lanes::fq12::kMulHost, FP12_MUL_STEPS, lanes::fq12::kSlots);
  out[4] = lanes::check_steps(lanes::g1::kG1Host, lanes::g1::kG1Steps, lanes::g1::kSlots);
}
// [k] P, affine: the crew, and the tower with its Fermat inversion
extern "C" void g1_mul_lanes_h(const uint32_t* pt, const uint32_t* k, uint32_t* o) {
  Fp xy[2];
  lanes::g1_mul_affine_host(ld(pt), ld(pt + 12), k, xy);
  st(o, xy[0]);
  st(o + 12, xy[1]);
}
extern "C" void g1_mul_tower_h(const uint32_t* pt, const uint32_t* k, uint32_t* o) {
  const G1Jac acc = g1_mul(G1Jac{ld(pt), ld(pt + 12), fp381::one_mont()}, k);
  const Fp zi = fp_inv(acc.z), zi2 = fp381::sqr(zi);
  st(o, fp381::mul(acc.x, zi2));
  st(o + 12, fp381::mul(acc.y, fp381::mul(zi2, zi)));
}
extern "C" void fp_inverse_h(const uint32_t* a, uint32_t* o) { st(o, lanes::mont_inverse(ld(a))); }
// the Fq12 product's fold over n values, 32 a block: at strides 1, 2, ...,
// 16 each value at a multiple of twice the stride takes the product with
// the value one stride on, where that one lies before n; then the block
// partials the same way until one is left. `crew`: the crews' product,
// else the tower's.
extern "C" void fp12_fold_h(const uint32_t* values, int64_t n, int crew, uint32_t* o) {
  std::vector<Fp12> v;
  for (int64_t i = 0; i < n; ++i) v.push_back(ld12(values + 144 * i));
  do {
    std::vector<Fp12> partials;
    for (std::size_t b = 0; b < v.size(); b += 32) {
      Fp12 s[32];
      for (std::size_t t = 0; b + t < v.size() && t < 32; ++t) s[t] = v[b + t];
      for (std::size_t stride = 1; stride < 32; stride <<= 1)
        for (std::size_t t = 0; b + t + stride < v.size() && t < 32; t += 2 * stride)
          s[t] = crew ? lanes::fp12_mul_host(s[t], s[t + stride]) : fp12_mul(s[t], s[t + stride]);
      partials.push_back(s[0]);
    }
    v = partials;
  } while (v.size() > 1);
  st12(o, v[0]);
}
extern "C" void miller_lanes_h(const uint32_t* g1, const uint32_t* g2, uint32_t* o) {
  st12(o, lanes::miller_loop_host(ld(g1), ld(g1 + 12), ld2(g2), ld2(g2 + 24)));
}
extern "C" void miller_tower_h(const uint32_t* g1, const uint32_t* g2, uint32_t* o) {
  st12(o, miller_loop(ld(g1), ld(g1 + 12), ld2(g2), ld2(g2 + 24)));
}
extern "C" void g2_mul_lanes_h(const uint32_t* pt, const uint32_t* k, uint32_t* o) {
  stj(o, lanes::g2_mul_host(affine(pt), k));
}
extern "C" void g2_mul_tower_h(const uint32_t* pt, const uint32_t* k, uint32_t* o) {
  stj(o, g2_mul(affine(pt), k));
}
extern "C" void g2_add_lanes_h(const uint32_t* p, const uint32_t* q, uint32_t* o) {
  stj(o, lanes::g2_add_host(ldj(p), ldj(q)));
}
extern "C" void g2_add_tower_h(const uint32_t* p, const uint32_t* q, uint32_t* o) {
  stj(o, g2_add(ldj(p), ldj(q)));
}
// the kernels' fold of n Jacobian points on the crews' addition: 64 points
// a block (infinity past n), neighbours at strides 1, 2, ..., 32, then the
// block partials the same way until one is left
extern "C" void g2_fold_lanes_h(const uint32_t* points, int64_t n, uint32_t* o) {
  std::vector<G2Jac> v;
  for (int64_t i = 0; i < n; ++i) v.push_back(ldj(points + 72 * i));
  do {
    std::vector<G2Jac> partials;
    for (std::size_t b = 0; b < v.size(); b += 64) {
      G2Jac s[64];
      for (std::size_t t = 0; t < 64; ++t) s[t] = b + t < v.size() ? v[b + t] : g2_infinity();
      for (int stride = 1; stride < 64; stride <<= 1)
        for (int t = 0; t < 64; t += 2 * stride) s[t] = lanes::g2_add_host(s[t], s[t + stride]);
      partials.push_back(s[0]);
    }
    v = partials;
  } while (v.size() > 1);
  stj(o, v[0]);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("pairing_lanes")
    shim = tmp / "shim.cpp"
    shim.write_text(_SHIM)
    lib_path = tmp / "libpairing_lanes.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
                    f"-I{CSRC}", str(shim), "-o", str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("miller_lanes_h", "miller_tower_h", "g2_mul_lanes_h", "g2_mul_tower_h",
                 "g2_add_lanes_h", "g2_add_tower_h", "g1_mul_lanes_h", "g1_mul_tower_h"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 3
        getattr(lib, name).restype = None
    lib.g2_fold_lanes_h.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.g2_fold_lanes_h.restype = None
    lib.fp12_fold_h.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.fp12_fold_h.restype = None
    lib.fp_inverse_h.argtypes = [ctypes.c_void_p] * 2
    lib.fp_inverse_h.restype = None
    lib.check_steps_h.argtypes = [ctypes.c_void_p]
    lib.check_steps_h.restype = None
    return lib


def _lanes(n: int, seed: int) -> dict:
    """n lanes from a seed: G1 [a]G, G2 [b]G2 as raw affine points, and
    blinders, the first lanes at the edge blinders."""
    rng = np.random.default_rng(seed)
    g1, g2 = ref_native.g1_generator_raw(), ref_native.g2_generator_raw()
    out = {"g1": [], "g2": []}
    for _ in range(n):
        a, b = (int.from_bytes(rng.bytes(31), "big") + 2 for _ in range(2))
        out["g1"].append(ref_native.g1_mul_raw(g1, False, a.to_bytes(32, "big"))[0])
        out["g2"].append(ref_native.g2_msm(g2, b.to_bytes(32, "big"), 1)[0])
    blinders = [int.from_bytes(rng.bytes(16), "big") | 1 for _ in range(n)]
    edges = EDGE_BLINDERS if n >= 3 else EDGE_BLINDERS[-n:]
    out["blinders"] = list(edges) + blinders[len(edges):]
    return out


def _words(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy().view(np.uint32).reshape(-1))


def _call(fn, *inputs, out_words: int) -> list:
    args = [np.ascontiguousarray(a) for a in inputs]
    out = np.zeros(out_words, dtype=np.uint32)
    fn(*(a.ctypes.data for a in args), out.ctypes.data)
    return fq.to_ints(torch.from_numpy(out.view(np.int32)))


def _raw576_ints(raw: bytes) -> list:
    return [int.from_bytes(raw[48 * i : 48 * (i + 1)], "big") for i in range(12)]


def _ref_jac(ints: list) -> ref_fql.LV:
    """Canonical Jacobian ints -> the reference's (N, 3, 2, 24) columns."""
    cols = np.stack([ref_fql.to_mont_cols(v) for v in ints]).reshape(-1, 3, 2, 24)
    return ref_fql.LV(jnp.asarray(cols), ref_fql._CANON_VMAX, 1 << 16)


def _ref_g2_lanes(g2_raws: list, blinders: list) -> list:
    sx, sy = ref_pairing.g2_affine_from_raw(g2_raws)
    one2 = jnp.broadcast_to(
        jnp.asarray(np.stack([ref_fql.to_mont_cols(1), np.zeros(24, np.uint64)])), sy.arr.shape)
    jac = ref_pairing._env(jnp.stack([sx.arr, sy.arr, one2], axis=-3))
    return convert.lv_to_ints(np.asarray(ref_pairing.g2_mul_batched(jac, blinders).arr))


def _fold(lib, ints: list) -> list:
    points = _words(fq.from_ints(ints))
    out = np.zeros(72, dtype=np.uint32)
    lib.g2_fold_lanes_h(points.ctypes.data, len(ints) // 6, out.ctypes.data)
    return fq.to_ints(torch.from_numpy(out.view(np.int32)))


def test_step_tables_are_independent(lib):
    """No op of a step writes a slot that another op of the step (or the
    same op) reads, and no two write one slot: the emulation's order of the
    threads cannot change a step's result."""
    out = np.zeros(5, dtype=np.int32)
    lib.check_steps_h(out.ctypes.data)
    assert out.tolist() == [-1] * 5


@pytest.mark.parametrize("n", LANE_COUNTS)
def test_miller_crews_match_tower_native_and_reference(lib, n):
    lanes = _lanes(n, seed=90 + n)
    xp, yp = pairing.g1_affine_from_raw(lanes["g1"], "cpu")
    xq, yq = pairing.g2_affine_from_raw(lanes["g2"], "cpu")
    g1 = _words(torch.stack([xp, yp], dim=1)).reshape(n, 24)
    g2 = _words(torch.stack([xq, yq], dim=1)).reshape(n, 48)
    got = []
    for i in range(n):
        crew = _call(lib.miller_lanes_h, g1[i], g2[i], out_words=144)
        assert crew == _call(lib.miller_tower_h, g1[i], g2[i], out_words=144)
        assert crew == _raw576_ints(ref_native.miller_loop_raw(lanes["g1"][i], lanes["g2"][i]))
        got += crew
    rx, ry = ref_pairing.g1_affine_from_raw(lanes["g1"])
    qx, qy = ref_pairing.g2_affine_from_raw(lanes["g2"])
    ref = ref_pairing.miller_loop_batched(rx.arr, ry.arr, qx.arr, qy.arr)
    assert got == convert.lv_to_ints(np.asarray(ref))


@pytest.mark.parametrize("n", LANE_COUNTS)
def test_g2_crews_and_fold_match_tower_plain_and_reference(lib, n):
    lanes = _lanes(n, seed=190 + n)
    sig = pairing.g2_affine_from_raw(lanes["g2"], "cpu")
    pts = _words(torch.stack(sig, dim=1)).reshape(n, 48)
    words = _words(pairing.scalar_words(lanes["blinders"], "cpu")).reshape(n, 4)
    got = []
    for i in range(n):
        crew = _call(lib.g2_mul_lanes_h, pts[i], words[i], out_words=72)
        assert crew == _call(lib.g2_mul_tower_h, pts[i], words[i], out_words=72)
        got += crew
    plain = fq.to_ints(pairing.g2_mul_batched(sig, lanes["blinders"]))
    assert got == plain
    assert got == _ref_g2_lanes(lanes["g2"], lanes["blinders"])
    total = _fold(lib, got)
    assert total == fq.to_ints(pairing.g2_sum_points_plain(
        fq.from_ints(got).reshape(n, 3, 2, 12)))
    assert total == convert.lv_to_ints(np.asarray(ref_pairing.g2_sum_points(_ref_jac(got)).arr))


def test_g2_crew_of_a_zero_blinder_is_infinity(lib):
    lanes = _lanes(1, seed=7)
    pt = _words(torch.stack(pairing.g2_affine_from_raw(lanes["g2"], "cpu"), dim=1))
    zero = np.zeros(4, dtype=np.uint32)
    assert _call(lib.g2_mul_lanes_h, pt, zero, out_words=72) == [0] * 6


def _neg(point: list) -> list:
    """-P of canonical Jacobian ints (x0, x1, y0, y1, z0, z1)."""
    return point[:2] + [(P - v) % P for v in point[2:4]] + point[4:]


def _rescaled(point: list, lam: int) -> list:
    """The same point as (lam^2 x, lam^3 y, lam z), lam in Fp."""
    def mul(a, k):
        return [(v * k) % P for v in a]
    return mul(point[:2], lam * lam) + mul(point[2:4], lam**3) + mul(point[4:], lam)


@pytest.fixture(scope="module")
def jacobian_lanes(lib):
    """Three Jacobian lanes [k_i] Q_i (z != 1) from the crews."""
    lanes = _lanes(3, seed=11)
    pts = _words(torch.stack(pairing.g2_affine_from_raw(lanes["g2"], "cpu"), dim=1)).reshape(3, 48)
    words = _words(pairing.scalar_words(lanes["blinders"], "cpu")).reshape(3, 4)
    return [_call(lib.g2_mul_lanes_h, pts[i], words[i], out_words=72) for i in range(3)]


@pytest.mark.parametrize("case", ["infinity_lanes", "equal", "rescaled_equal", "negated",
                                  "mixed"])
def test_g2_fold_special_cases_match_tower_plain_and_reference(lib, jacobian_lanes, case):
    a, b, c = jacobian_lanes
    inf = [0] * 6
    points = {
        "infinity_lanes": [inf, a, inf, inf, b],
        "equal": [a, a],
        "rescaled_equal": [a, _rescaled(a, 5)],
        "negated": [a, _neg(a)],
        "mixed": [a, _rescaled(a, 7), b, _neg(b), inf, c, c],
    }[case]
    ints = [v for p in points for v in p]
    # the addition alone, on the first pair
    p0, p1 = (_words(fq.from_ints(p)) for p in points[:2])
    assert (_call(lib.g2_add_lanes_h, p0, p1, out_words=72)
            == _call(lib.g2_add_tower_h, p0, p1, out_words=72))
    total = _fold(lib, ints)
    assert total == fq.to_ints(pairing.g2_sum_points_plain(
        fq.from_ints(ints).reshape(len(points), 3, 2, 12)))
    assert total == convert.lv_to_ints(np.asarray(ref_pairing.g2_sum_points(_ref_jac(ints)).arr))
    if case == "negated":
        assert total == inf


# ---------------------------------------------------------------------------
# G1: [k] P, affine
# ---------------------------------------------------------------------------


def _g1_crews(lib, raws: list, blinders: list) -> list:
    """Each lane through the crew, held against the tower's lane; the
    canonical affine ints of all lanes."""
    xy = pairing.g1_affine_from_raw(raws, "cpu")
    pts = _words(torch.stack(xy, dim=1)).reshape(len(raws), 24)
    words = _words(pairing.scalar_words(blinders, "cpu")).reshape(len(raws), 4)
    got = []
    for i in range(len(raws)):
        crew = _call(lib.g1_mul_lanes_h, pts[i], words[i], out_words=24)
        assert crew == _call(lib.g1_mul_tower_h, pts[i], words[i], out_words=24)
        got += crew
    return got


def _g1_plain(raws: list, blinders: list) -> list:
    x, y = pairing.g1_mul_batched(pairing.g1_affine_from_raw(raws, "cpu"), blinders)
    return fq.to_ints(torch.stack([x, y], dim=1))


def _g1_reference(raws: list, blinders: list) -> list:
    blinded = ref_pairing.g1_mul_batched(ref_pairing._g1_jac_from_affine_raws(raws), blinders)
    xp, yp = ref_pairing._g1_jacobian_to_affine(blinded.arr)
    return convert.lv_to_ints(np.stack([np.asarray(xp), np.asarray(yp)], axis=1))


@pytest.mark.parametrize("n", LANE_COUNTS)
def test_g1_crews_match_tower_plain_and_reference(lib, n):
    lanes = _lanes(n, seed=290 + n)
    got = _g1_crews(lib, lanes["g1"], lanes["blinders"])
    assert got == _g1_plain(lanes["g1"], lanes["blinders"])
    assert got == _g1_reference(lanes["g1"], lanes["blinders"])


INFINITY_G1 = b"\x00" * 96
# (0, 2) lies on y^2 = x^3 + 4 and has order 3 (outside the r-torsion): the
# mixed addition meets h = 0, at [2]P = -P (r != 0, infinity) and at
# [4]P = P (r = 0, the doubling)
ORDER_THREE_G1 = b"\x00" * 48 + (2).to_bytes(48, "big")


@pytest.mark.parametrize("case", ["zero_blinder", "infinity_point", "among_other_lanes",
                                  "blinder_one", "blinder_max", "order_three_cancels",
                                  "order_three_doubles"])
def test_g1_crew_edge_cases_match_tower_plain_and_reference(lib, case):
    """A zero blinder or a point at infinity (all zero) gives (0, 0): z = 0
    at the end, whose inverse is 0 (the plain version inverts every lane's
    z in one batch, a zero among nonzero ones). Blinder 1 (the batch's
    first) runs no doubling, 2^128 - 1 every addition; the order-3 point
    takes the addition's h = 0 branches."""
    lanes = _lanes(3, seed=17)
    raws, blinders, zero_lanes = {
        "zero_blinder": ([lanes["g1"][0]], [0], [0]),
        "infinity_point": ([INFINITY_G1], [lanes["blinders"][2]], [0]),
        "among_other_lanes": ([lanes["g1"][0], lanes["g1"][1], INFINITY_G1, lanes["g1"][2]],
                              [lanes["blinders"][2], 0, 5, 1], [1, 2]),
        "blinder_one": ([lanes["g1"][1]], [1], []),
        "blinder_max": ([lanes["g1"][2], lanes["g1"][0]], [(1 << 128) - 1, 1], []),
        "order_three_cancels": ([ORDER_THREE_G1, ORDER_THREE_G1], [3, 6], [0, 1]),
        "order_three_doubles": ([ORDER_THREE_G1, ORDER_THREE_G1], [5, 7], []),
    }[case]
    got = _g1_crews(lib, raws, blinders)
    assert got == _g1_plain(raws, blinders)
    assert got == _g1_reference(raws, blinders)
    assert [i for i in range(len(raws)) if got[2 * i : 2 * i + 2] == [0, 0]] == zero_lanes
    if case == "blinder_one":
        assert got == fq.to_ints(torch.stack(pairing.g1_affine_from_raw(raws, "cpu"), dim=1))
    if case == "order_three_doubles":  # [5]P = [2]P = -P and [7]P = P
        x, y = int.from_bytes(ORDER_THREE_G1[:48], "big"), 2
        assert got == [x, P - y, x, y]


@pytest.mark.parametrize("value", [0, 1, 2, P - 1, (P + 1) // 2, 1 << 380, 0x1234567890ABCDEF])
def test_crew_inverse_matches_python(lib, value):
    """The binary extended Euclid, on Montgomery values in and out: 0 for 0."""
    a = _words(fq.from_ints([value]))
    out = np.zeros(12, dtype=np.uint32)
    lib.fp_inverse_h(a.ctypes.data, out.ctypes.data)
    assert fq.to_ints(torch.from_numpy(out.view(np.int32))) == [pow(value, P - 2, P)]


# ---------------------------------------------------------------------------
# The Fq12 product
# ---------------------------------------------------------------------------


def _fq12(ints: list) -> Fq12:
    f2 = [Fq2(Fq(ints[2 * i]), Fq(ints[2 * i + 1])) for i in range(6)]
    return Fq12(Fq6(*f2[:3]), Fq6(*f2[3:]))


def _fq12_ints(value: Fq12) -> list:
    return [c for c6 in (value.c0, value.c1) for c2 in (c6.c0, c6.c1, c6.c2)
            for c in (c2.c0.n, c2.c1.n)]


@pytest.mark.parametrize("n", FP12_COUNTS)
def test_fp12_crew_fold_matches_tower_plain_reference_and_python(lib, n):
    rng = np.random.default_rng(490 + n)
    ints = [int.from_bytes(rng.bytes(48), "big") % P for _ in range(12 * n)]
    values = _words(fq.from_ints(ints))
    got = []
    for crew in (1, 0):
        out = np.zeros(144, dtype=np.uint32)
        lib.fp12_fold_h(values.ctypes.data, n, crew, out.ctypes.data)
        got.append(fq.to_ints(torch.from_numpy(out.view(np.int32))))
    assert got[0] == got[1]
    assert got[0] == fq.to_ints(pairing.fp12_product_plain(
        fq.from_ints(ints).reshape(n, 2, 3, 2, 12)))
    cols = np.stack([ref_fql.to_mont_cols(v) for v in ints]).reshape(n, 2, 3, 2, 24)
    assert got[0] == convert.lv_to_ints(np.asarray(ref_pairing.fp12_product(jnp.asarray(cols))))
    want = _fq12(ints[:12])
    for i in range(1, n):
        want = want * _fq12(ints[12 * i : 12 * (i + 1)])
    assert got[0] == _fq12_ints(want)
