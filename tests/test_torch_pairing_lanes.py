"""The crews of csrc/pairing_lanes.h (the u64 build's Miller loop and G2
blinder sum in csrc/pairing.cu) emulated on the host, against the tower,
the native library, the port's plain versions and the reference.

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
    branch, with equal and with rescaled coordinates) and P == -Q.

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
from ethereum_consensus_tpu_torch.ops import fq, pairing  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse fixture)

CSRC = Path(pairing.__file__).resolve().parents[1] / "csrc"
P = fq.P_INT
LANE_COUNTS = (1, 2, 3, 64)
EDGE_BLINDERS = (1, 1 << 127, (1 << 128) - 1)

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

// the first dependent step of each table (-1: none)
extern "C" void check_steps_h(int* out) {
  out[0] = lanes::check_steps(lanes::kMillerDblHost, MILLER_DBL_STEPS, lanes::kMillerSlots);
  out[1] = lanes::check_steps(lanes::kMillerDblAddHost, MILLER_DBL_ADD_STEPS, lanes::kMillerSlots);
  out[2] = lanes::check_steps(lanes::kG2Host, lanes::kG2Steps, lanes::kG2Slots);
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
                 "g2_add_lanes_h", "g2_add_tower_h"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 3
        getattr(lib, name).restype = None
    lib.g2_fold_lanes_h.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.g2_fold_lanes_h.restype = None
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
    out = np.zeros(3, dtype=np.int32)
    lib.check_steps_h(out.ctypes.data)
    assert out.tolist() == [-1, -1, -1]


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
