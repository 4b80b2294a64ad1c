"""The Montgomery reduction of ``csrc/fp_mma.h`` as products, built with g++
and run as its host emulation, against the CIOS product, the plain ``mont7r``
(ops/fq8.py) and the reference's ``ops/fq8.py:300 mont7r``.

Every comparison is exact. Operand groups: the edges 0, 1, p - 1, R mod p,
2^380 - 1, 2^378 - 1 (digits 0 .. 53 all 127) and 2^381 - 1, each against
each; pairs whose x = a * b mod 2^384 has every digit at its largest (all
127, digit 54 at 63: every lane's carry propagates); pairs whose
m = x * n' mod 2^384 has digit 54 at 63; 256 seeded pairs. Checked:

  - the warp's product (``mont_emulated``) and B8's tile of 16 products a
    warp (``mont_tile_emulated``, at n = 1, 15, 16, 17 and 2^10 + 3)
    against ``fq.mul``, the plain ``mont7r`` and the CIOS product of
    ``fp381_core.h``, and out of Montgomery form against the reference's
    ``mont7r`` (R' = 2^416);
  - every stage's largest column (T = a * b, x * n', T + m * p) below 2^31,
    the int32 accumulators' limit;
  - n', the digit words of p and n', each lane's constant B registers and
    B8's Toeplitz tables, recomputed here from the limbs and the PTX ISA's
    fragment layout;
  - the carry-lookahead of the warp's last ripple against a ripple.
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

from ethereum_consensus_tpu.ops import fq8 as ref_fq8  # noqa: E402
from ethereum_consensus_tpu.ops import fql as ref_fql  # noqa: E402
from ethereum_consensus_tpu_torch.ops import fq, fq8  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse fixture)

CSRC = Path(__file__).resolve().parents[1] / "ethereum_consensus_tpu_torch" / "csrc"
P = fq.P_INT
R = 1 << 384
N_PRIME = (-pow(P, -1, R)) % R
SHIFT = 13  # the maps' digit offset
TILE_NS = (1, 15, 16, 17, (1 << 10) + 3)

_SHIM = r"""
#include "fp_mma.h"

static fp381::Fp ld(const uint32_t* p) { fp381::Fp r; for (int i = 0; i < 12; ++i) r.v[i] = p[i]; return r; }

// n products: the emulated warp's values and each stage's largest column
extern "C" void mont_stages_h(const uint32_t* a, const uint32_t* b, int n, uint32_t* o, int32_t* s) {
  for (int i = 0; i < n; ++i) {
    fp_mma::host::Stages st;
    const fp381::Fp r = fp_mma::mont_emulated(ld(a + 12 * i), ld(b + 12 * i), &st);
    for (int k = 0; k < 12; ++k) o[12 * i + k] = r.v[k];
    s[3 * i] = st.t; s[3 * i + 1] = st.xn; s[3 * i + 2] = st.u;
  }
}
extern "C" void mont_cios_h(const uint32_t* a, const uint32_t* b, int n, uint32_t* o) {
  for (int i = 0; i < n; ++i) {
    const fp381::Fp r = fp381::mul(ld(a + 12 * i), ld(b + 12 * i));
    for (int k = 0; k < 12; ++k) o[12 * i + k] = r.v[k];
  }
}
extern "C" void mont_tile_h(const uint32_t* a, const uint32_t* b, int n, uint32_t* o) {
  fp_mma::mont_tile_emulated(a, b, n, o);
}
// n', the constants' digit words, each lane's B registers, B8's tables
extern "C" void tables_h(uint32_t* nprime, uint32_t* words, uint32_t* lane_b, uint32_t* tile) {
  const uint32_t np[12] = {FP_MMA_NPRIME_LIMBS};
  for (int i = 0; i < 12; ++i) nprime[i] = np[i];
  for (int i = 0; i < 32; ++i) words[i] = fp_mma::host::kConstantWords[i >> 4][i & 15];
  for (int i = 0; i < 32 * fp_mma::kLaneBWords; ++i) lane_b[i] = fp_mma::host::kLaneB[i / 12][i % 12];
  static fp_mma::TileTable t;
  fp_mma::host::tile_table(t);
  const uint32_t* flat = &t.low[0][0][0][0];
  for (unsigned i = 0; i < sizeof(t) / 4; ++i) tile[i] = flat[i];
}
extern "C" uint32_t carries_in_h(uint32_t generate, uint32_t propagate) {
  return fp_mma::carries_in(generate, propagate);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("mxu_redc")
    (tmp / "shim.cpp").write_text(_SHIM)
    path = tmp / "libmxu_redc.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
                    f"-I{CSRC}", str(tmp / "shim.cpp"), "-o", str(path)], check=True)
    lib = ctypes.CDLL(str(path))
    for fn in (lib.mont_cios_h, lib.mont_tile_h):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = None
    lib.mont_stages_h.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    lib.mont_stages_h.restype = None
    lib.tables_h.argtypes = [ctypes.c_void_p] * 4
    lib.tables_h.restype = None
    lib.carries_in_h.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.carries_in_h.restype = ctypes.c_uint32
    return lib


def _invertible_pairs(rng, targets) -> list:
    """For each x in ``targets``: a pair (a, b) below p with a * b = x mod
    2^384 (a odd and random, b = x / a mod 2^384, drawn again until b < p)."""
    pairs = []
    for x in targets:
        while True:
            a = int.from_bytes(rng.bytes(48), "big") % P | 1
            b = x * pow(a, -1, R) % R
            if a < P and b < P:
                pairs.append((a, b))
                break
    return pairs


def _groups() -> dict:
    rng = np.random.default_rng(17)
    edges = [0, 1, P - 1, R % P, (1 << 380) - 1, (1 << 378) - 1, (1 << 381) - 1]
    x_all = _invertible_pairs(rng, [R - 1] * 16)
    m_tops = [(63 << 378) | int.from_bytes(rng.bytes(48), "big") % (1 << 378) for _ in range(16)]
    m_top = _invertible_pairs(rng, [(-m * P) % R for m in m_tops])
    seeded = [tuple(int.from_bytes(rng.bytes(48), "big") % P for _ in range(2)) for _ in range(256)]
    return {"edges": [(a, b) for a in edges for b in edges], "x_digits_all_127": x_all,
            "m_digit_54_at_63": m_top, "seeded": seeded}


GROUPS = _groups()


def _limbs(values) -> np.ndarray:
    return np.ascontiguousarray(fq.limbs32(fq.limbs16(fq.from_ints(list(values)))).numpy())


def _run(fn, pairs, *extra):
    a, b = _limbs(p[0] for p in pairs), _limbs(p[1] for p in pairs)
    out = np.zeros_like(a)
    fn(a.ctypes.data, b.ctypes.data, len(pairs), out.ctypes.data, *extra)
    return out


def _ints(limbs: np.ndarray) -> list:
    return fq.to_ints(torch.from_numpy(limbs))


def test_the_groups_reach_their_edges():
    for a, b in GROUPS["x_digits_all_127"]:
        assert a * b % R == R - 1
    for a, b in GROUPS["m_digit_54_at_63"]:
        assert (a * b % R) * N_PRIME % R >> 378 == 63


@pytest.mark.parametrize("group", list(GROUPS))
def test_emulated_product_equals_cios_plain_and_reference(lib, group):
    pairs = GROUPS[group]
    stages = np.zeros((len(pairs), 3), np.int32)
    got = _run(lib.mont_stages_h, pairs, stages.ctypes.data)
    r_inv = pow(R, -1, P)
    assert _ints(got) == [a * b * r_inv % P for a, b in pairs]
    assert np.array_equal(got, _run(lib.mont_cios_h, pairs))
    pa, pb = (fq.limbs16(torch.from_numpy(_limbs(p[i] for p in pairs))) for i in (0, 1))
    assert torch.equal(torch.from_numpy(got), fq.limbs32(fq8.mont7r_plain(pa, pb)))
    assert torch.equal(torch.from_numpy(got), fq.limbs32(fq.mul(pa, pb)))
    # out of Montgomery form against the reference's mont7r (R' = 2^416)
    canonical = [(a % P, b % P) for a, b in pairs]
    port = fq.to_ints(fq.limbs32(fq.from_mont(fq.limbs16(torch.from_numpy(
        _run(lib.mont_stages_h, [(a * R % P, b * R % P) for a, b in canonical],
             stages.ctypes.data))))))
    ra, rb = (jnp.asarray(ref_fql.to_mont_cols([p[i] for p in canonical])) for i in (0, 1))
    ref = ref_fql.from_mont_ints(np.asarray(ref_fq8.mont7r(ra, rb)))
    assert port == ref == [a * b % P for a, b in canonical]


@pytest.mark.parametrize("group", list(GROUPS))
def test_every_stage_stays_inside_int32(lib, group):
    pairs = GROUPS[group]
    stages = np.zeros((len(pairs), 3), np.int32)
    _run(lib.mont_stages_h, pairs, stages.ctypes.data)
    assert stages.min() >= 0
    assert stages.max() < 2**31
    # the columns' own bounds: 55 terms of 127^2, and T + m p twice that
    assert stages[:, :2].max() <= 55 * 127**2 and stages[:, 2].max() <= 2 * 55 * 127**2


@pytest.mark.parametrize("n", TILE_NS)
def test_tile_emulation_equals_the_products(lib, n):
    pairs = (GROUPS["seeded"] * 5)[:n]
    pairs = GROUPS["edges"][: min(n, 49)] + pairs[: n - min(n, 49)]
    got = _run(lib.mont_tile_h, pairs)
    assert np.array_equal(got, _run(lib.mont_cios_h, pairs))
    pa, pb = (fq.limbs16(torch.from_numpy(_limbs(p[i] for p in pairs))) for i in (0, 1))
    assert torch.equal(torch.from_numpy(got), fq.limbs32(fq8.mont7r_plain(pa, pb)))


def _digits(v: int) -> list:
    return [(v >> (7 * i)) & 127 for i in range(55)]


def _digit(v: int, i: int) -> int:
    return _digits(v)[i] if 0 <= i < 55 else 0


def _pack(digits) -> int:
    return sum((d & 0xFF) << (8 * e) for e, d in enumerate(digits))


def test_constant_tables_match_the_limbs(lib):
    """n' = -p^-1 mod 2^384; the digit words; each lane's B registers of the
    Hankel tiles B[k][n] = digit k - 13 + beta(n) of n' (two steps) and p
    (three), by the PTX layout of B (row 4 threadID_in_group + (i & 3) +
    16 (i >> 2), column groupID); B8's Toeplitz tables B[k][c] = digit
    c - k of n' (7 n8 tiles) and p (14), two k32 steps."""
    nprime = np.zeros(12, np.uint32)
    words = np.zeros(32, np.uint32)
    lane_b = np.zeros((32, 12), np.uint32)
    tile = np.zeros(2 * 7 * 32 * 2 + 2 * 14 * 32 * 2, np.uint32)
    lib.tables_h(nprime.ctypes.data, words.ctypes.data, lane_b.ctypes.data, tile.ctypes.data)
    assert sum(int(w) << (32 * i) for i, w in enumerate(nprime)) == N_PRIME
    assert N_PRIME * P % R == R - 1
    for k, value in enumerate((P, N_PRIME)):
        d = _digits(value) + [0] * 9
        assert list(words[16 * k:16 * (k + 1)]) == [_pack(d[4 * q:4 * q + 4]) for q in range(16)]

    def b_elements(lane, reg):  # (row, column) of the register's four bytes
        g, t = lane >> 2, lane & 3
        return [(4 * t + e + 16 * reg, g) for e in range(4)]

    def beta(n):
        return 4 * (n >> 1) + (n & 1)

    for lane in range(32):
        want = []
        for value, steps in ((N_PRIME, 2), (P, 3)):
            for step in range(steps):
                for reg in range(2):
                    want.append(_pack(_digit(value, 32 * step + k - SHIFT + beta(n))
                                      for k, n in b_elements(lane, reg)))
        assert list(lane_b[lane]) == want + [0, 0], lane
    flat = []
    for value, tiles in ((N_PRIME, 7), (P, 14)):
        for step in range(2):
            for n8 in range(tiles):
                for lane in range(32):
                    for reg in range(2):
                        flat.append(_pack(_digit(value, 8 * n8 + c - 32 * step - k)
                                          for k, c in b_elements(lane, reg)))
    assert list(tile) == flat


def test_carry_lookahead_equals_a_ripple(lib):
    """Lanes that generate (their sum reached 2^28) and propagate (it is
    2^28 - 1): the carry into each lane, as the warp's last ripple takes it,
    against a ripple from lane 0; disjoint masks, all-propagate chains
    among them."""
    rng = np.random.default_rng(28)
    cases = [(0, 0), (1, 0xFFFFFFFE), (1, 0x7FFFFFFE), (0x80000000, 0x7FFFFFFF),
             (0x00010001, 0xFFFEFFFE)]
    for _ in range(500):
        g = int(rng.integers(0, 2**32))
        p = int(rng.integers(0, 2**32)) & ~g
        cases.append((g, p))
    for g, p in cases:
        ripple, carry = 0, 0
        for lane in range(32):
            ripple |= carry << lane
            carry = (g >> lane) & 1 | ((p >> lane) & 1 & carry)
        assert lib.carries_in_h(g, p) == ripple, (hex(g), hex(p))
