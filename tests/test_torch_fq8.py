"""The port's int8 digit product (ops/fq8.py, csrc/fp_mma.h) against the
reference's ops/fq8.py and against the port's CIOS product.

Every comparison is exact. The operands are 256 canonical values from a
numpy seed plus 0, 1, p - 1, R mod p and 2^381 - 1, paired with the same
list reversed; the reference gets the same integers as 24 sixteen-bit
columns (its ``carry_norm`` adds the 25th, zero here). Checked:

  - the digits and digit columns (``_to7r``, ``product_cols7r``,
    ``product_cols7``, ``product_cols8``) column for column against the
    reference's;
  - ``mont7r``, ``mont7`` and ``mont8`` bit for bit against ``fq.mul``, and
    out of Montgomery form against the reference's products (R' = 2^416)
    out of theirs;
  - the multiplier switch: ``EC_PAIRING_MULT`` and ``set_multiplier``;
  - ``csrc/fp_mma.h`` built with g++: the host emulation of the warp's
    product (its m16n8k32 fragments, carry passes and reductions as
    products over 32 simulated lanes) against ``fq.mul`` and the plain
    ``mont7r``, its fragment maps, and the tower of ``fp_tower.h`` built
    with the mxu multiplier against the native Miller loop
    (``tests/test_torch_mxu_redc.py`` holds the reduction's edges, its
    tables and B8's tile).

The kernel itself runs only where a CUDA card is present.
"""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ethereum_consensus_tpu.native import bls as ref_native  # noqa: E402
from ethereum_consensus_tpu.ops import fq8 as ref_fq8  # noqa: E402
from ethereum_consensus_tpu.ops import fql as ref_fql  # noqa: E402
from ethereum_consensus_tpu_torch import _env, _kernels  # noqa: E402
from ethereum_consensus_tpu_torch.ops import fq, fq8, pairing  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "ethereum_consensus_tpu_torch" / "csrc"
P = fq.P_INT


@pytest.fixture(scope="module")
def values():
    rng = np.random.default_rng(8)
    vals = [int.from_bytes(rng.bytes(48), "big") % P for _ in range(256)]
    return vals + [0, 1, P - 1, fq.R % P, (1 << 381) - 1]


@pytest.fixture(scope="module")
def operands(values):
    """(port limbs a, port limbs b, reference columns a, reference columns b)."""
    a, b = values, values[::-1]
    pa, pb = fq.limbs16(fq.from_ints(a)), fq.limbs16(fq.from_ints(b))
    return pa, pb, jnp.asarray(pa.numpy().astype(np.uint64)), jnp.asarray(
        pb.numpy().astype(np.uint64))


@pytest.fixture
def multiplier():
    """Restores the u64 multiplier after the test, whatever it set."""
    yield fq8
    fq8.set_multiplier("u64")


def _column_ints(cols: np.ndarray, width: int) -> list:
    return [sum(int(c) << (width * i) for i, c in enumerate(row)) for row in cols]


# ---------------------------------------------------------------------------
# digits and columns
# ---------------------------------------------------------------------------


def test_digits_match_reference(operands):
    pa, _, ra, _ = operands
    want = np.asarray(ref_fq8._to7r(ref_fq8.carry_norm(ra))).astype(np.int64)
    assert np.array_equal(fq8._to7r(pa).numpy(), want)


@pytest.mark.parametrize("name, width", [("product_cols7r", 7), ("product_cols7", 7),
                                         ("product_cols8", 8)])
def test_columns_match_reference(operands, values, name, width):
    pa, pb, ra, rb = operands
    if name == "product_cols7r":
        want = ref_fq8.product_cols7r(ref_fq8.carry_norm(ra), ref_fq8.carry_norm(rb))
    else:
        want = getattr(ref_fq8, name)(ra, rb)
    got = getattr(fq8, name)(pa, pb).numpy()
    assert np.array_equal(got, np.asarray(want).astype(np.int64))
    assert _column_ints(got, width) == [x * y for x, y in zip(values, values[::-1])]


# ---------------------------------------------------------------------------
# the products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mont7r_plain", "mont7", "mont8"])
def test_products_equal_the_cios_product(operands, name):
    pa, pb, _, _ = operands
    assert torch.equal(getattr(fq8, name)(pa, pb), fq.mul(pa, pb))


def test_plain_product_takes_large_batches_in_chunks(operands, monkeypatch):
    pa, pb, _, _ = operands
    monkeypatch.setattr(fq8, "CHUNK", 10)
    assert torch.equal(fq8.mont7r_plain(pa, pb), fq.mul(pa, pb))


@pytest.mark.parametrize("port_name, ref_name", [("mont7r_plain", "mont7r"), ("mont7", "mont7"),
                                                 ("mont8", "mont8")])
def test_products_match_reference_out_of_montgomery_form(values, port_name, ref_name):
    a, b = values, values[::-1]
    pa, pb = (fq.to_mont(fq.limbs16(fq.from_ints(v))) for v in (a, b))
    port = fq.to_ints(fq.limbs32(fq.from_mont(getattr(fq8, port_name)(pa, pb))))
    ra, rb = (jnp.asarray(ref_fql.to_mont_cols(v)) for v in (a, b))
    ref = ref_fql.from_mont_ints(np.asarray(getattr(ref_fq8, ref_name)(ra, rb)))
    assert port == ref == [x * y % P for x, y in zip(a, b)]


def test_dispatcher_takes_the_plain_version_for_cpu_tensors(operands):
    pa, pb, _, _ = operands
    before = dict(fq8.launch_counts)
    a32, b32 = fq.limbs32(pa), fq.limbs32(pb)
    assert torch.equal(fq8.mont7r(a32, b32), fq.limbs32(fq.mul(pa, pb)))
    assert fq8.launch_counts == before


def test_launcher_refuses_what_the_kernel_does_not_take(operands):
    pa, pb, _, _ = operands
    a32, b32 = fq.limbs32(pa), fq.limbs32(pb)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fq8.mont7r_cuda(a32, b32)
    with pytest.raises(TypeError):
        fq8.mont7r(pa, pb)
    with pytest.raises(ValueError):
        fq8.mont7r(a32, b32[:3])


# ---------------------------------------------------------------------------
# the switch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value, want", [(None, "u64"), ("u64", "u64"), ("MXU", "mxu"),
                                         (" mxu ", "mxu"), ("bogus", ValueError)])
def test_multiplier_from_the_environment(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("EC_PAIRING_MULT", raising=False)
    else:
        monkeypatch.setenv("EC_PAIRING_MULT", value)
    if want is ValueError:
        with pytest.raises(ValueError, match="EC_PAIRING_MULT"):
            _env.multiplier()
    else:
        assert _env.multiplier() == want


def test_the_environment_sets_the_switch_at_import():
    code = (
        "import importlib, os\n"
        "from ethereum_consensus_tpu_torch.ops import fq8\n"
        "assert fq8.get_multiplier() == 'mxu', fq8.get_multiplier()\n"
        "os.environ['EC_PAIRING_MULT'] = 'bogus'\n"
        "try:\n"
        "    importlib.reload(fq8)\n"
        "except ValueError as e:\n"
        "    assert \"EC_PAIRING_MULT='bogus'\" in str(e), e\n"
        "else:\n"
        "    raise AssertionError('an unknown multiplier was taken')\n"
    )
    env = dict(os.environ, EC_PAIRING_MULT="Mxu")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True)


def test_set_multiplier_switches_and_refuses_unknown_kinds(multiplier, operands):
    pa, pb, _, _ = operands
    assert multiplier.get_multiplier() == "u64"
    with pytest.raises(ValueError, match="bogus"):
        multiplier.set_multiplier("bogus")
    assert multiplier.get_multiplier() == "u64"
    multiplier.set_multiplier("mxu")
    assert multiplier.get_multiplier() == "mxu"
    assert torch.equal(multiplier.mul(pa, pb), fq.mul(pa, pb))
    with multiplier.pinned("u64"):
        assert multiplier.get_multiplier() == "u64"
    assert multiplier.get_multiplier() == "mxu"
    with pytest.raises(ValueError):
        with multiplier.pinned("bogus"):
            pass


def test_the_switch_picks_the_mxu_libraries(multiplier):
    from ethereum_consensus_tpu_torch.ops import g1

    assert (pairing._library(), g1._library()) == ("pairing", "g1_sum")
    multiplier.set_multiplier("mxu")
    assert (pairing._library(), g1._library()) == ("pairing_mxu", "g1_sum_mxu")
    with multiplier.pinned("u64"):
        assert g1._library() == "g1_sum"


def test_a_failed_mxu_build_raises(monkeypatch):
    """No nvcc: loading an mxu library raises; nothing falls back to the
    u64 library or to a plain version."""
    monkeypatch.setattr(_kernels, "_LOADED", {})
    monkeypatch.setattr(_kernels, "_BUILD", str(REPO / ".pytest_no_build"))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_kernels.os.path, "exists", lambda path: False)
    for name in ("mont_mxu", "pairing_mxu", "g1_sum_mxu"):
        with pytest.raises(RuntimeError, match="nvcc"):
            _kernels.load(name)
    assert _kernels._flags("pairing_mxu")[-1] == "-DFP381_MUL_MXU"
    assert "-DFP381_MUL_MXU" not in _kernels._flags("pairing")


# ---------------------------------------------------------------------------
# fp_mma.h on the host
# ---------------------------------------------------------------------------

_HOST_SHIM = r"""
#include "fp_mma.h"

static fp381::Fp ld(const uint32_t* p) { fp381::Fp r; for (int i = 0; i < 12; ++i) r.v[i] = p[i]; return r; }
static void st(uint32_t* p, const fp381::Fp& a) { for (int i = 0; i < 12; ++i) p[i] = a.v[i]; }

// n products of (n, 12) Montgomery limbs: the emulated warp, the CIOS product
extern "C" void mont_emulated_h(const uint32_t* a, const uint32_t* b, int n, uint32_t* o) {
  for (int i = 0; i < n; ++i) st(o + 12 * i, fp_mma::mont_emulated(ld(a + 12 * i), ld(b + 12 * i)));
}
extern "C" void mont_cios_h(const uint32_t* a, const uint32_t* b, int n, uint32_t* o) {
  for (int i = 0; i < n; ++i) st(o + 12 * i, fp381::mul(ld(a + 12 * i), ld(b + 12 * i)));
}
// the maps: which accumulator column each lane's registers hold, and the
// digit index of every fragment byte
extern "C" void maps_h(int32_t* cols, int32_t* a_digits, int32_t* b_digits) {
  for (int lane = 0; lane < 32; ++lane) {
    for (int i = 0; i < 4; ++i)
      cols[4 * lane + i] = fp_mma::d_column(fp_mma::c_row(lane, i), fp_mma::c_col(lane, i));
    for (int step = 0; step < fp_mma::kSteps; ++step) {
      for (int i = 0; i < 16; ++i)
        a_digits[(lane * 3 + step) * 16 + i] =
            fp_mma::a_digit(step, fp_mma::a_row(lane, i), fp_mma::a_col(lane, i));
      for (int i = 0; i < 8; ++i)
        b_digits[(lane * 3 + step) * 8 + i] =
            fp_mma::b_digit(step, fp_mma::b_row(lane, i), fp_mma::b_col(lane, i));
    }
  }
}
"""

_TOWER_SHIM = r"""
#include "fp_tower.h"
using namespace tower;
static Fp ld(const uint32_t* p) { Fp r; for (int i = 0; i < 12; ++i) r.v[i] = p[i]; return fp381::to_mont(r); }
static void st(uint32_t* p, const Fp& a) { const Fp c = fp381::from_mont(a); for (int i = 0; i < 12; ++i) p[i] = c.v[i]; }
static Fp2 ld2(const uint32_t* p) { return Fp2{ld(p), ld(p + 12)}; }
static void st2(uint32_t* p, const Fp2& a) { st(p, a.c0); st(p + 12, a.c1); }
extern "C" void miller_h(const uint32_t* g1, const uint32_t* g2, uint32_t* o) {
  const Fp12 f = miller_loop(ld(g1), ld(g1 + 12), ld2(g2), ld2(g2 + 24));
  st2(o, f.c0.a0); st2(o + 24, f.c0.a1); st2(o + 48, f.c0.a2);
  st2(o + 72, f.c1.a0); st2(o + 96, f.c1.a1); st2(o + 120, f.c1.a2);
}
"""


def _build(tmp, name: str, source: str, *flags) -> ctypes.CDLL:
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    shim = tmp / f"{name}.cpp"
    shim.write_text(source)
    lib_path = tmp / f"lib{name}.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
                    *flags, f"-I{CSRC}", str(shim), "-o", str(lib_path)], check=True)
    return ctypes.CDLL(str(lib_path))


@pytest.fixture(scope="module")
def mma_lib(tmp_path_factory):
    lib = _build(tmp_path_factory.mktemp("fp_mma"), "fp_mma", _HOST_SHIM)
    for fn in (lib.mont_emulated_h, lib.mont_cios_h):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = None
    lib.maps_h.argtypes = [ctypes.c_void_p] * 3
    lib.maps_h.restype = None
    return lib


def _host_products(fn, pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    a = np.ascontiguousarray(fq.limbs32(pa).numpy())
    b = np.ascontiguousarray(fq.limbs32(pb).numpy())
    out = np.zeros_like(a)
    fn(a.ctypes.data, b.ctypes.data, a.shape[0], out.ctypes.data)
    return fq.limbs16(torch.from_numpy(out))


def test_emulated_warp_product_equals_cios_and_plain(mma_lib, operands):
    pa, pb, _, _ = operands
    got = _host_products(mma_lib.mont_emulated_h, pa, pb)
    assert torch.equal(got, fq.mul(pa, pb))
    assert torch.equal(got, fq8.mont7r_plain(pa, pb))
    assert torch.equal(_host_products(mma_lib.mont_cios_h, pa, pb), got)


def test_fragment_maps_cover_the_toeplitz_product(mma_lib):
    """The 32 lanes' four accumulators are the 128 columns, once each, lane
    l holding the columns 4l .. 4l + 3, and the fragment digits sum to every
    column of the 55-digit product: the Toeplitz A (a's digit
    alpha(r) + 13 - k) times the Hankel B (b's digit k - 13 + beta(n)) at row
    r, column n, over the three k32 steps, and the low 56 columns (lanes 0 ..
    13) over the first two."""
    cols = np.zeros(128, np.int32)
    a_digits = np.zeros(32 * 3 * 16, np.int32)
    b_digits = np.zeros(32 * 3 * 8, np.int32)
    mma_lib.maps_h(cols.ctypes.data, a_digits.ctypes.data, b_digits.ctypes.data)
    assert sorted(cols) == list(range(128))
    assert list(cols) == list(range(128))  # lane-major: lane l's four columns
    # rebuild A, B and the column of each accumulator by the layout tables
    a_tile, b_tile, column = {}, {}, {}
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            column[g + 8 * (i >> 1), 2 * t + (i & 1)] = cols[4 * lane + i]
        for step in range(3):
            for i in range(16):
                row = g + 8 * ((i >> 2) & 1)
                col = 4 * t + (i & 3) + 16 * (i >> 3)
                a_tile[row, 32 * step + col] = a_digits[(lane * 3 + step) * 16 + i]
            for i in range(8):
                row = 4 * t + (i & 3) + 16 * (i >> 2)
                b_tile[32 * step + row, g] = b_digits[(lane * 3 + step) * 8 + i]
    assert len(a_tile) == 16 * 96 and len(b_tile) == 96 * 8
    for r in range(16):
        for n in range(8):
            c = column[r, n]
            want = [(c - j, j) for j in range(max(0, c - 54), min(c, 54) + 1)][::-1]
            for k_end in (96, 64) if c < 56 else (96,):
                pairs = sorted((a_tile[r, k], b_tile[k, n]) for k in range(k_end)
                               if 0 <= a_tile[r, k] < 55 and 0 <= b_tile[k, n] < 55)
                assert pairs == want, (r, n, c, k_end)


def test_tower_on_the_mxu_multiplier_matches_native(tmp_path_factory):
    """fp_tower.h built with -DFP381_MUL_MXU: every product of the Miller
    loop is the emulated warp product, and its value is the native one."""
    lib = _build(tmp_path_factory.mktemp("fp_tower_mxu"), "fp_tower_mxu", _TOWER_SHIM,
                 "-DFP381_MUL_MXU")
    lib.miller_h.argtypes = [ctypes.c_void_p] * 3
    lib.miller_h.restype = None
    sk = 0x1234567890ABCDEF
    g1 = ref_native.g1_mul_raw(ref_native.g1_generator_raw(), False, sk.to_bytes(32, "big"))[0]
    g2 = ref_native.g2_decompress(ref_native.hash_to_g2_compressed(b"mxu", b"DST"), False)[1]
    g1_limbs = np.ascontiguousarray(pairing._coords([g1], 2).numpy().view(np.uint32).reshape(-1))
    g2_limbs = np.ascontiguousarray(pairing._coords([g2], 4).numpy().view(np.uint32).reshape(-1))
    out = np.zeros(144, np.uint32)
    lib.miller_h(g1_limbs.ctypes.data, g2_limbs.ctypes.data, out.ctypes.data)
    native = ref_native.miller_loop_raw(g1, g2)
    assert fq.to_ints(torch.from_numpy(out.view(np.int32))) == [
        int.from_bytes(native[48 * k : 48 * (k + 1)], "big") for k in range(12)]
