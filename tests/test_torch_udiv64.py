"""The exact unsigned 64-bit division by reciprocals (csrc/udiv64_core.h)
against Python's ``//``.

The header's functions are what the card runs (one multiply-high by a magic
number made once a sweep, a subtraction, an add and two shifts); g++ builds
them here. Numerators and divisors are drawn over the whole u64 range by
hypothesis, beside the edges: 1, 2, 2^32 +- 1, 2^63, 2^64 - 1, and the
spec's divisors the sweeps take (the increment 10^9, the weight denominator
64, the inactivity penalty's 3 * 2^26, the reward divisor 2^31 of a
2^20-validator registry).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

pytest.importorskip("hypothesis")
from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "ethereum_consensus_tpu_torch" / "csrc"
TOP = 1 << 64

EDGE_DIVISORS = [
    1, 2, 3, 7, 64, 10**9, 3 << 26, 1 << 31, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
    (1 << 63) - 1, 1 << 63, (1 << 63) + 1, TOP - 2, TOP - 1,
]
EDGE_NUMERATORS = sorted({
    0, 1, 2, 3, 63, 64, 65, 10**9 - 1, 10**9, 10**9 + 1, (1 << 32) - 1, 1 << 32,
    (1 << 32) + 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, TOP - 2, TOP - 1,
})

_SHIM = r"""
#include "udiv64_core.h"
extern "C" uint64_t udiv64_host(uint64_t n, uint64_t d) {
  return udiv64_core::divide(n, udiv64_core::prepare(d));
}
extern "C" void udiv64_magic_host(uint64_t d, uint64_t* magic, uint32_t* shifts) {
  const udiv64_core::UDiv64 m = udiv64_core::prepare(d);
  *magic = m.magic;
  shifts[0] = m.shift1;
  shifts[1] = m.shift2;
}
"""


@pytest.fixture(scope="session")
def udiv(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("udiv64_core")
    shim = tmp / "shim.cpp"
    shim.write_text(_SHIM)
    lib_path = tmp / "libudiv64_core.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
         f"-I{CSRC}", str(shim), "-o", str(lib_path)],
        check=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.udiv64_host.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.udiv64_host.restype = ctypes.c_uint64
    lib.udiv64_magic_host.argtypes = [ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p]
    lib.udiv64_magic_host.restype = None
    return lib


@pytest.mark.parametrize("d", EDGE_DIVISORS)
def test_division_is_exact_at_the_edges(udiv, d):
    """Every edge numerator, and the multiples of d and their neighbours
    across the range, where a quotient steps."""
    numerators = set(EDGE_NUMERATORS)
    for q in (1, 2, 3, (TOP - 1) // d, (TOP - 1) // d - 1, ((TOP - 1) // d) // 2):
        for delta in (-1, 0, 1):
            if 0 <= q * d + delta < TOP:
                numerators.add(q * d + delta)
    for n in sorted(numerators):
        assert udiv.udiv64_host(n, d) == n // d, (n, d)


@pytest.mark.parametrize("d", EDGE_DIVISORS)
def test_magic_numbers_are_the_round_up_ones(udiv, d):
    """m = floor(2^64 (2^l - d) / d) + 1 with l = ceil(log2 d), below 2^64;
    shifts min(l, 1) and max(l - 1, 0)."""
    magic = ctypes.c_uint64()
    shifts = (ctypes.c_uint32 * 2)()
    udiv.udiv64_magic_host(d, ctypes.byref(magic), shifts)
    lg = (d - 1).bit_length()
    assert magic.value == (TOP * ((1 << lg) - d)) // d + 1 < TOP
    assert list(shifts) == [min(lg, 1), max(lg - 1, 0)]


@settings(max_examples=800, deadline=None, derandomize=True, database=None)
@given(st.integers(0, TOP - 1), st.integers(1, TOP - 1))
@example(TOP - 1, TOP - 1)
@example(TOP - 1, 1)
@example(TOP - 1, (1 << 63) + 1)
def test_division_matches_python_over_u64(udiv, n, d):
    assert udiv.udiv64_host(n, d) == n // d


@settings(max_examples=800, deadline=None, derandomize=True, database=None)
@given(st.integers(0, TOP - 1), st.integers(0, 63), st.sampled_from([-1, 0, 1]))
def test_division_matches_python_near_powers_of_two(udiv, n, k, delta):
    """Divisors at 2^k - 1, 2^k and 2^k + 1: where l and the shifts change."""
    d = (1 << k) + delta
    if d < 1:
        d = 1
    assert udiv.udiv64_host(n, d) == n // d
