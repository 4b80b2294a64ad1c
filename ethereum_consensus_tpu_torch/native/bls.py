"""Native BLS12-381 backend loader: builds bls12_381.cpp on first use with
the system ``g++`` into ``_build/`` and exposes it via ctypes (same pattern
as the SHA-256 merkle backend in native/__init__.py — the role blst plays
for the reference, ethereum-consensus/src/crypto/bls.rs).

Every function here works on the wire formats (48-byte compressed G1,
96-byte compressed G2, 32-byte scalars); crypto/bls.py routes its
object-level API through these when the backend is available.

All argtypes are declared explicitly — size_t args beyond the register
slots otherwise pick up garbage upper halves on x86-64.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = [
    "load",
    "available",
    "decode_error_message",
    "g1_decompress",
    "g2_decompress",
    "g1_compress_raw",
    "g2_compress_raw",
    "g1_generator_raw",
    "g2_generator_raw",
    "sk_to_pk",
    "small_sk_to_pk_batch",
    "sign",
    "hash_to_g2_compressed",
    "verify",
    "fast_aggregate_verify",
    "fast_aggregate_verify_raw",
    "aggregate_verify",
    "aggregate_signatures",
    "aggregate_public_keys",
    "batch_verify",
    "g1_msm",
    "g2_msm",
    "g1_mul_raw",
    "g1_add_raw",
    "pairing_product_is_one_raw",
]

_SOURCE = os.path.join(os.path.dirname(__file__), "bls12_381.cpp")
_HEADER = os.path.join(os.path.dirname(__file__), "bls12_381_constants.h")
_LIB = None
_TRIED = False

_c = ctypes
_u32p = _c.POINTER(_c.c_uint32)


class NativeBlsError(RuntimeError):
    """Unexpected native-backend failure (not a validation verdict)."""


# decompress/validation error codes (negated DecodeErr from the C side)
_DECODE_ERRORS = {
    -1: "internal error",
    -2: "uncompressed encodings are not supported",
    -3: "malformed infinity encoding",
    -4: "coordinate not in field",
    -5: "x coordinate not on curve",
    -6: "point not in the order-r subgroup",
}


def decode_error_message(rc: int) -> str:
    return _DECODE_ERRORS.get(rc, f"native error {rc}")


def _build_dir() -> str:
    path = os.path.join(os.path.dirname(__file__), "_build")
    os.makedirs(path, exist_ok=True)
    return path


def _source_tag() -> str:
    digest = hashlib.sha256()
    for path in (_SOURCE, _HEADER):
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()[:16]


def _declare(lib) -> None:
    c = _c
    sz = c.c_size_t
    p8 = c.c_char_p
    i32 = c.c_int
    sigs = {
        "ec_bls_version": ([], c.c_uint64),
        "ec_g1_decompress": ([p8, p8, c.POINTER(i32), i32], i32),
        "ec_g2_decompress": ([p8, p8, c.POINTER(i32), i32], i32),
        "ec_g1_compress_raw": ([p8, i32, p8], i32),
        "ec_g2_compress_raw": ([p8, i32, p8], i32),
        "ec_g1_generator_raw": ([p8], i32),
        "ec_g2_generator_raw": ([p8], i32),
        "ec_bls_sk_to_pk": ([p8, p8], i32),
        "ec_bls_small_sk_to_pk_batch": ([c.POINTER(c.c_uint64), sz, p8], i32),
        "ec_bls_hash_to_g2": ([p8, sz, p8, sz, p8], i32),
        "ec_bls_sign": ([p8, p8, sz, p8, sz, p8], i32),
        "ec_bls_verify": ([p8, p8, sz, p8, sz, p8, i32], i32),
        "ec_bls_fast_aggregate_verify": ([p8, sz, p8, sz, p8, sz, p8, i32], i32),
        "ec_bls_fast_aggregate_verify_raw": ([p8, sz, p8, sz, p8, sz, p8, i32], i32),
        "ec_bls_aggregate_verify": ([p8, sz, p8, _u32p, p8, sz, p8, i32], i32),
        "ec_bls_aggregate_sigs": ([p8, sz, p8], i32),
        "ec_bls_aggregate_pubkeys": ([p8, sz, p8], i32),
        "ec_bls_batch_verify": ([sz, _u32p, p8, p8, _u32p, p8, p8, sz, p8], i32),
        "ec_bls_batch_verify_raw": ([sz, _u32p, p8, p8, _u32p, p8, p8, sz, p8], i32),
        "ec_miller_loop_raw": ([p8, p8, p8], i32),
        "ec_fp12_final_exp_is_one": ([p8], i32),
        "ec_g1_msm": ([p8, p8, sz, p8, c.POINTER(i32)], i32),
        "ec_g2_msm": ([p8, p8, sz, p8, c.POINTER(i32)], i32),
        "ec_g1_mul_raw": ([p8, i32, p8, p8, c.POINTER(i32)], i32),
        "ec_g1_add_raw": ([p8, i32, p8, i32, p8, c.POINTER(i32)], i32),
        "ec_g1_subgroup_check_raw": ([p8], i32),
        "ec_g2_subgroup_check_raw": ([p8], i32),
        "ec_pairing_product_is_one_raw": ([p8, p8, p8, p8, sz], i32),
        "ec_g1_decompress_batch": ([p8, sz, p8, c.POINTER(i32), c.POINTER(i32), i32], i32),
        "ec_fr_validate": ([p8, sz], i32),
        "ec_fr_eval_poly": ([p8, p8, sz, p8, p8], i32),
        "ec_fr_eval_and_quotient": ([p8, p8, sz, p8, p8, p8], i32),
        "ec_g1_msm_prepare": ([p8, sz, i32], c.c_void_p),
        "ec_g1_msm_prepared_run": ([c.c_void_p, p8, sz, p8, c.POINTER(i32)], i32),
        "ec_g1_msm_prepared_free": ([c.c_void_p], None),
        "ec_fp8_active": ([], i32),
        "ec_fp8_selftest": ([c.c_uint64, i32], i32),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def load():
    """Compile (once per source hash) + load the shared library; None when
    the machine has no ``g++``. A build that fails raises with the
    compiler's output."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    lib_path = os.path.join(_build_dir(), f"bls12_381-{_source_tag()}.so")
    if not os.path.exists(lib_path):
        if shutil.which("g++") is None:
            _TRIED = True
            return None
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build_dir())
        os.close(fd)
        try:
            proc = subprocess.run(
                # -std=c++17 makes operator new honor over-aligned types
                # (the AVX-512 x8 structs); older toolchains default to
                # gnu++14 where a heap MillerPairX8 is only 16-byte
                # aligned and the first vmovdqa64 GP-faults
                ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                 "-fPIC", _SOURCE, "-o", tmp],
                capture_output=True,
                text=True,
                timeout=300,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"native BLS12-381 build failed:\n{proc.stderr}")
            os.replace(tmp, lib_path)  # atomic under concurrent builds
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(lib_path)
    _declare(lib)
    _LIB = lib
    return lib


def available() -> bool:
    return load() is not None


def _lib():
    lib = load()
    if lib is None:
        raise NativeBlsError("native BLS backend unavailable (no g++ toolchain)")
    return lib


# -- point codecs -----------------------------------------------------------


def g1_decompress(data: bytes, check_subgroup: bool = True) -> tuple[int, bytes, bool]:
    """(rc, raw96, is_infinity); rc == 0 on success, negative error code."""
    out = _c.create_string_buffer(96)
    inf = _c.c_int(0)
    rc = _lib().ec_g1_decompress(bytes(data), out, _c.byref(inf), int(check_subgroup))
    return rc, out.raw, bool(inf.value)


def g2_decompress(data: bytes, check_subgroup: bool = True) -> tuple[int, bytes, bool]:
    out = _c.create_string_buffer(192)
    inf = _c.c_int(0)
    rc = _lib().ec_g2_decompress(bytes(data), out, _c.byref(inf), int(check_subgroup))
    return rc, out.raw, bool(inf.value)


def g1_compress_raw(raw: bytes, is_inf: bool = False) -> bytes:
    out = _c.create_string_buffer(48)
    rc = _lib().ec_g1_compress_raw(bytes(raw), int(is_inf), out)
    if rc != 0:
        raise NativeBlsError(decode_error_message(rc))
    return out.raw


def g2_compress_raw(raw: bytes, is_inf: bool = False) -> bytes:
    out = _c.create_string_buffer(96)
    rc = _lib().ec_g2_compress_raw(bytes(raw), int(is_inf), out)
    if rc != 0:
        raise NativeBlsError(decode_error_message(rc))
    return out.raw


def g1_generator_raw() -> bytes:
    out = _c.create_string_buffer(96)
    _lib().ec_g1_generator_raw(out)
    return out.raw


def g2_generator_raw() -> bytes:
    out = _c.create_string_buffer(192)
    _lib().ec_g2_generator_raw(out)
    return out.raw


# -- signature scheme -------------------------------------------------------


def sk_to_pk(sk32: bytes) -> bytes:
    out = _c.create_string_buffer(48)
    rc = _lib().ec_bls_sk_to_pk(bytes(sk32), out)
    if rc != 0:
        raise NativeBlsError(decode_error_message(rc))
    return out.raw


def small_sk_to_pk_batch(keys: list[int]) -> list[bytes]:
    """The compressed public keys of the secret keys ``keys``: ascending
    integers from 1 below 2^64 (a registry's ``SecretKey(i + 1)``), walked
    by additions of the generator with the affine conversions batched.
    Equal to ``sk_to_pk`` of each key."""
    keys = [int(k) for k in keys]
    if any(k < 1 or k >= 1 << 64 for k in keys) or any(
            b < a for a, b in zip(keys, keys[1:])):
        raise ValueError("keys must be ascending integers in [1, 2^64)")
    ks = (_c.c_uint64 * len(keys))(*keys)
    out = _c.create_string_buffer(48 * len(keys))
    rc = _lib().ec_bls_small_sk_to_pk_batch(ks, len(keys), out)
    if rc != 0:
        raise NativeBlsError(decode_error_message(rc))
    raw = out.raw
    return [raw[48 * i:48 * i + 48] for i in range(len(keys))]


def sign(sk32: bytes, message: bytes, dst: bytes) -> bytes:
    out = _c.create_string_buffer(96)
    rc = _lib().ec_bls_sign(bytes(sk32), bytes(message), len(message), bytes(dst), len(dst), out)
    if rc != 0:
        raise NativeBlsError(decode_error_message(rc))
    return out.raw


def hash_to_g2_compressed(message: bytes, dst: bytes) -> bytes:
    out = _c.create_string_buffer(96)
    rc = _lib().ec_bls_hash_to_g2(bytes(message), len(message), bytes(dst), len(dst), out)
    if rc != 0:
        raise NativeBlsError(decode_error_message(rc))
    return out.raw


def verify(pk48: bytes, message: bytes, sig96: bytes, dst: bytes,
           assume_valid: bool = False) -> int:
    """1 valid, 0 invalid, negative = parse/validation error code."""
    return _lib().ec_bls_verify(
        bytes(pk48), bytes(message), len(message), bytes(dst), len(dst),
        bytes(sig96), int(assume_valid),
    )


def fast_aggregate_verify(pks: list[bytes], message: bytes, sig96: bytes,
                          dst: bytes, assume_valid: bool = False) -> int:
    cat = b"".join(bytes(pk) for pk in pks)
    return _lib().ec_bls_fast_aggregate_verify(
        cat, len(pks), bytes(message), len(message), bytes(dst), len(dst),
        bytes(sig96), int(assume_valid),
    )


def fast_aggregate_verify_raw(pk_raws: list[bytes], message: bytes,
                              sig96: bytes, dst: bytes,
                              assume_valid: bool = False) -> int:
    """fast_aggregate_verify from cached raw affine pubkeys (96 bytes
    each, subgroup-checked at parse) — no per-key decompression sqrt."""
    return _lib().ec_bls_fast_aggregate_verify_raw(
        b"".join(bytes(p) for p in pk_raws), len(pk_raws),
        bytes(message), len(message), bytes(dst), len(dst),
        bytes(sig96), int(assume_valid),
    )


def aggregate_verify(pks: list[bytes], messages: list[bytes], sig96: bytes,
                     dst: bytes, assume_valid: bool = False) -> int:
    cat = b"".join(bytes(pk) for pk in pks)
    msgs = b"".join(bytes(m) for m in messages)
    lens = (_c.c_uint32 * len(messages))(*[len(m) for m in messages])
    return _lib().ec_bls_aggregate_verify(
        cat, len(pks), msgs, lens, bytes(dst), len(dst), bytes(sig96),
        int(assume_valid),
    )


def aggregate_signatures(sigs: list[bytes]) -> tuple[int, bytes]:
    out = _c.create_string_buffer(96)
    rc = _lib().ec_bls_aggregate_sigs(b"".join(bytes(s) for s in sigs), len(sigs), out)
    return rc, out.raw


def aggregate_public_keys(pks: list[bytes]) -> tuple[int, bytes]:
    out = _c.create_string_buffer(48)
    rc = _lib().ec_bls_aggregate_pubkeys(b"".join(bytes(p) for p in pks), len(pks), out)
    return rc, out.raw


def batch_verify(sets: list[tuple[list[bytes], bytes, bytes]], dst: bytes,
                 scalars16: list[bytes]) -> bool:
    """Each set is (pubkeys, message, signature); scalars16 are per-set
    16-byte big-endian nonzero blinders (caller-supplied randomness).
    True only if every set satisfies fast_aggregate_verify."""
    n = len(sets)
    if n == 0:
        return True
    counts = (_c.c_uint32 * n)(*[len(s[0]) for s in sets])
    pks = b"".join(bytes(pk) for s in sets for pk in s[0])
    msgs = b"".join(bytes(s[1]) for s in sets)
    mlens = (_c.c_uint32 * n)(*[len(s[1]) for s in sets])
    sigs = b"".join(bytes(s[2]) for s in sets)
    rand = b"".join(scalars16)
    if len(rand) != 16 * n:
        raise NativeBlsError("need one 16-byte scalar per set")
    rc = _lib().ec_bls_batch_verify(
        n, counts, pks, msgs, mlens, sigs, bytes(dst), len(dst), rand,
    )
    return rc == 1


def batch_verify_raw(sets: list[tuple[list[bytes], bytes, bytes]], dst: bytes,
                     scalars16: list[bytes]) -> bool:
    """Like ``batch_verify`` but each set's pubkeys are 96-byte RAW AFFINE
    points (x||y big-endian) whose subgroup membership the caller already
    established (PublicKey caches them after its parse-time check) —
    skips the per-set decompression sqrt, and the blinded signature sum
    runs as one Pippenger MSM native-side."""
    n = len(sets)
    if n == 0:
        return True
    counts = (_c.c_uint32 * n)(*[len(s[0]) for s in sets])
    pks = b"".join(bytes(pk) for s in sets for pk in s[0])
    msgs = b"".join(bytes(s[1]) for s in sets)
    mlens = (_c.c_uint32 * n)(*[len(s[1]) for s in sets])
    sigs = b"".join(bytes(s[2]) for s in sets)
    rand = b"".join(scalars16)
    if len(rand) != 16 * n:
        raise NativeBlsError("need one 16-byte scalar per set")
    rc = _lib().ec_bls_batch_verify_raw(
        n, counts, pks, msgs, mlens, sigs, bytes(dst), len(dst), rand,
    )
    return rc == 1


# -- raw-point utilities (KZG / device interop) -----------------------------


def g1_msm(points_raw: bytes, scalars32: bytes, n: int) -> tuple[bytes, bool]:
    out = _c.create_string_buffer(96)
    inf = _c.c_int(0)
    rc = _lib().ec_g1_msm(bytes(points_raw), bytes(scalars32), n, out, _c.byref(inf))
    if rc != 0:
        raise NativeBlsError(decode_error_message(rc))
    return out.raw, bool(inf.value)


def g2_msm(points_raw: bytes, scalars32: bytes, n: int) -> tuple[bytes, bool]:
    out = _c.create_string_buffer(192)
    inf = _c.c_int(0)
    rc = _lib().ec_g2_msm(bytes(points_raw), bytes(scalars32), n, out, _c.byref(inf))
    if rc != 0:
        raise NativeBlsError(decode_error_message(rc))
    return out.raw, bool(inf.value)


def g1_mul_raw(point_raw: bytes, is_inf: bool, scalar32: bytes) -> tuple[bytes, bool]:
    out = _c.create_string_buffer(96)
    inf = _c.c_int(0)
    rc = _lib().ec_g1_mul_raw(bytes(point_raw), int(is_inf), bytes(scalar32), out, _c.byref(inf))
    if rc != 0:
        raise NativeBlsError(decode_error_message(rc))
    return out.raw, bool(inf.value)


def g1_add_raw(a_raw: bytes, a_inf: bool, b_raw: bytes, b_inf: bool) -> tuple[bytes, bool]:
    out = _c.create_string_buffer(96)
    inf = _c.c_int(0)
    rc = _lib().ec_g1_add_raw(bytes(a_raw), int(a_inf), bytes(b_raw), int(b_inf), out, _c.byref(inf))
    if rc != 0:
        raise NativeBlsError(decode_error_message(rc))
    return out.raw, bool(inf.value)


def pairing_product_is_one_raw(g1_raws: list[tuple[bytes, bool]],
                               g2_raws: list[tuple[bytes, bool]]) -> bool:
    n = len(g1_raws)
    if len(g2_raws) != n:
        raise NativeBlsError("pairing product needs equal-length point lists")
    g1b = b"".join(bytes(r) for r, _ in g1_raws)
    g2b = b"".join(bytes(r) for r, _ in g2_raws)
    i1 = bytes(1 if inf else 0 for _, inf in g1_raws)
    i2 = bytes(1 if inf else 0 for _, inf in g2_raws)
    rc = _lib().ec_pairing_product_is_one_raw(g1b, i1, g2b, i2, n)
    if rc < 0:
        raise NativeBlsError(decode_error_message(rc))
    return rc == 1


def miller_loop_raw(g1_raw: bytes, g2_raw: bytes) -> bytes:
    """Single-pair Miller value, 576-byte raw Fq12 (device parity anchor)."""
    out = _c.create_string_buffer(576)
    rc = _lib().ec_miller_loop_raw(bytes(g1_raw), bytes(g2_raw), out)
    if rc != 0:
        raise NativeBlsError(decode_error_message(rc))
    return out.raw


def fp12_final_exp_is_one(f576: bytes) -> bool:
    """Final-exponentiation verdict on a raw Fq12 Miller product."""
    rc = _lib().ec_fp12_final_exp_is_one(bytes(f576))
    if rc < 0:
        raise NativeBlsError(decode_error_message(rc))
    return rc == 1


def fp8_active() -> bool:
    """True when the eight-wide AVX-512 IFMA field engine passed its init
    self-check and serves the batched sqrt chains (hash-to-G2 / G2
    decompression inside batch verification); False = scalar fallback."""
    return _lib().ec_fp8_active() == 1


def fp8_selftest(seed: int = 0, rounds: int = 50) -> int:
    """Randomized engine-vs-scalar cross-check (mul/add/sub/sqrt families).

    Returns 0 when every family agrees (or the engine is inactive); a
    nonzero code identifies the first failing family."""
    return _lib().ec_fp8_selftest(seed, rounds)


def g1_decompress_batch(
    keys: "list[bytes]", check_subgroup: bool = True
) -> "list[tuple[int, bytes, bool]]":
    """Bulk G1 decompression with the sqrt and subgroup chains batched
    eight keys wide; per-key (rc, raw96, is_infinity) triples identical
    to calling g1_decompress on each."""
    n = len(keys)
    if n == 0:
        return []
    out = _c.create_string_buffer(96 * n)
    rcs = (_c.c_int * n)()
    infs = (_c.c_int * n)()
    _lib().ec_g1_decompress_batch(
        b"".join(bytes(k) for k in keys), n, out, rcs, infs,
        int(check_subgroup),
    )
    raw = out.raw
    return [
        (rcs[i], raw[96 * i : 96 * i + 96], bool(infs[i])) for i in range(n)
    ]


class PreparedMsm:
    """Fixed-base G1 MSM handle: window shifts of static points (the KZG
    Lagrange setup) precomputed native-side so each later MSM is a single
    signed-digit bucket pass. Frees the native memory on GC."""

    __slots__ = ("_handle", "_n")

    def __init__(self, points_raw: bytes, n: int, window_bits: int = 12):
        handle = _lib().ec_g1_msm_prepare(bytes(points_raw), n, window_bits)
        if not handle:
            raise NativeBlsError("msm precompute failed (bad points?)")
        self._handle = handle
        self._n = n

    def run(self, scalars32: bytes) -> "tuple[bytes, bool]":
        """(raw96, is_infinity) of sum scalars[i] * P_i."""
        out = _c.create_string_buffer(96)
        inf = _c.c_int(0)
        rc = _lib().ec_g1_msm_prepared_run(
            self._handle, bytes(scalars32), self._n, out, _c.byref(inf)
        )
        if rc != 0:
            raise NativeBlsError(f"prepared msm failed rc={rc}")
        return out.raw, bool(inf.value)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle and _LIB is not None:
            _LIB.ec_g1_msm_prepared_free(handle)
            self._handle = None


def fr_eval_poly(evals32: bytes, roots32: bytes, n: int, z32: bytes) -> bytes:
    """Barycentric blob-polynomial evaluation at z over the brp domain
    (EIP-4844); raises on non-canonical input or unsupported domain."""
    y = _c.create_string_buffer(32)
    rc = _lib().ec_fr_eval_poly(bytes(evals32), bytes(roots32), n, bytes(z32), y)
    if rc != 0:
        raise NativeBlsError(f"fr_eval_poly rc={rc}")
    return y.raw


def fr_eval_and_quotient(
    evals32: bytes, roots32: bytes, n: int, z32: bytes
) -> "tuple[bytes, bytes]":
    """(y, quotient-evals) for the KZG proof at z — both branches of the
    quotient construction (on-domain L'Hopital column and off-domain)."""
    y = _c.create_string_buffer(32)
    q = _c.create_string_buffer(32 * n)
    rc = _lib().ec_fr_eval_and_quotient(
        bytes(evals32), bytes(roots32), n, bytes(z32), y, q
    )
    if rc != 0:
        raise NativeBlsError(f"fr_eval_and_quotient rc={rc}")
    return y.raw, q.raw


def fr_validate(evals32: bytes, n: int) -> bool:
    """True when every 32-byte big-endian scalar is canonical (< r)."""
    return _lib().ec_fr_validate(bytes(evals32), n) == 0
