"""KZG polynomial commitments for EIP-4844 blobs (deneb).

Reference parity: ethereum-consensus/src/crypto/kzg.rs — KzgSettings +
trusted-setup loading (:39), blob_to_kzg_commitment (:60),
compute_kzg_proof (:71), compute_blob_kzg_proof (:88), verify_kzg_proof
(:101), verify_blob_kzg_proof (:124), verify_blob_kzg_proof_batch (:139).
The reference wraps the c-kzg C library; here the polynomial math runs on
the from-scratch BLS12-381 stack (fields/curves/pairing), in the evaluation
(Lagrange, bit-reversal-permuted) form the EIP-4844 spec prescribes.

Trusted setups:
  - ``KzgSettings.from_json`` loads the standard c-kzg JSON layout
    (``g1_lagrange``/``g2_monomial``, or legacy ``setup_G1_lagrange``/
    ``setup_G2``) — use this with the published mainnet ceremony output.
  - ``KzgSettings.insecure_dev_setup(tau, n)`` derives a mathematically
    valid setup from a KNOWN secret — test-only by construction, and also
    the only way to get a small-domain setup for fast tests.
  - ``KzgSettings.ceremony()`` loads the mainnet ceremony from this
    package's own ``crypto/data/`` (both files byte-equal to the reference
    package's).

Ported from ethereum_consensus_tpu/crypto/kzg.py. The polynomial math stays
on the host in both packages: the native library's MSM, Fr evaluation and
pairing, or the pure-Python stack when ``EC_BLS_BACKEND`` selects it.
"""

from __future__ import annotations

import hashlib
import json

from ..error import KzgError
from ..native import bls as native_bls
from .curves import G1Point, G2Point, G1_GENERATOR, G2_GENERATOR, InvalidPointError
from .fields import R


def _native_on() -> bool:
    """KZG follows the BLS backend selection (EC_BLS_BACKEND)."""
    from . import bls as _bls

    return _bls.backend_name() == "native"


def _batch_inv(values: list[int]) -> list[int]:
    """Montgomery's trick: n field inversions for one modexp + 3n mults."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        if v % R == 0:
            raise KzgError("batch inversion of zero")
        prefix[i + 1] = prefix[i] * v % R
    inv_all = pow(prefix[n], R - 2, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % R
        inv_all = inv_all * values[i] % R
    return out

__all__ = [
    "FIELD_ELEMENTS_PER_BLOB",
    "BYTES_PER_FIELD_ELEMENT",
    "BYTES_PER_BLOB",
    "KzgCommitment",
    "KzgProof",
    "KzgSettings",
    "blob_to_kzg_commitment",
    "compute_kzg_proof",
    "compute_blob_kzg_proof",
    "verify_kzg_proof",
    "verify_blob_kzg_proof",
    "verify_blob_kzg_proof_batch",
]

FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_BLOB = FIELD_ELEMENTS_PER_BLOB * BYTES_PER_FIELD_ELEMENT

# Fiat-Shamir domains (EIP-4844 polynomial-commitments spec).
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"

# Fr multiplicative generator and 2-adicity for roots of unity.
_FR_GENERATOR = 7
_FR_TWO_ADICITY = 32

_CEREMONY = None  # process-wide cache of the embedded ceremony setup

# Pin of the pre-decompressed ceremony binary (rendered from the JSON by the
# reference package's native/_gen_trusted_setup.py);
# a mismatch falls back to the validated-JSON slow path, never to trust.
CEREMONY_AFFINE_MAGIC = b"ECTS\x01\x00"
CEREMONY_AFFINE_SHA256 = (
    "92199542ef523b03dbbbd1071709e21801a220161fb8374ebfeda64ed4b168c5"
)


def _roots_of_unity(order: int) -> list[int]:
    """The order-``order`` subgroup of Fr*, in natural order."""
    if order & (order - 1):
        raise KzgError("domain order must be a power of two")
    if order > 1 << _FR_TWO_ADICITY:
        raise KzgError("domain order exceeds Fr two-adicity")
    root = pow(_FR_GENERATOR, (R - 1) // order, R)
    out = [1]
    for _ in range(order - 1):
        out.append(out[-1] * root % R)
    return out


def _bit_reversal_permutation(values: list) -> list:
    n = len(values)
    bits = n.bit_length() - 1
    return [values[int(format(i, f"0{bits}b")[::-1], 2)] if bits else values[i] for i in range(n)]


class KzgCommitment(bytes):
    """48-byte compressed G1 commitment."""

    def __new__(cls, data: bytes):
        if len(data) != 48:
            raise KzgError("KZG commitment must be 48 bytes")
        return super().__new__(cls, data)


class KzgProof(bytes):
    """48-byte compressed G1 proof."""

    def __new__(cls, data: bytes):
        if len(data) != 48:
            raise KzgError("KZG proof must be 48 bytes")
        return super().__new__(cls, data)


class KzgSettings:
    """Trusted setup in the blob-native form: G1 points of the Lagrange
    basis over the bit-reversal-permuted evaluation domain, plus [1]_2 and
    [τ]_2."""

    def __init__(self, g1_lagrange_brp: list[G1Point], g2_monomial: list[G2Point]):
        n = len(g1_lagrange_brp)
        if n & (n - 1):
            raise KzgError("setup size must be a power of two")
        if len(g2_monomial) < 2:
            raise KzgError("setup needs at least [1]_2 and [tau]_2")
        self.g1_lagrange_brp = g1_lagrange_brp
        self.g2_monomial = g2_monomial
        self.n = n
        self.roots_brp = _bit_reversal_permutation(_roots_of_unity(n))
        self._g1_raw: bytes | None = None   # 96n-byte affine cache (native)
        self._g2_raw: list[bytes] | None = None

    def g1_raw(self) -> bytes:
        """Concatenated 96-byte raw affine setup points (native MSM input)."""
        if self._g1_raw is None:
            parts = []
            for pt in self.g1_lagrange_brp:
                rc, raw, is_inf = native_bls.g1_decompress(
                    pt.serialize(), check_subgroup=False
                )
                if rc != 0 or is_inf:
                    raise KzgError("setup point unusable for MSM")
                parts.append(raw)
            self._g1_raw = b"".join(parts)
        return self._g1_raw

    def g2_raw(self) -> list[bytes]:
        """Raw affine [1]_2 and [tau]_2 (native pairing input)."""
        if self._g2_raw is None:
            out = []
            for pt in self.g2_monomial[:2]:
                rc, raw, is_inf = native_bls.g2_decompress(
                    pt.serialize(), check_subgroup=False
                )
                if rc != 0 or is_inf:
                    raise KzgError("setup G2 point unusable for pairing")
                out.append(raw)
            self._g2_raw = out
        return self._g2_raw

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_json(cls, text: str) -> "KzgSettings":
        """Load the c-kzg JSON trusted-setup layout.

        Ceremony files list the Lagrange points in NATURAL domain order;
        the blob convention is bit-reversal-permuted, so the permutation is
        applied here (matching c-kzg's load-time behavior)."""
        obj = json.loads(text)
        g1 = obj.get("g1_lagrange") or obj.get("setup_G1_lagrange") or obj.get("setup_G1")
        g2 = obj.get("g2_monomial") or obj.get("setup_G2")
        if g1 is None or g2 is None:
            raise KzgError("unrecognized trusted setup JSON layout")

        if _native_on():
            # native decompress validates (curve + subgroup) and yields the
            # affine coordinates without a Python-side sqrt per point
            from .fields import Fq

            g1_points, g1_raws = [], []
            for h in g1:
                rc, raw, is_inf = native_bls.g1_decompress(
                    bytes.fromhex(h.removeprefix("0x")), check_subgroup=True
                )
                if rc != 0 or is_inf:
                    raise KzgError(
                        f"invalid point in trusted setup: "
                        f"{native_bls.decode_error_message(rc)}"
                    )
                g1_raws.append(raw)
                g1_points.append(G1Point.from_affine(
                    Fq(int.from_bytes(raw[:48], "big")),
                    Fq(int.from_bytes(raw[48:], "big")),
                ))
            try:
                g2_points = [
                    G2Point.deserialize(bytes.fromhex(h.removeprefix("0x")))
                    for h in g2
                ]
            except InvalidPointError as exc:
                raise KzgError(f"invalid point in trusted setup: {exc}") from exc
            settings = cls(
                _bit_reversal_permutation(g1_points), g2_points
            )
            settings._g1_raw = b"".join(_bit_reversal_permutation(g1_raws))
            return settings

        def parse_g1(h: str) -> G1Point:
            return G1Point.deserialize(bytes.fromhex(h.removeprefix("0x")))

        def parse_g2(h: str) -> G2Point:
            return G2Point.deserialize(bytes.fromhex(h.removeprefix("0x")))

        try:
            g1_points = [parse_g1(h) for h in g1]
            g2_points = [parse_g2(h) for h in g2]
        except InvalidPointError as exc:
            raise KzgError(f"invalid point in trusted setup: {exc}") from exc
        return cls(_bit_reversal_permutation(g1_points), g2_points)

    def to_json(self) -> str:
        """Dump in the c-kzg layout (natural domain order — inverse brp)."""
        natural = _bit_reversal_permutation(self.g1_lagrange_brp)  # involution
        return json.dumps(
            {
                "g1_lagrange": ["0x" + p.serialize().hex() for p in natural],
                "g2_monomial": ["0x" + p.serialize().hex() for p in self.g2_monomial],
            }
        )

    @classmethod
    def from_file(cls, path: str) -> "KzgSettings":
        with open(path) as f:
            return cls.from_json(f.read())

    @classmethod
    def _from_affine_bin(cls, blob: bytes) -> "KzgSettings":
        """Construct from the pre-decompressed binary: the magic, then the
        counts of G1 and G2 points (two little-endian u32), then each G1
        point's affine x and y (48 bytes each, big-endian, already in
        bit-reversal order) and each G2 point's x.c0, x.c1, y.c0, y.c1. No
        per-point validation — the caller pins the blob's sha256, and the
        blob was derived from the fully validated JSON."""
        import struct

        from .fields import Fq, Fq2

        if blob[:6] != CEREMONY_AFFINE_MAGIC:
            raise KzgError("bad trusted_setup_affine.bin magic")
        if len(blob) < 14:
            raise KzgError("truncated trusted_setup_affine.bin")
        n_g1, n_g2 = struct.unpack_from("<II", blob, 6)
        off = 14
        if len(blob) != off + 96 * n_g1 + 192 * n_g2:
            raise KzgError("truncated trusted_setup_affine.bin")
        g1_points = []
        for _ in range(n_g1):
            g1_points.append(G1Point.from_affine(
                Fq(int.from_bytes(blob[off:off + 48], "big")),
                Fq(int.from_bytes(blob[off + 48:off + 96], "big")),
            ))
            off += 96
        g1_raw = blob[14:off]
        g2_points, g2_raws = [], []
        for _ in range(n_g2):
            c = [int.from_bytes(blob[off + 48 * i:off + 48 * (i + 1)], "big")
                 for i in range(4)]
            g2_points.append(G2Point.from_affine(
                Fq2(Fq(c[0]), Fq(c[1])), Fq2(Fq(c[2]), Fq(c[3]))
            ))
            if len(g2_raws) < 2:  # g2_raw() only needs [1]_2 and [tau]_2
                g2_raws.append(blob[off:off + 192])
            off += 192
        # points arrive already bit-reversal-permuted — __init__ expects
        # exactly that order (it never re-permutes), so construct normally
        # and attach the raw-affine caches
        settings = cls(g1_points, g2_points)
        settings._g1_raw = g1_raw
        settings._g2_raw = g2_raws
        return settings

    @classmethod
    def ceremony(cls) -> "KzgSettings":
        """The published mainnet ceremony setup, embedded with the package
        (same artifact the reference embeds:
        ethereum-consensus/src/deneb/presets/trusted_setup.json, loaded at
        deneb/presets/mod.rs:10 / context.rs:206). Cached per process.

        Fast path: the pre-decompressed binary (sha256-pinned, rendered
        from the JSON) loads in
        tens of ms; the JSON + 4096 subgroup checks (seconds) is only the
        fallback when the binary is missing or does not match its pin."""
        global _CEREMONY
        if _CEREMONY is None:
            import os

            data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
            bin_path = os.path.join(data_dir, "trusted_setup_affine.bin")
            if os.path.exists(bin_path):
                with open(bin_path, "rb") as f:
                    blob = f.read()
                if hashlib.sha256(blob).hexdigest() == CEREMONY_AFFINE_SHA256:
                    _CEREMONY = cls._from_affine_bin(blob)
                    return _CEREMONY
            _CEREMONY = cls.from_file(os.path.join(data_dir, "trusted_setup.json"))
        return _CEREMONY

    @classmethod
    def insecure_dev_setup(cls, tau: int = 0x107A5, n: int = FIELD_ELEMENTS_PER_BLOB) -> "KzgSettings":
        """Derive a setup from the KNOWN secret ``tau`` — INSECURE, test-only.

        With tau known, the Lagrange values l_j(τ) are plain field scalars:
            l_j(τ) = w_j·(τ^n − 1) / (n·(τ − w_j))
        so the setup costs one scalar-mult per point instead of an MSM."""
        roots = _roots_of_unity(n)
        tau %= R
        if tau in roots or tau == 0:
            raise KzgError("pathological dev tau")
        tn1 = (pow(tau, n, R) - 1) % R
        n_inv = pow(n, R - 2, R)
        denom_inv = _batch_inv([(tau - w) % R for w in roots])
        lags = [w * tn1 % R * dinv % R * n_inv % R
                for w, dinv in zip(roots, denom_inv)]
        if _native_on():
            from .fields import Fq

            gen_raw = native_bls.g1_generator_raw()
            g1, raws = [], []
            for lj in lags:
                raw, is_inf = native_bls.g1_mul_raw(
                    gen_raw, False, lj.to_bytes(32, "big")
                )
                if is_inf:
                    raise KzgError("pathological dev tau")
                raws.append(raw)
                g1.append(G1Point.from_affine(
                    Fq(int.from_bytes(raw[:48], "big")),
                    Fq(int.from_bytes(raw[48:], "big")),
                ))
            settings = cls(
                _bit_reversal_permutation(g1),
                [G2_GENERATOR, G2_GENERATOR * tau],
            )
            settings._g1_raw = b"".join(_bit_reversal_permutation(raws))
            return settings
        g1 = [G1_GENERATOR * lj for lj in lags]
        g1_brp = _bit_reversal_permutation(g1)
        g2 = [G2_GENERATOR, G2_GENERATOR * tau]
        return cls(g1_brp, g2)


# ---------------------------------------------------------------------------
# field-element / blob codecs
# ---------------------------------------------------------------------------


def _fr_from_bytes(data: bytes) -> int:
    """Big-endian 32-byte scalar, must be canonical (< r)."""
    if len(data) != BYTES_PER_FIELD_ELEMENT:
        raise KzgError("field element must be 32 bytes")
    v = int.from_bytes(data, "big")
    if v >= R:
        raise KzgError("field element not canonical")
    return v


def _fr_to_bytes(v: int) -> bytes:
    return (v % R).to_bytes(BYTES_PER_FIELD_ELEMENT, "big")


def _blob_to_polynomial(blob: bytes, settings: KzgSettings) -> list[int]:
    expected = settings.n * BYTES_PER_FIELD_ELEMENT
    if len(blob) != expected:
        raise KzgError(f"blob must be {expected} bytes, got {len(blob)}")
    return [
        _fr_from_bytes(blob[i * 32 : (i + 1) * 32]) for i in range(settings.n)
    ]


def _hash_to_bls_field(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % R


# ---------------------------------------------------------------------------
# polynomial math (evaluation form over the brp domain)
# ---------------------------------------------------------------------------


# keyed by id() but ALSO holding the settings object: an entry must pin
# its owner alive, or a recycled id() could serve another setup's data.
# Bounded at a few slots (not cleared on each new setup) so a process
# alternating between two live setups — mainnet + minimal presets in one
# pytest session — doesn't rebuild the ~0.5s MSM tables on every switch.
_SETUP_CACHE_SLOTS = 4
_ROOTS_RAW: "dict[int, tuple]" = {}


def _roots_raw(settings: KzgSettings) -> bytes:
    hit = _ROOTS_RAW.get(id(settings))
    if hit is not None and hit[0] is settings:
        return hit[1]
    raw = b"".join(w.to_bytes(32, "big") for w in settings.roots_brp)
    if len(_ROOTS_RAW) >= _SETUP_CACHE_SLOTS:
        _ROOTS_RAW.pop(next(iter(_ROOTS_RAW)))  # FIFO evict oldest
    _ROOTS_RAW[id(settings)] = (settings, raw)
    return raw


def _evaluate_polynomial_in_evaluation_form(
    evals: list[int], z: int, settings: KzgSettings
) -> int:
    """Barycentric evaluation at z over the brp domain:
        p(z) = (z^n − 1)/n · Σ_i e_i·w_i/(z − w_i)
    with the in-domain short-circuit. Native Fr fast path when available
    (~25x over Python big ints at blob size); this Python body doubles
    as the cross-checked fallback."""
    n = settings.n
    z %= R
    if _native_on():
        try:
            y = native_bls.fr_eval_poly(
                b"".join(e.to_bytes(32, "big") for e in evals),
                _roots_raw(settings), n, z.to_bytes(32, "big"),
            )
            return int.from_bytes(y, "big")
        except native_bls.NativeBlsError:
            pass  # e.g. a non-power-of-two custom domain: Python below
    roots = settings.roots_brp
    for i, w in enumerate(roots):
        if z == w:
            return evals[i]
    inv_zw = _batch_inv([(z - w) % R for w in roots])
    total = 0
    for e, w, inv in zip(evals, roots, inv_zw):
        total = (total + e * w % R * inv) % R
    zn1 = (pow(z, n, R) - 1) % R
    n_inv = pow(n, R - 2, R)
    return total * zn1 % R * n_inv % R


def _g1_lincomb(points: list[G1Point], scalars: list[int]) -> G1Point:
    """Σ s_i·P_i (naive; the native Pippenger MSM replaces this when on)."""
    acc = G1Point.infinity()
    for p, s in zip(points, scalars):
        s %= R
        if s == 0:
            continue
        acc = acc + p * s
    return acc


_MSM_PREPARED: "dict[int, object]" = {}


def _setup_lincomb(settings: KzgSettings, scalars: list[int]) -> bytes:
    """Σ s_i·L_i over the setup's Lagrange points, as compressed G1 bytes —
    the MSM hot path. The setup is FIXED, so the first call precomputes
    window-shifted copies of every Lagrange point native-side and each
    later commitment/proof is a single signed-digit bucket pass (~1.6x
    over windowed Pippenger at blob size)."""
    if _native_on():
        return _setup_lincomb_raw(
            settings, b"".join((s % R).to_bytes(32, "big") for s in scalars)
        )
    return _g1_lincomb(settings.g1_lagrange_brp, scalars).serialize()


def _setup_lincomb_raw(settings: KzgSettings, sc: bytes) -> bytes:
    """Native-only variant taking pre-serialized 32-byte scalars (the
    native quotient builder emits exactly this layout)."""
    hit = _MSM_PREPARED.get(id(settings))
    if hit is not None and hit[0] is settings:
        pre = hit[1]
    else:
        try:
            pre = native_bls.PreparedMsm(settings.g1_raw(), settings.n)
        except native_bls.NativeBlsError:
            pre = False  # precompute unavailable: plain Pippenger
        if len(_MSM_PREPARED) >= _SETUP_CACHE_SLOTS:
            _MSM_PREPARED.pop(next(iter(_MSM_PREPARED)))  # FIFO evict
        _MSM_PREPARED[id(settings)] = (settings, pre)
    if pre:
        raw, is_inf = pre.run(sc)
    else:
        raw, is_inf = native_bls.g1_msm(settings.g1_raw(), sc, settings.n)
    return native_bls.g1_compress_raw(raw, is_inf)


def _g1_raw_neg(raw: bytes) -> bytes:
    from .fields import P as _P

    y = int.from_bytes(raw[48:], "big")
    return raw[:48] + ((_P - y) % _P).to_bytes(48, "big")


def _decompress_or_kzg_error(data: bytes, what: str) -> tuple[bytes, bool]:
    rc, raw, is_inf = native_bls.g1_decompress(bytes(data), check_subgroup=True)
    if rc != 0:
        raise KzgError(f"invalid {what}: {native_bls.decode_error_message(rc)}")
    return raw, is_inf


# ---------------------------------------------------------------------------
# public KZG operations (EIP-4844 semantics)
# ---------------------------------------------------------------------------


def _check_blob(blob: bytes, settings: KzgSettings) -> bytes:
    """Length + canonicality gate for the native blob-direct fast paths
    (blob bytes ARE the evaluation-form scalars — no int round-trip)."""
    blob = bytes(blob)
    expected = settings.n * BYTES_PER_FIELD_ELEMENT
    if len(blob) != expected:
        raise KzgError(f"blob must be {expected} bytes, got {len(blob)}")
    if not native_bls.fr_validate(blob, settings.n):
        raise KzgError("field element not canonical")
    return blob


def blob_to_kzg_commitment(blob: bytes, settings: KzgSettings) -> KzgCommitment:
    if _native_on():
        return KzgCommitment(_setup_lincomb_raw(settings, _check_blob(blob, settings)))
    evals = _blob_to_polynomial(blob, settings)
    return KzgCommitment(_setup_lincomb(settings, evals))


def compute_kzg_proof(blob: bytes, z_bytes: bytes, settings: KzgSettings) -> tuple[KzgProof, bytes]:
    """Returns (proof, y_bytes) for evaluation at z (kzg.rs:71)."""
    z = _fr_from_bytes(z_bytes)
    if _native_on():
        blob_proof = _compute_kzg_proof_from_blob(blob, z, settings)
        if blob_proof is not None:
            proof, y_b = blob_proof
            return proof, y_b
    evals = _blob_to_polynomial(blob, settings)
    proof, y = _compute_kzg_proof_impl(evals, z, settings)
    return proof, _fr_to_bytes(y)


def _compute_kzg_proof_from_blob(
    blob: bytes, z: int, settings: KzgSettings
) -> "tuple[KzgProof, bytes] | None":
    """Native blob-direct proof: the quotient scalars come back in MSM
    wire layout, untouched by Python ints. None = fall back (e.g. a
    non-power-of-two custom domain)."""
    blob = _check_blob(blob, settings)
    try:
        y_b, q_b = native_bls.fr_eval_and_quotient(
            blob, _roots_raw(settings), settings.n, (z % R).to_bytes(32, "big")
        )
    except native_bls.NativeBlsError:
        return None
    return KzgProof(_setup_lincomb_raw(settings, q_b)), y_b


def _compute_kzg_proof_impl(
    evals: list[int], z: int, settings: KzgSettings
) -> tuple[KzgProof, int]:
    n = settings.n
    if _native_on():
        try:
            y_b, q_b = native_bls.fr_eval_and_quotient(
                b"".join(e.to_bytes(32, "big") for e in evals),
                _roots_raw(settings), n, (z % R).to_bytes(32, "big"),
            )
            return (
                KzgProof(_setup_lincomb_raw(settings, q_b)),
                int.from_bytes(y_b, "big"),
            )
        except native_bls.NativeBlsError:
            pass  # non-power-of-two custom domain: Python path below
    roots = settings.roots_brp
    y = _evaluate_polynomial_in_evaluation_form(evals, z, settings)

    # quotient q(X) = (p(X) − y)/(X − z) in evaluation form
    q = [0] * n
    if z in roots:
        # z on the domain: use the L'Hôpital-style special column
        m = roots.index(z)
        others = [i for i in range(n) if i != m]
        inv_wz = _batch_inv([(roots[i] - z) % R for i in others])
        inv_zzw = _batch_inv([z * (z - roots[i]) % R for i in others])
        acc = 0
        for i, iwz, izzw in zip(others, inv_wz, inv_zzw):
            q[i] = (evals[i] - y) % R * iwz % R
            # q_m = Σ_{i≠m} (e_i − y)·w_i / (z·(z − w_i))
            acc = (acc + (evals[i] - y) % R * roots[i] % R * izzw) % R
        q[m] = acc
    else:
        inv_wz = _batch_inv([(w - z) % R for w in roots])
        for i in range(n):
            q[i] = (evals[i] - y) % R * inv_wz[i] % R

    return KzgProof(_setup_lincomb(settings, q)), y


def verify_kzg_proof(
    commitment: bytes, z_bytes: bytes, y_bytes: bytes, proof: bytes, settings: KzgSettings
) -> bool:
    """Pairing check e(P − y·g1, g2) == e(proof, [τ]_2 − z·g2) (kzg.rs:101)."""
    z = _fr_from_bytes(z_bytes)
    y = _fr_from_bytes(y_bytes)
    return _verify_kzg_proof_bytes(bytes(commitment), z, y, bytes(proof), settings)


def _verify_kzg_proof_bytes(
    commitment: bytes, z: int, y: int, proof: bytes, settings: KzgSettings
) -> bool:
    if _native_on():
        c_raw, c_inf = _decompress_or_kzg_error(commitment, "commitment")
        p_raw, p_inf = _decompress_or_kzg_error(proof, "proof")
        # p_minus_y = C + (−y)·g1
        yg, yg_inf = native_bls.g1_mul_raw(
            native_bls.g1_generator_raw(), False, ((-y) % R).to_bytes(32, "big")
        )
        pm, pm_inf = native_bls.g1_add_raw(c_raw, c_inf, yg, yg_inf)
        # x_minus_z = [τ]_2 + (−z)·[1]_2
        g2r = settings.g2_raw()
        xz, xz_inf = native_bls.g2_msm(
            g2r[1] + g2r[0],
            (1).to_bytes(32, "big") + ((-z) % R).to_bytes(32, "big"),
            2,
        )
        neg_pm = pm if pm_inf else _g1_raw_neg(pm)
        return native_bls.pairing_product_is_one_raw(
            [(neg_pm, pm_inf), (p_raw, p_inf)],
            [(g2r[0], False), (xz, xz_inf)],
        )
    try:
        c = G1Point.deserialize(commitment)
        pi = G1Point.deserialize(proof)
    except InvalidPointError as exc:
        raise KzgError(str(exc)) from exc
    return _verify_kzg_proof_impl(c, z, y, pi, settings)


def _verify_kzg_proof_impl(
    commitment: G1Point, z: int, y: int, proof: G1Point, settings: KzgSettings
) -> bool:
    from .pairing import pairing_product_is_one

    g2 = settings.g2_monomial[0]
    tau_g2 = settings.g2_monomial[1]
    p_minus_y = commitment - G1_GENERATOR * y
    x_minus_z = tau_g2 - g2 * z
    # e(P − y, −g2) · e(proof, [τ−z]_2) == 1
    return pairing_product_is_one([(-p_minus_y, g2), (proof, x_minus_z)])


def _compute_challenge(blob: bytes, commitment: bytes, settings: KzgSettings) -> int:
    """Fiat-Shamir challenge binding blob+commitment (spec compute_challenge)."""
    degree_poly = settings.n.to_bytes(16, "big")
    return _hash_to_bls_field(
        FIAT_SHAMIR_PROTOCOL_DOMAIN + degree_poly + blob + bytes(commitment)
    )


def compute_blob_kzg_proof(
    blob: bytes, commitment: bytes, settings: KzgSettings
) -> KzgProof:
    if _native_on():
        _decompress_or_kzg_error(bytes(commitment), "commitment")
    else:
        try:
            G1Point.deserialize(bytes(commitment))  # validate before transcript
        except InvalidPointError as exc:
            raise KzgError(f"invalid commitment: {exc}") from exc
    z = _compute_challenge(blob, commitment, settings)
    if _native_on():
        blob_proof = _compute_kzg_proof_from_blob(blob, z, settings)
        if blob_proof is not None:
            return blob_proof[0]
    evals = _blob_to_polynomial(blob, settings)
    proof, _ = _compute_kzg_proof_impl(evals, z, settings)
    return proof


def _evaluate_blob_at(blob: bytes, z: int, settings: KzgSettings) -> int:
    """p(z) from the raw blob bytes: native blob-direct when available,
    Python int path otherwise (identical semantics and errors)."""
    if _native_on():
        try:
            y = native_bls.fr_eval_poly(
                _check_blob(blob, settings), _roots_raw(settings),
                settings.n, (z % R).to_bytes(32, "big"),
            )
            return int.from_bytes(y, "big")
        except native_bls.NativeBlsError:
            pass  # non-power-of-two custom domain
    evals = _blob_to_polynomial(blob, settings)
    return _evaluate_polynomial_in_evaluation_form(evals, z, settings)


def verify_blob_kzg_proof(
    blob: bytes, commitment: bytes, proof: bytes, settings: KzgSettings
) -> bool:
    z = _compute_challenge(blob, commitment, settings)
    y = _evaluate_blob_at(blob, z, settings)
    return _verify_kzg_proof_bytes(bytes(commitment), z, y, bytes(proof), settings)


def verify_blob_kzg_proof_batch(
    blobs: list[bytes],
    commitments: list[bytes],
    proofs: list[bytes],
    settings: KzgSettings,
) -> bool:
    """Random-linear-combination batch verification (kzg.rs:139): one
    two-pairing check regardless of batch size."""
    if not (len(blobs) == len(commitments) == len(proofs)):
        raise KzgError("batch length mismatch")
    if not blobs:
        return True
    if len(blobs) == 1:
        return verify_blob_kzg_proof(blobs[0], commitments[0], proofs[0], settings)

    cs = pis = None
    if _native_on():
        c_raws = [_decompress_or_kzg_error(bytes(c), "commitment") for c in commitments]
        p_raws = [_decompress_or_kzg_error(bytes(p), "proof") for p in proofs]
    else:
        try:
            cs = [G1Point.deserialize(bytes(c)) for c in commitments]
            pis = [G1Point.deserialize(bytes(p)) for p in proofs]
        except InvalidPointError as exc:
            raise KzgError(str(exc)) from exc

    zs, ys = [], []
    for blob, commitment in zip(blobs, commitments):
        z = _compute_challenge(blob, commitment, settings)
        zs.append(z)
        ys.append(_evaluate_blob_at(blob, z, settings))

    # r-powers from a transcript binding every (commitment, z, y, proof)
    data = RANDOM_CHALLENGE_KZG_BATCH_DOMAIN
    data += settings.n.to_bytes(8, "big")
    data += len(blobs).to_bytes(8, "big")
    for c, z, y, p in zip(commitments, zs, ys, proofs):
        data += bytes(c) + _fr_to_bytes(z) + _fr_to_bytes(y) + bytes(p)
    r = _hash_to_bls_field(data)
    r_powers = [1]
    for _ in range(len(blobs) - 1):
        r_powers.append(r_powers[-1] * r % R)

    if _native_on():
        # Σ r_i(C_i − y_i·g1) = Σ r_i·C_i − (Σ r_i·y_i)·g1; all finite inputs
        # (decompress above rejects nothing silently; infinity C/π handled
        # by padding the MSM input with zero scalars)
        def msm(raws_inf, scalars):
            finite = [(raw, s) for (raw, inf), s in zip(raws_inf, scalars) if not inf]
            if not finite:
                return bytes(96), True
            return native_bls.g1_msm(
                b"".join(r for r, _ in finite),
                b"".join((s % R).to_bytes(32, "big") for _, s in finite),
                len(finite),
            )

        proof_l, proof_l_inf = msm(p_raws, r_powers)
        proof_z_l, proof_z_l_inf = msm(
            p_raws, [rp * z % R for rp, z in zip(r_powers, zs)]
        )
        c_l, c_l_inf = msm(c_raws, r_powers)
        sum_ry = sum(rp * y % R for rp, y in zip(r_powers, ys)) % R
        yg, yg_inf = native_bls.g1_mul_raw(
            native_bls.g1_generator_raw(), False, ((-sum_ry) % R).to_bytes(32, "big")
        )
        cy_l, cy_l_inf = native_bls.g1_add_raw(c_l, c_l_inf, yg, yg_inf)
        lhs, lhs_inf = native_bls.g1_add_raw(cy_l, cy_l_inf, proof_z_l, proof_z_l_inf)
        neg_lhs = lhs if lhs_inf else _g1_raw_neg(lhs)
        g2r = settings.g2_raw()
        return native_bls.pairing_product_is_one_raw(
            [(neg_lhs, lhs_inf), (proof_l, proof_l_inf)],
            [(g2r[0], False), (g2r[1], False)],
        )

    proof_lincomb = _g1_lincomb(pis, r_powers)
    proof_z_lincomb = _g1_lincomb(
        pis, [rp * z % R for rp, z in zip(r_powers, zs)]
    )
    c_minus_y = [c - G1_GENERATOR * y for c, y in zip(cs, ys)]
    c_minus_y_lincomb = _g1_lincomb(c_minus_y, r_powers)

    from .pairing import pairing_product_is_one

    g2 = settings.g2_monomial[0]
    tau_g2 = settings.g2_monomial[1]
    lhs = c_minus_y_lincomb + proof_z_lincomb
    return pairing_product_is_one([(-lhs, g2), (proof_lincomb, tau_g2)])
