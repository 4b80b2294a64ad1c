"""BLS signatures over BLS12-381 (min_pk: public keys in G1, signatures in
G2), with the Ethereum consensus-layer semantics.

Reference parity: ethereum-consensus/src/crypto/bls.rs — SecretKey/PublicKey/
Signature types, sign, verify_signature (:64-112), aggregate,
aggregate_verify, fast_aggregate_verify (:114), eth_aggregate_public_keys
(:135), eth_fast_aggregate_verify (:150, the infinity-signature rule), and
the SHA-256 `hash` helper (:12).

Two backends, same semantics:
  * native — the from-scratch C++ library (native/bls12_381.cpp), playing
    exactly blst's role for the reference (Cargo.toml:22). Default when a
    toolchain is present; ~300x the oracle per verify.
  * python — the pure-Python oracle (fields/curves/pairing/hash_to_curve),
    kept as the transparent correctness reference.
The backend is native whenever ``native.bls.available()`` (a ``g++`` on
the machine); the tests cross-check the two.

Batched verification: `verify_signature_sets` checks N independent
(pubkeys, message, signature) sets with one random-linear-combination
multi-pairing (N+1 Miller loops, ONE final exponentiation) and falls back
to per-set verification only to attribute failures. Above
``_device_flags.BLS_AGG_MIN_N`` keys the per-set pubkey aggregation runs as
one launch of the CUDA G1 kernel (ops/g1.py); from
``_device_flags.PAIRING_MIN_SETS`` sets on, the blinder multiplications,
Miller loops and their product run in the CUDA pairing kernels
(ops/pairing.py) and the native library gives the final-exponentiation
verdict. A device failure raises: no route answers for another.
"""

from __future__ import annotations

import hashlib
import secrets
import threading

from .. import _device_flags
from ..error import (
    InvalidPublicKeyError,
    InvalidSecretKeyError,
    InvalidSignatureError,
)
from ..native import bls as native_bls
from ..telemetry import device as _device_obs
from ..telemetry import metrics as _metrics
from ..utils import trace
from .curves import (
    G1_GENERATOR,
    G1Point,
    G2Point,
    InvalidPointError,
)
from .fields import R
from .hash_to_curve import ETH_DST, hash_to_g2
from .pairing import pairing_product_is_one

__all__ = [
    "SecretKey",
    "PublicKey",
    "Signature",
    "SignatureSet",
    "hash",
    "aggregate",
    "aggregate_verify",
    "fast_aggregate_verify",
    "eth_aggregate_public_keys",
    "eth_fast_aggregate_verify",
    "verify_signature",
    "verify_signature_sets",
    "verify_signature_sets_async",
    "warm_pubkey_cache",
    "warm_raw_keys",
    "backend_name",
    "last_batch_route",
    "SECRET_KEY_SIZE",
    "PUBLIC_KEY_SIZE",
    "SIGNATURE_SIZE",
]

SECRET_KEY_SIZE = 32
PUBLIC_KEY_SIZE = 48
SIGNATURE_SIZE = 96

_INFINITY_FLAG = 0x40

_BACKEND: str | None = None
# guards the one-time backend resolution; reads stay lock-free — after the
# first store the value never changes.
_BACKEND_LOCK = threading.Lock()

# which route proved each batched verification, counted, and the newest one
# on each thread ("device", "host", or None when no RLC batch ran since the
# thread's last verify_signature_sets call)
_ROUTE_DEVICE = _metrics.counter("bls.pairing_route.device")
_ROUTE_HOST = _metrics.counter("bls.pairing_route.host")
_ROUTE_TL = threading.local()


def _note_pairing_route(choice: str, reason: str, n_sets: int) -> None:
    """Record one batch verification's route: the counter, the
    thread-local stamp, and the device observatory's routing journal with
    the threshold inputs (only while observing)."""
    (_ROUTE_DEVICE if choice == "device" else _ROUTE_HOST).inc()
    _ROUTE_TL.route = choice
    if _device_obs.OBSERVATORY.active:
        _device_obs.route(
            "pairing",
            choice,
            reason,
            sets=n_sets,
            threshold=_device_flags.PAIRING_MIN_SETS,
        )


def last_batch_route() -> "str | None":
    """The route ("device" or "host") of the newest batched verification
    on the calling thread, or None if none ran (single sets and the
    per-set blame verify on the host without the RLC batch)."""
    return getattr(_ROUTE_TL, "route", None)


# one-shot state for _device_decline: last exception type per kind, so a
# changed failure cause re-arms the trace event
_DECLINE_LOCK = threading.Lock()
_DECLINE_LAST: "dict[str, str]" = {}


def _device_decline(kind: str, exc: BaseException) -> None:
    """Journal one failure of a device route before the caller re-raises
    it: counter, routing journal (choice ``raised``: the port answers no
    route with another) and a one-shot trace event, re-armed when the
    exception type changes."""
    _metrics.counter(f"bls.device_decline.{kind}").inc()
    cause = type(exc).__name__
    if _device_obs.OBSERVATORY.active:
        _device_obs.route("bls_device", "raised", kind, cause=cause)
    with _DECLINE_LOCK:
        armed = _DECLINE_LAST.get(kind) != cause
        _DECLINE_LAST[kind] = cause
    if armed:
        trace.event("bls.device_decline", kind=kind, cause=cause)


def backend_name() -> str:
    """Active backend: "native" when the C++ library builds, else "python"."""
    global _BACKEND
    if _BACKEND is None:
        with _BACKEND_LOCK:
            if _BACKEND is None:
                _BACKEND = "native" if native_bls.available() else "python"
    return _BACKEND


def _native() -> bool:
    return backend_name() == "native"


def hash(data: bytes) -> bytes:  # noqa: A001 - mirrors crypto::hash
    """SHA-256 (crypto/bls.rs:12-20)."""
    return hashlib.sha256(data).digest()


class SecretKey:
    """Scalar in [1, r-1]. (bls.rs SecretKey)"""

    __slots__ = ("_scalar",)

    def __init__(self, scalar: int):
        if not 0 < scalar < R:
            raise InvalidSecretKeyError("secret key scalar out of range")
        self._scalar = scalar

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        if len(data) != SECRET_KEY_SIZE:
            raise InvalidSecretKeyError(
                f"secret key must be {SECRET_KEY_SIZE} bytes, got {len(data)}"
            )
        return cls(int.from_bytes(data, "big"))

    @classmethod
    def random(cls) -> "SecretKey":
        # 384-bit draw reduced mod r: bias < 2^-129 (the RFC 9380
        # hash_to_field approach), unlike a 255-bit draw which skews
        # low scalars by 1.5x.
        while True:
            candidate = int.from_bytes(secrets.token_bytes(48), "big") % R
            if candidate != 0:
                return cls(candidate)

    def to_bytes(self) -> bytes:
        return self._scalar.to_bytes(SECRET_KEY_SIZE, "big")

    def public_key(self) -> "PublicKey":
        if _native():
            return PublicKey._from_valid_bytes(native_bls.sk_to_pk(self.to_bytes()))
        return PublicKey(G1_GENERATOR * self._scalar)

    def sign(self, message: bytes, dst: bytes = ETH_DST) -> "Signature":
        if _native():
            return Signature._from_valid_bytes(
                native_bls.sign(self.to_bytes(), message, dst)
            )
        return Signature(hash_to_g2(message, dst) * self._scalar)

    def __repr__(self) -> str:
        return "SecretKey(...)"  # never print key material

    def __eq__(self, other) -> bool:
        return isinstance(other, SecretKey) and self._scalar == other._scalar

    __hash__ = None


# process-wide decompressed-pubkey cache (FIFO eviction): compressed48 →
# affine raw96 of a VALID key. Entries enter ONLY from from_bytes'
# subgroup-checked, identity-rejecting decompression, so a hit proves
# validity; raw_uncompressed (which skips the subgroup check and accepts
# identity aggregates) reads but never writes it. ~15MB at capacity.
_RAW_PK_CACHE: "dict[bytes, bytes]" = {}
_RAW_PK_CACHE_MAX = 1 << 16
# inserts/evictions serialize: an unlocked FIFO evict (pop of the first
# iter key) can race into KeyError. Reads stay lock-free — dict get is
# atomic.
_PK_CACHE_LOCK = threading.Lock()


def _pk_cache_put(data: bytes, raw: bytes) -> None:
    with _PK_CACHE_LOCK:
        while len(_RAW_PK_CACHE) >= _RAW_PK_CACHE_MAX:
            try:
                _RAW_PK_CACHE.pop(next(iter(_RAW_PK_CACHE)))
            except (KeyError, StopIteration):  # pragma: no cover - defensive
                break
        _RAW_PK_CACHE[data] = raw


def warm_pubkey_cache(keys) -> None:
    """Bulk-fill the decompressed-pubkey cache: every uncached key in
    ``keys`` (48-byte compressed) decompresses through the native
    eight-wide sqrt + subgroup chains in one call, so a following stream
    of PublicKey.from_bytes calls — a committee's attesters, a sync
    committee — is all cache hits. Invalid or identity keys are simply
    not cached; from_bytes raises the precise error when the key is
    actually used. No-op on the pure-Python backend."""
    if not _native():
        return
    todo = list(dict.fromkeys(
        bytes(k) for k in keys if bytes(k) not in _RAW_PK_CACHE
    ))
    if len(todo) < 8:  # below the lane width there is nothing to win
        return
    for rc_raw_inf, key in zip(
        native_bls.g1_decompress_batch(todo, check_subgroup=True), todo
    ):
        rc, raw, is_inf = rc_raw_inf
        if rc == 0 and not is_inf:
            _pk_cache_put(key, raw)


class PublicKey:
    """G1 point, 48-byte compressed. Infinity is rejected at parse time
    (blst key_validate semantics); an *aggregate* of valid keys may still
    be the identity (it then never verifies).

    Holds either a decoded G1Point, validated compressed bytes, or both;
    the point decodes lazily so the native fast path never pays for it.
    The decompressed affine form (``raw_uncompressed``) is cached after
    first use — decompression costs a field sqrt + subgroup check, and the
    chain workload re-verifies the same validator keys every block."""

    __slots__ = ("_point", "_bytes", "_raw")

    def __init__(self, point: G1Point):
        self._point = point
        self._bytes = None
        self._raw = None

    @classmethod
    def _from_valid_bytes(cls, data: bytes) -> "PublicKey":
        self = cls.__new__(cls)
        self._point = None
        self._bytes = bytes(data)
        self._raw = None
        return self

    def raw_uncompressed(self) -> bytes:
        """Affine x||y (96 bytes, big-endian), decompressed once and
        cached — on the instance, consulting the process-wide
        FIFO-evicted cache keyed by compressed bytes, because the chain
        workload rebuilds PublicKey objects from state bytes every block
        for the SAME validators. Native backend only (callers gate on
        it)."""
        if self._raw is None:
            data = self.to_bytes()
            hit = _RAW_PK_CACHE.get(data)
            if hit is not None:
                self._raw = hit
                return hit
            rc, raw, is_inf = native_bls.g1_decompress(
                data, check_subgroup=False
            )
            if rc != 0:
                raise InvalidPublicKeyError(native_bls.decode_error_message(rc))
            self._raw = b"\x00" * 96 if is_inf else raw
            # deliberately NOT inserted into _RAW_PK_CACHE: this path
            # skips the subgroup check and accepts identity (aggregate
            # results are legitimately reachable here), so its entries
            # must never satisfy from_bytes' validation
        return self._raw

    @classmethod
    def from_validated_bytes(cls, data: bytes) -> "PublicKey":
        """Trusted parse for keys from a source that only admits valid
        keys — the beacon registry: a deposit whose pubkey is not a
        valid subgroup point cannot carry a valid deposit signature, so
        it never joins, and validator pubkeys are immutable afterwards.

        Skips the eager native decompression ``from_bytes`` pays; the
        affine form materializes lazily at verification time
        (``raw_uncompressed``), where
        uncached keys go through the eight-wide bulk decompression
        (``warm_raw_keys``) instead of a per-key sqrt at collection
        time. Length and the infinity encoding are still rejected here
        (flag-byte check), so a corrupted registry fails loudly at the
        call site."""
        data = bytes(data)
        if len(data) != PUBLIC_KEY_SIZE:
            raise InvalidPublicKeyError(
                f"public key must be {PUBLIC_KEY_SIZE} bytes, got {len(data)}"
            )
        if data[0] & _INFINITY_FLAG:
            raise InvalidPublicKeyError("public key cannot be the identity")
        if not _native():
            return cls.from_bytes(data)  # no lazy raw path in the oracle
        self = cls._from_valid_bytes(data)
        self._raw = _RAW_PK_CACHE.get(data)
        return self

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        data = bytes(data)
        if len(data) != PUBLIC_KEY_SIZE:
            raise InvalidPublicKeyError(
                f"public key must be {PUBLIC_KEY_SIZE} bytes, got {len(data)}"
            )
        if _native():
            cached_raw = _RAW_PK_CACHE.get(data)
            if cached_raw is not None:
                # a cache hit was subgroup-checked when it entered
                self = cls._from_valid_bytes(data)
                self._raw = cached_raw
                return self
            rc, raw, is_inf = native_bls.g1_decompress(data, check_subgroup=True)
            if rc != 0:
                raise InvalidPublicKeyError(native_bls.decode_error_message(rc))
            if is_inf:
                raise InvalidPublicKeyError("public key cannot be the identity")
            self = cls._from_valid_bytes(data)
            self._raw = raw
            _pk_cache_put(data, raw)
            return self
        try:
            point = G1Point.deserialize(data)
        except InvalidPointError as exc:
            raise InvalidPublicKeyError(str(exc)) from exc
        if point.is_infinity():
            raise InvalidPublicKeyError("public key cannot be the identity")
        return cls(point)

    @property
    def point(self) -> G1Point:
        if self._point is None:
            self._point = G1Point.deserialize(self._bytes)
        return self._point

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            self._bytes = self._point.serialize()
        return self._bytes

    def is_infinity(self) -> bool:
        if self._bytes is not None:
            return bool(self._bytes[0] & _INFINITY_FLAG)
        return self._point.is_infinity()

    def validate(self) -> None:
        if self.is_infinity():
            raise InvalidPublicKeyError("public key cannot be the identity")
        if self._point is not None:
            if not self._point.is_on_curve() or not self._point.in_subgroup():
                raise InvalidPublicKeyError("public key not in G1 subgroup")
        # bytes-only keys were subgroup-checked when parsed/constructed

    def __eq__(self, other) -> bool:
        return isinstance(other, PublicKey) and self.to_bytes() == other.to_bytes()

    def __hash__(self):
        # NB: bare `hash` in this module is the SHA-256 helper
        return self.to_bytes().__hash__()

    def __repr__(self) -> str:
        return f"PublicKey(0x{self.to_bytes().hex()})"


class Signature:
    """G2 point, 96-byte compressed. The identity encoding is accepted at
    parse time (it is needed for the eth_fast_aggregate_verify rule) but
    never verifies against a real message/pubkey pair."""

    __slots__ = ("_point", "_bytes", "_raw")

    def __init__(self, point: G2Point):
        self._point = point
        self._bytes = None
        self._raw = None

    @classmethod
    def _from_valid_bytes(cls, data: bytes) -> "Signature":
        self = cls.__new__(cls)
        self._point = None
        self._bytes = bytes(data)
        self._raw = None
        return self

    def raw_uncompressed(self) -> bytes:
        """Affine x.c0||x.c1||y.c0||y.c1 (192 bytes, big-endian), cached.
        Subgroup membership was established at parse time; all-zero for
        the identity. Native backend only (callers gate on it)."""
        if self._raw is None:
            rc, raw, is_inf = native_bls.g2_decompress(
                self.to_bytes(), check_subgroup=False
            )
            if rc != 0:
                raise InvalidSignatureError(native_bls.decode_error_message(rc))
            self._raw = b"\x00" * 192 if is_inf else raw
        return self._raw

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        data = bytes(data)
        if len(data) != SIGNATURE_SIZE:
            raise InvalidSignatureError(
                f"signature must be {SIGNATURE_SIZE} bytes, got {len(data)}"
            )
        if _native():
            rc, _raw, _is_inf = native_bls.g2_decompress(data, check_subgroup=True)
            if rc != 0:
                raise InvalidSignatureError(native_bls.decode_error_message(rc))
            return cls._from_valid_bytes(data)
        try:
            return cls(G2Point.deserialize(data))
        except InvalidPointError as exc:
            raise InvalidSignatureError(str(exc)) from exc

    @property
    def point(self) -> G2Point:
        if self._point is None:
            self._point = G2Point.deserialize(self._bytes)
        return self._point

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            self._bytes = self._point.serialize()
        return self._bytes

    def is_infinity(self) -> bool:
        if self._bytes is not None:
            return bool(self._bytes[0] & _INFINITY_FLAG)
        return self._point.is_infinity()

    def __eq__(self, other) -> bool:
        return isinstance(other, Signature) and self.to_bytes() == other.to_bytes()

    def __hash__(self):
        # NB: bare `hash` in this module is the SHA-256 helper
        return self.to_bytes().__hash__()

    def __repr__(self) -> str:
        return f"Signature(0x{self.to_bytes().hex()})"


# ---------------------------------------------------------------------------
# Verification primitives
# ---------------------------------------------------------------------------


def warm_raw_keys(public_keys) -> None:
    """Eight-wide bulk decompression for any keys whose affine form is
    not yet materialized — the verification-time complement of the
    deferred ``from_validated_bytes`` parse.

    Deliberately does NOT route through the process-wide cache: in the
    replay workload each attester key verifies once per epoch, so at
    registry scale the FIFO cache evicts a block's keys before they are
    ever reused — pure churn. The results land directly on the
    ``PublicKey`` instances instead. The subgroup check is skipped under
    the same contract as ``raw_uncompressed`` (these keys' membership is
    established by their source — the registry's deposit rule, or an
    earlier subgroup-checked parse); a key the batch cannot decompress is
    simply left cold, and the per-key path raises its precise error."""
    if not _native():
        return
    todo: "dict[bytes, list[PublicKey]]" = {}
    for pk in public_keys:
        if pk._raw is not None or pk._bytes is None:
            continue
        hit = _RAW_PK_CACHE.get(pk._bytes)
        if hit is not None:
            pk._raw = hit
            continue
        todo.setdefault(pk._bytes, []).append(pk)
    if len(todo) < 8:  # below the lane width there is nothing to win
        return
    keys = list(todo)
    for rc_raw_inf, key in zip(
        native_bls.g1_decompress_batch(keys, check_subgroup=False), keys
    ):
        rc, raw, is_inf = rc_raw_inf
        if rc == 0:
            raw = b"\x00" * 96 if is_inf else raw
            for pk in todo[key]:
                pk._raw = raw


def verify_signature(
    public_key: PublicKey, message: bytes, signature: Signature, dst: bytes = ETH_DST
) -> bool:
    """e(pk, H(m)) == e(g1, sig)  (bls.rs verify_signature)."""
    if _native():
        rc = native_bls.verify(
            public_key.to_bytes(), message, signature.to_bytes(), dst
        )
        if rc >= 0:
            return rc == 1
        # unparseable object (cannot happen for validated inputs): fall
        # through to the oracle for a defensive second opinion
    if signature.is_infinity() or public_key.is_infinity():
        return False
    h = hash_to_g2(message, dst)
    return pairing_product_is_one(
        [(public_key.point, h), (-G1_GENERATOR, signature.point)]
    )


def aggregate(signatures: list[Signature]) -> Signature:
    """Sum of signature points; errors on empty input (bls.rs aggregate)."""
    if not signatures:
        raise InvalidSignatureError("cannot aggregate zero signatures")
    if _native():
        rc, out = native_bls.aggregate_signatures([s.to_bytes() for s in signatures])
        if rc == 0:
            return Signature._from_valid_bytes(out)
        raise InvalidSignatureError(native_bls.decode_error_message(rc))
    acc = G2Point.infinity()
    for sig in signatures:
        acc = acc + sig.point
    return Signature(acc)


def aggregate_verify(
    public_keys: list[PublicKey],
    messages: list[bytes],
    signature: Signature,
    dst: bytes = ETH_DST,
) -> bool:
    """Π e(pk_i, H(m_i)) == e(g1, sig) (bls.rs aggregate_verify)."""
    if len(public_keys) != len(messages) or not public_keys:
        return False
    if _native():
        rc = native_bls.aggregate_verify(
            [pk.to_bytes() for pk in public_keys], messages,
            signature.to_bytes(), dst,
        )
        if rc >= 0:
            return rc == 1
    if signature.is_infinity():
        return False
    if any(pk.is_infinity() for pk in public_keys):
        return False
    pairs: list[tuple[G1Point, G2Point]] = [
        (pk.point, hash_to_g2(msg, dst))
        for pk, msg in zip(public_keys, messages)
    ]
    pairs.append((-G1_GENERATOR, signature.point))
    return pairing_product_is_one(pairs)


def fast_aggregate_verify(
    public_keys: list[PublicKey],
    message: bytes,
    signature: Signature,
    dst: bytes = ETH_DST,
) -> bool:
    """All keys sign the same message: aggregate the pubkeys, verify once
    (bls.rs fast_aggregate_verify:114).

    Large batches route the aggregation through the device G1 kernel
    (ops/g1.py, csrc/g1_sum.cu) when installed — the O(N) piece; the
    single pairing stays native. A device failure raises."""
    if not public_keys:
        return False
    if _native():
        if _device_flags.bls_agg_enabled(len(public_keys)):
            try:
                agg = _aggregate_on_device(public_keys)
            except Exception as exc:
                _device_decline("fast_aggregate", exc)
                raise
            if agg is None:
                return False  # identity aggregate never verifies
            return verify_signature(agg, message, signature, dst)
        # an identity pubkey in the list never verifies (PublicKey
        # semantics, bls.rs:114) — checked here because the raw path's
        # all-zero encoding would otherwise surface as a parse error
        if any(pk.is_infinity() for pk in public_keys):
            return False
        # cached raw affine keys skip the per-key decompression sqrt
        # (subgroup membership was established at parse time); deferred
        # registry parses bulk-decompress eight-wide here instead of
        # one-by-one below
        warm_raw_keys(public_keys)
        rc = native_bls.fast_aggregate_verify_raw(
            [pk.raw_uncompressed() for pk in public_keys], message,
            signature.to_bytes(), dst,
        )
        if rc >= 0:
            return rc == 1
    acc = G1Point.infinity()
    for pk in public_keys:
        acc = acc + pk.point
    return verify_signature(PublicKey(acc), message, signature, dst)


def _aggregate_on_device(public_keys: list[PublicKey]) -> "PublicKey | None":
    """Device pubkey aggregation; None when the sum is the identity (which
    can never verify)."""
    from ..ops import g1 as device_g1

    warm_raw_keys(public_keys)
    raws = [pk.raw_uncompressed() for pk in public_keys]
    raw_sum, is_inf = device_g1.aggregate_pubkeys_device(
        raws, device=_device_flags.DEVICE
    )
    if is_inf:
        return None
    agg = PublicKey._from_valid_bytes(native_bls.g1_compress_raw(raw_sum))
    agg._raw = raw_sum
    return agg


def eth_aggregate_public_keys(public_keys: list[PublicKey]) -> PublicKey:
    """Spec `eth_aggregate_pubkeys` (bls.rs eth_aggregate_public_keys:135):
    errors on empty input or invalid keys; the aggregate may legitimately be
    used for sync-committee processing."""
    if not public_keys:
        raise InvalidPublicKeyError("cannot aggregate zero public keys")
    if _native():
        rc, out = native_bls.aggregate_public_keys(
            [pk.to_bytes() for pk in public_keys]
        )
        if rc == 0:
            return PublicKey._from_valid_bytes(out)
        raise InvalidPublicKeyError(native_bls.decode_error_message(rc))
    acc = G1Point.infinity()
    for pk in public_keys:
        pk.validate()
        acc = acc + pk.point
    return PublicKey(acc)


def eth_fast_aggregate_verify(
    public_keys: list[PublicKey],
    message: bytes,
    signature: Signature,
    dst: bytes = ETH_DST,
) -> bool:
    """Spec `eth_fast_aggregate_verify` (bls.rs:150): returns True for an
    empty key list when the signature is the G2 identity encoding (the
    sync-aggregate "no participants" rule), otherwise defers to
    fast_aggregate_verify."""
    if not public_keys and signature.is_infinity():
        return True
    return fast_aggregate_verify(public_keys, message, signature, dst)


# ---------------------------------------------------------------------------
# Batched verification (the device/batch boundary: SURVEY.md §2.5, §7)
# ---------------------------------------------------------------------------


class SignatureSet:
    """One verification claim: `signature` is a valid aggregate signature by
    `public_keys` over `message` (fast_aggregate_verify semantics). The unit
    the state transition batches — proposer/randao/attestations/sync sets
    from one block become one multi-pairing."""

    __slots__ = ("public_keys", "message", "signature")

    def __init__(self, public_keys: list[PublicKey], message: bytes,
                 signature: Signature):
        self.public_keys = list(public_keys)
        self.message = bytes(message)
        self.signature = signature

    def verify(self, dst: bytes = ETH_DST) -> bool:
        return fast_aggregate_verify(
            self.public_keys, self.message, self.signature, dst
        )


def _batch_all_valid(sets: list[SignatureSet], dst: bytes) -> bool:
    """One RLC multi-pairing over every set (native backend only).

    When the device G1 kernel is installed and the batch carries enough
    keys, every set's pubkey aggregation runs as ONE launch over all sets
    (ops/g1.py) and the pairing sees single-key sets — the device owns the
    O(total keys) work. Batches of at least ``_device_flags.PAIRING_MIN_SETS``
    sets then take the device pairing route; smaller ones the native
    multi-pairing. The blinders are drawn first, from ``secrets``, on both
    routes: the batch's soundness rests on them."""
    # deferred registry parses (from_validated_bytes) materialize here,
    # through the eight-wide bulk path
    warm_raw_keys(pk for s in sets for pk in s.public_keys)
    total_keys = sum(len(s.public_keys) for s in sets)
    if _device_flags.bls_agg_enabled(total_keys):
        from ..ops import g1 as device_g1

        agg = device_g1.aggregate_pubkey_sets_device(
            [[pk.raw_uncompressed() for pk in s.public_keys] for s in sets],
            device=_device_flags.DEVICE,
        )
        if any(is_inf for _, is_inf in agg):
            return False  # an identity aggregate never verifies
        new_sets = []
        for (raw, _), s in zip(agg, sets):
            pk = PublicKey._from_valid_bytes(native_bls.g1_compress_raw(raw))
            pk._raw = raw  # already affine — don't re-pay the sqrt
            new_sets.append(SignatureSet([pk], s.message, s.signature))
        sets = new_sets
    scalars = [(1).to_bytes(16, "big")]
    for _ in range(len(sets) - 1):
        while True:
            s = secrets.token_bytes(16)
            if any(s):
                break
        scalars.append(s)
    if _device_flags.pairing_enabled(len(sets)):
        try:
            verdict = _batch_device_pairing(sets, dst, scalars)
        except Exception as exc:
            _device_decline("pairing", exc)
            raise
        _note_pairing_route("device", "routed", len(sets))
        return verdict
    _note_pairing_route(
        "host",
        "not_installed" if _device_flags.PAIRING_MIN_SETS is None else "below_threshold",
        len(sets),
    )
    # raw-affine pubkeys: decompressed once per key (cached on the
    # PublicKey — subgroup-checked at parse time), so repeat verifiers
    # (the same validators every block) never pay the sqrt again
    return native_bls.batch_verify_raw(
        [([pk.raw_uncompressed() for pk in s.public_keys], s.message,
          s.signature.to_bytes()) for s in sets],
        dst,
        scalars,
    )


def _batch_device_pairing(
    sets: list[SignatureSet], dst: bytes, scalars: list[bytes]
) -> bool:
    """The device route of the RLC batch: per-set pubkey aggregation on the
    card when a set has several keys (ops/g1.py), the native hash_to_g2 per
    message, then the blinder multiplications, the N + 1 Miller loops and
    their product in the pairing kernels (ops/pairing.py) with the native
    final-exponentiation verdict — sharded over the mesh
    (parallel/pairing.py) when ``ECT_MESH`` provisioned one, or when the
    routed device type has several devices. A False verdict is exact (the soundness
    of the native batch); a kernel that fails to build or launch raises."""
    from ..ops import pairing as device_pairing

    device = _device_flags.DEVICE
    if any(len(s.public_keys) > 1 for s in sets):
        from ..ops import g1 as device_g1

        agg = device_g1.aggregate_pubkey_sets_device(
            [[pk.raw_uncompressed() for pk in s.public_keys] for s in sets],
            device=device,
        )
        if any(is_inf for _, is_inf in agg):
            return False  # an identity aggregate never verifies
        pk_raws = [raw for raw, _ in agg]
    else:
        pk_raws = [s.public_keys[0].raw_uncompressed() for s in sets]
    h_raws = []
    for s in sets:
        rc, raw, _ = native_bls.g2_decompress(
            native_bls.hash_to_g2_compressed(s.message, dst), check_subgroup=False
        )
        if rc != 0:
            raise RuntimeError(f"hash_to_g2 gave a point that does not decompress: rc {rc}")
        h_raws.append(raw)
    sig_raws = []
    for s in sets:
        if s.signature.is_infinity():
            return False  # an identity signature never verifies
        sig_raws.append(s.signature.raw_uncompressed())
    blinders = [int.from_bytes(sc, "big") for sc in scalars]
    from ..parallel import mesh as _mesh
    from ..parallel import runtime as _mesh_runtime

    # the provisioned ECT_MESH mesh owns the sharded route; without one,
    # several devices of the routed type still shard over them all
    mesh = _mesh_runtime.pairing_mesh(len(sets))
    if mesh is None and _mesh.device_count() > 1:
        mesh = _mesh.default_device_mesh()
    if mesh is not None:
        from ..parallel.pairing import batch_verify_sharded

        return batch_verify_sharded(pk_raws, h_raws, sig_raws, blinders, mesh=mesh)
    return device_pairing.batch_verify_device(
        pk_raws, h_raws, sig_raws, blinders, device=device,
    )


def verify_signature_sets(
    sets: list[SignatureSet], dst: bytes = ETH_DST
) -> list[bool]:
    """Verdicts for N independent signature sets.

    Native path: one random-linear-combination multi-pairing proves all N
    at once (N+1 Miller loops, one shared final exponentiation). On
    failure, blame is attributed by verifying each set directly —
    ``SignatureSet.verify`` already aggregates multi-key sets in one
    native pass (and rejects identity pubkeys/empty keysets cleanly), so
    no pre-aggregation here can save work. Bisection-style batch probing
    was tried and measured a wash-to-loss here: a probe over m sets pays
    the same per-set hash_to_g2 + Miller work a direct verify pays, so
    the only sharing is the final exponentiation, which the probe ladder
    re-spends on overlapping ranges. A forged set passes the blinded
    batch with probability <= 2^-128."""
    if not sets:
        return []
    # each batched verification stamps its route; clearing first tells "no
    # RLC batch ran" apart (single sets and the blame verify per set)
    _ROUTE_TL.route = None
    if _native() and len(sets) > 1 and _batch_all_valid(sets, dst):
        return [True] * len(sets)
    return [s.verify(dst) for s in sets]


# ---------------------------------------------------------------------------
# Async dispatch (the chain pipeline's stage-B hook, pipeline/scheduler.py;
# reference crypto/bls.py:912-995)
# ---------------------------------------------------------------------------

_VERIFY_POOLS: dict = {}
# double-checked creation: two racing first-dispatchers would otherwise
# build TWO single-thread pools for one lane — and the pipeline's
# windows-settle-FIFO guarantee (per lane) only holds when every dispatch
# to a lane queues behind the SAME worker
_VERIFY_POOL_LOCK = threading.Lock()


def _verify_pool(lane: int = 0):
    """One process-wide single-thread verifier PER LANE. One worker per
    lane on purpose: dispatches within a lane complete FIFO, and the
    pairing engines underneath (native ctypes — which releases the GIL for
    the whole multi-pairing — or the device route, whose B6 and B7
    launches then run on this worker's thread, on its current stream)
    each already own their parallelism. Lane 0 is the historical single
    verifier; the pipeline scheduler fans windows over N lanes
    deterministically (``seq % verify_lanes``, pipeline/scheduler.py) so
    N windows verify concurrently, while the engine's settle-oldest order
    keeps commits in chain order regardless of which lane finishes
    first."""
    pool = _VERIFY_POOLS.get(lane)
    if pool is None:
        with _VERIFY_POOL_LOCK:
            pool = _VERIFY_POOLS.get(lane)
            if pool is None:
                from concurrent.futures import ThreadPoolExecutor

                pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=f"bls-verify-{lane}"
                )
                _VERIFY_POOLS[lane] = pool
    return pool


def verify_signature_sets_async(
    sets: list[SignatureSet], dst: bytes = ETH_DST, timer=None, pre=None,
    route_sink=None, lane: int = 0, trace_ctx=None,
):
    """Dispatch one batched verification to the background verifier thread;
    returns a ``concurrent.futures.Future[list[bool]]``.

    The host thread keeps mutating state while the multi-pairing runs.
    ``timer``, if given, is called on the worker with the verification's
    duration in seconds — the pipeline's stage-occupancy probe. ``pre``,
    if given, runs on the worker immediately before verification (the
    pipeline's fault-injection seam, pipeline/faults.py); anything it
    raises surfaces through the future exactly as a real worker fault
    would. ``route_sink``, if given, is called on the worker after
    verification with the batch's pairing route ("device"/"host"/None —
    ``last_batch_route``), the flight recorder's per-window verify_route
    feed. ``lane`` picks the single-thread verifier worker (default 0);
    batches dispatched to different lanes verify CONCURRENTLY, batches on
    one lane stay FIFO. ``trace_ctx``, if given, is the caller's causal
    handoff token (utils/trace TraceContext): the worker adopts it so the
    verify span parents under the dispatching window's trace across the
    thread seam. A device kernel that fails raises through the future."""
    sets = list(sets)

    def run() -> list[bool]:
        import time as _time

        t0 = _time.perf_counter()
        try:
            if pre is not None:
                pre()
            # the span lands on the verifier thread's lane, so a recorded
            # pipeline run shows stage B as its own Perfetto track —
            # linked under trace_ctx's trace when the caller passed one
            with trace.adopt(trace_ctx):
                with trace.span("pipeline.flush.verify", sets=len(sets)):
                    verdicts = verify_signature_sets(sets, dst)
            if route_sink is not None:
                route_sink(last_batch_route())
            return verdicts
        finally:
            if timer is not None:
                timer(_time.perf_counter() - t0)

    return _verify_pool(lane).submit(run)
