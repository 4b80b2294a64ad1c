"""SHA-256 hashing backends for SSZ merkleization.

The host backend uses hashlib; the device backend (registered by
``ethereum_consensus_tpu_torch.ops.sha256.install_device_hasher``) runs a
batched SHA-256 kernel on a CUDA card and is used by the merkleizer for
large leaf counts.

Reference parity: `crypto::hash` (ethereum-consensus/src/crypto/bls.rs:12-20)
and the SHA-256 tree hash inside `ssz_rs::hash_tree_root`.
"""

from __future__ import annotations

import hashlib
from typing import Callable

from ..telemetry import metrics as _metrics

__all__ = [
    "hash_bytes",
    "hash_pair",
    "hash_level_host",
    "register_device_hasher",
    "register_native_hasher",
    "hash_level",
    "digest_count",
    "add_digests",
    "DEVICE_MIN_NODES",
    "NATIVE_MIN_NODES",
]


# -- instrumentation ---------------------------------------------------------

# Monotonic count of SHA-256 compressions performed through this module
# (host, native, and device alike — whole-tree native reductions report
# their exact level-sum via add_digests). Tests and the bench read deltas
# to assert WORK DONE, not just wall time: the incremental-HTR regression
# test pins "one validator edit == one 4096-leaf group + the log-depth
# path", which wall-clock alone can't prove.
#
# The count lives in the process-wide telemetry registry (one locked
# Counter) because the chain pipeline hashes from BOTH threads at once —
# stage A's incremental HTR and the stage-B verifier's committed-state
# replays — and the previous unlocked module-global increment could drop
# updates under that interleaving. digest_count()/add_digests() stay as
# thin compatibility shims over the registry metric.
_DIGESTS = _metrics.counter("ssz.digests")


def digest_count() -> int:
    """Total digests computed so far (read a delta around the op under test)."""
    return _DIGESTS.value()


def add_digests(n: int) -> None:
    """Record ``n`` digests computed outside the per-call wrappers (native
    whole-tree reductions, device dispatches)."""
    _DIGESTS.inc(n)


def hash_bytes(data: bytes) -> bytes:
    """SHA-256 of arbitrary bytes (host)."""
    _DIGESTS.inc()
    return hashlib.sha256(data).digest()


def hash_pair(left: bytes, right: bytes) -> bytes:
    """SHA-256 of the 64-byte concatenation of two 32-byte nodes."""
    _DIGESTS.inc()
    return hashlib.sha256(left + right).digest()


def hash_level_host(nodes: bytes) -> bytes:
    """Hash one merkle level: ``nodes`` is ``2n`` 32-byte nodes concatenated;
    returns ``n`` 32-byte parent nodes concatenated."""
    out = bytearray(len(nodes) // 2)
    for i in range(0, len(nodes), 64):
        out[i // 2 : i // 2 + 32] = hashlib.sha256(nodes[i : i + 64]).digest()
    return bytes(out)


# -- device backend registry -------------------------------------------------

# A device hasher has the same signature as hash_level_host. It is pushed in
# by ops.sha256.install_device_hasher, so the host path never imports torch.
_device_hasher: Callable[[bytes], bytes] | None = None

# Levels with at least this many parent nodes go to the device hasher. The
# value matches the reference package so both route the same levels.
DEVICE_MIN_NODES = 1 << 17


def register_device_hasher(fn: Callable[[bytes], bytes]) -> None:
    global _device_hasher
    _device_hasher = fn


# The native C++ hasher (ethereum_consensus_tpu_torch.native) sits between hashlib
# and the device: it wins over hashlib once the level is big enough to
# amortize the ctypes call (~1µs), far below the device threshold.
_native_hasher: Callable[[bytes], bytes] | None = None

NATIVE_MIN_NODES = 8


def register_native_hasher(fn: Callable[[bytes], bytes]) -> None:
    global _native_hasher
    _native_hasher = fn


# The native path self-installs on the first level big enough to use it
# (one attempt; the on-demand C++ build is disk-cached). With no g++ on
# the machine it stays on hashlib; a build that fails raises.
_native_attempted = False


def hash_level(nodes: bytes) -> bytes:
    """Hash one merkle level, routing to the fastest registered backend:
    device for huge levels, native C++ for medium, hashlib otherwise."""
    global _native_attempted
    n = len(nodes) // 64
    _DIGESTS.inc(n)
    if _device_hasher is not None and n >= DEVICE_MIN_NODES:
        return _device_hasher(nodes)
    if (
        _native_hasher is None
        and not _native_attempted
        and n >= NATIVE_MIN_NODES
    ):
        _native_attempted = True
        from .. import native

        native.install()
    if _native_hasher is not None and n >= NATIVE_MIN_NODES:
        return _native_hasher(nodes)
    return hash_level_host(nodes)
