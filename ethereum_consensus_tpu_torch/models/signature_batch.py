"""Block-level signature-set collection.

The reference verifies each signature at its call site as block processing
walks the operations (phase0/helpers.rs:71 `is_valid_indexed_attestation`,
:144 `verify_block_signature`; altair/block_processing.rs:192
`process_sync_aggregate`). Here the boundary is the opposite: the
state transition *collects* every (pubkeys, message, signature) claim a
block makes — proposer signature, randao reveal, slashing headers, up to
MAX_ATTESTATIONS aggregates, voluntary exits, the sync aggregate — and
verifies them as ONE batch (random-linear-combination multi-pairing via
``crypto.bls.verify_signature_sets``: N+1 Miller loops, one shared final
exponentiation, device-batchable MSMs).

Semantics are preserved exactly:

* Deferral is ambient (a context variable set by ``collect_signatures``),
  so spec functions keep their reference signatures, and a spec function
  called *outside* a collection scope — e.g. a single-operation
  conformance vector — verifies inline, exactly as before.
* Each deferred set carries the structured error its call site would have
  raised; ``flush`` raises the error of the FIRST failing set in
  insertion (i.e. spec) order, so error attribution still names the
  specific invalid operation. The historical cross case — a structurally
  invalid operation later in the block raising at its call site before an
  earlier operation's bad signature was ever checked — is closed: when
  block processing aborts with a structured error, the transition first
  re-checks the sets already collected (``raise_if_any_invalid``) and
  raises the earliest failing one instead, restoring strict call-site
  order between signature and structural errors.
* Cross-BLOCK windowing (for a chain pipeline, which the port does not
  have yet): inside a
  ``defer_flushes(sink)`` scope a batch's ``flush`` hands its sets to the
  sink instead of verifying, so K blocks' claims coalesce into ONE
  multi-pairing (N+K Miller loops, one shared final exponentiation)
  dispatched later. ``merge``/``split`` are the window algebra: merge
  preserves insertion order across blocks, split recovers the per-block
  boundaries for failure attribution.
* A failed flush aborts the whole transition — identical observable
  behavior to the sequential path, because an invalid block discards the
  state either way (the reference's Executor does the same;
  executor.rs:113).
* Deposit signatures are NOT deferrable: an invalid deposit signature is
  *skipped*, not an error (phase0/block_processing.rs:351), and whether
  the validator joins the registry affects the rest of the block.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager

from ..crypto import bls

__all__ = [
    "SignatureBatch",
    "collect_signatures",
    "current_batch",
    "defer_flushes",
    "flush_sink",
    "verify_or_defer",
]

_CURRENT: contextvars.ContextVar["SignatureBatch | None"] = contextvars.ContextVar(
    "signature_batch", default=None
)

# cross-block flush sink (the pipeline's coalescing window): when set, a
# batch's flush() merges into the sink instead of verifying, so the
# verification moment moves from "end of each block" to "window dispatch"
_FLUSH_SINK: contextvars.ContextVar["SignatureBatch | None"] = contextvars.ContextVar(
    "signature_flush_sink", default=None
)


class SignatureBatch:
    """Accumulates SignatureSets plus the error each would raise."""

    __slots__ = ("_sets", "_errors")

    def __init__(self):
        self._sets: list[bls.SignatureSet] = []
        self._errors: list[Exception] = []

    def __len__(self) -> int:
        return len(self._sets)

    def defer(
        self,
        public_keys: list[bls.PublicKey],
        message: bytes,
        signature: bls.Signature,
        error: Exception,
    ) -> None:
        self._sets.append(bls.SignatureSet(public_keys, message, signature))
        self._errors.append(error)

    @property
    def sets(self) -> "list[bls.SignatureSet]":
        """The accumulated sets, insertion (call-site) order. Read-only by
        convention — mutate only through defer/merge/split/flush."""
        return self._sets

    @property
    def errors(self) -> "list[Exception]":
        """The structured error each set raises on failure, aligned with
        ``sets``."""
        return self._errors

    def merge(self, other: "SignatureBatch") -> None:
        """Append ``other``'s sets after this batch's (call-site order across
        the concatenation = block order, then in-block order). ``other`` is
        left intact, so a pipeline window can keep per-block batches for
        failure attribution while flushing one merged copy."""
        self._sets.extend(other._sets)
        self._errors.extend(other._errors)

    def split(self, sizes: "list[int]") -> "list[SignatureBatch]":
        """Partition into consecutive sub-batches of the given sizes (the
        inverse of ``merge`` given the per-block set counts). The sizes
        must sum to ``len(self)``."""
        if sum(sizes) != len(self._sets):
            raise ValueError(
                f"split sizes sum to {sum(sizes)}, batch holds {len(self._sets)}"
            )
        parts: list[SignatureBatch] = []
        at = 0
        for n in sizes:
            part = SignatureBatch()
            part._sets = self._sets[at : at + n]
            part._errors = self._errors[at : at + n]
            parts.append(part)
            at += n
        return parts

    def flush(self) -> None:
        """One batched verification; raises the first failing set's error.

        Inside a ``defer_flushes`` scope the sets are handed to the sink
        instead (drained from this batch) and no verification happens —
        the pipeline window verifies them later as one coalesced
        multi-pairing."""
        if not self._sets:
            return
        sink = _FLUSH_SINK.get()
        if sink is not None and sink is not self:
            sink.merge(self)
            self._sets, self._errors = [], []
            return
        sets, errors = self._sets, self._errors
        self._sets, self._errors = [], []
        for ok, error in zip(bls.verify_signature_sets(sets), errors):
            if not ok:
                raise error

    def raise_if_any_invalid(self) -> None:
        """Verify the accumulated sets NOW (ignoring any flush sink) and
        raise the first failing set's error, else return with the batch
        intact. The error-path probe behind strict call-site-order
        attribution: when block processing aborts structurally, any
        already-collected bad signature from an earlier call site must
        win over the later structural error."""
        if not self._sets:
            return
        for ok, error in zip(bls.verify_signature_sets(self._sets), self._errors):
            if not ok:
                raise error


def current_batch() -> SignatureBatch | None:
    return _CURRENT.get()


def flush_sink() -> SignatureBatch | None:
    return _FLUSH_SINK.get()


@contextmanager
def defer_flushes(sink: SignatureBatch):
    """Scope within which any batch's ``flush`` coalesces into ``sink``
    instead of verifying — the cross-block window of a chain pipeline.
    Scopes nest (inner sink wins), and the sink
    itself still verifies when IT flushes outside the scope.

    Structural validation is unaffected: only the signature-verification
    moment moves. ``raise_if_any_invalid`` deliberately bypasses the sink
    so error-path attribution stays synchronous."""
    token = _FLUSH_SINK.set(sink)
    try:
        yield sink
    finally:
        _FLUSH_SINK.reset(token)


@contextmanager
def collect_signatures():
    """Scope within which ``verify_or_defer`` defers instead of verifying.

    Scopes nest: an inner scope gets its own batch (flushed on its own
    exit), so a nested full transition cannot leak sets into the caller.
    The batch is NOT auto-flushed on exit — the transition flushes
    explicitly before the state-root check so errors surface at a
    deterministic point."""
    batch = SignatureBatch()
    token = _CURRENT.set(batch)
    try:
        yield batch
    finally:
        _CURRENT.reset(token)


def verify_or_defer(
    public_keys: list[bls.PublicKey],
    message: bytes,
    signature: bls.Signature,
    error: Exception,
) -> None:
    """fast_aggregate_verify semantics: inline outside a collection scope,
    deferred inside one. ``error`` is the structured error to raise when
    the set does not verify."""
    batch = _CURRENT.get()
    if batch is None:
        if not bls.fast_aggregate_verify(public_keys, message, signature):
            raise error
    else:
        batch.defer(public_keys, message, signature, error)
