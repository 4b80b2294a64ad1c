"""Admission engine: line-rate ingestion with windowed cross-message RLC
signature flushes.

Every incoming message is validated STRUCTURALLY on arrival against the
current ``HeadStore`` snapshot — slot window, committee geometry,
bitfield shape, redundancy against the pool — and its signature claim is
DEFERRED into the current admission window. A full window flushes as one
fused verification through ``bls.verify_signature_sets_async`` (the
pipeline's stage-B entry, same FIFO worker), so the pairing cost per
admitted message approaches the cost of folding one more claim into the
batch instead of one pairing pair per message:

* **batched G2 membership** — per-message signature points are parsed
  WITHOUT the per-point subgroup check (``g2_decompress(check=False)``)
  and the whole window's points are membership-checked at once: one
  random-linear-combination G2 MSM plus a single checked round-trip.
  A failing combination falls back to per-signature checks and culls
  the offenders as ``malformed`` — exactly the reason the scalar twin's
  ``Signature.from_bytes`` raises at its parse.
* **per-group claim fusion** — window attestations for the same
  ``(slot, committee_key, data_root)`` share a signing root, so their
  claims fuse into ONE signature set: multiplicity counts over the
  committee (a column sum of the window's bitfields) feed one G1 MSM
  for the fused public-key side, and the signatures sum on the G2 side.
  D distinct data roots cost D+1 Miller loops, not 2·M pairings.
* **one RLC multi-pairing** per window over the fused sets plus any
  singleton-op sets (exits, slashings, BLS changes) — dispatched async;
  ``settle()`` maps verdicts back. A failed fused set SPLITS: members
  re-verify individually and only the offenders are rejected
  (``signature``) — the pipeline's rollback-blame discipline.

The **scalar twin** (``rlc=False``, or ``ECT_POOL_RLC=off``, or no
native backend) verifies each message inline at admission — per-message
key parse, per-message pairing — and is both the live fallback and the
differential oracle: pool contents, served views, and every rejection
reason are bit-identical between the engines for any admission sequence
(the pool's tests). Caveat: claim
fusion is OPTIMISTIC — a crafted pair of individually-invalid signatures
that cancels within one group's sum passes the fused check (split never
runs); block production re-validates every selected aggregate through
the fork's own ``process_block``, so such poison cannot reach a chain.

Singleton ops are validated by the fork's OWN processors on a memoized
scratch copy of the snapshot state inside a ``collect_signatures``
scope — structural semantics cannot drift from the spec because they ARE
the spec functions; only the verification moment moves.

Rejection is never silent: every rejection bumps
``pool.rejected.{reason}`` and emits a one-shot ``pool.rejected`` trace
event per reason per process (the ``ops_vector.fallback`` pattern).

Locking: ``AdmissionEngine._lock`` guards the window, in-flight list,
caches, and ticket transitions; it is never held across snapshot memo
builds, native calls, or pool-lock acquisition's own critical sections
(pool methods take their lock internally, engine lock released first).

Reference parity: ethereum_consensus_tpu/pool/admission.py. A device
kernel under the flush (B6 where a batch carries enough keys) raises
through the verifier's future, as everywhere in the port.
"""

from __future__ import annotations

import hashlib
import secrets
import threading
import time

from .. import _env
from ..crypto import bls
from ..error import Error
from ..models.signature_batch import collect_signatures
from ..telemetry import metrics as _metrics
from ..utils import trace

__all__ = ["AdmissionEngine", "Admission", "REASONS", "DEFAULT_WINDOW"]

DEFAULT_WINDOW = 64
_RLC_ENV = "ECT_POOL_RLC"  # =off forces the scalar per-message twin

# the structured rejection taxonomy — every reason is a counter
# (pool.rejected.<reason>) and a one-shot trace event; no other exit
# from admission exists, so nothing can drop silently
REASONS = (
    "no_head",            # nothing published to validate against
    "malformed",          # undecodable payload / invalid signature point
    "future_slot",        # attestation slot ahead of the head
    "expired",            # attestation past its inclusion window
    "invalid",            # structural spec violation (target, op rules)
    "unknown_committee",  # committee index out of range
    "bits_mismatch",      # aggregation bits != committee size
    "duplicate",          # exact aggregate / op already held
    "subset",             # adds no attester the pool doesn't cover
    "signature",          # the claim's signature does not verify
)

_REJECT_SEEN: set = set()
_REJECT_LOCK = threading.Lock()


def _note_rejection(reason: str) -> None:
    """Counter per occurrence, trace event once per reason per process."""
    _metrics.counter(f"pool.rejected.{reason}").inc()
    if reason not in _REJECT_SEEN:
        with _REJECT_LOCK:
            if reason not in _REJECT_SEEN:
                _REJECT_SEEN.add(reason)
                trace.event("pool.rejected", reason=reason)


def _native() -> bool:
    try:
        return bls.backend_name() == "native"
    except Exception:  # noqa: BLE001 — backend probe must not raise here
        return False


def _rlc_disabled() -> bool:
    return _env.flag_off(_RLC_ENV)


class Admission:
    """One message's admission ticket: ``pending`` until its window
    settles (RLC mode), then ``admitted`` or ``rejected`` + reason.
    Scalar-mode tickets resolve before ``admit_*`` returns."""

    __slots__ = ("kind", "status", "reason", "order",
                 "key", "bits", "indices", "committee_ref", "msg_root",
                 "sig_bytes", "sig_raw", "container", "snap", "sets",
                 "set_verdicts", "sig_ok", "trace_id")

    def __init__(self, kind: str, order: int):
        self.kind = kind
        self.status = "pending"
        self.reason = None
        self.order = order
        # the causal trace of the flush window this ticket rode
        # (stamped at dispatch; None while tracing is off or pending)
        self.trace_id = None
        self.key = None
        self.bits = None
        self.indices = None
        self.committee_ref = None  # (committee, pk_objs, raws-slot) record
        self.msg_root = None
        self.sig_bytes = None
        self.sig_raw = None
        self.container = None
        self.snap = None
        self.sets = None  # singleton ops: collected SignatureSets
        self.set_verdicts = None
        self.sig_ok = None

    def __repr__(self) -> str:
        tail = f", {self.reason}" if self.reason else ""
        return f"Admission({self.kind}, {self.status}{tail})"


class AdmissionEngine:
    """Windowed RLC admission over an ``OperationPool`` + ``HeadStore``.

    ``window_size`` counts MESSAGES per flush window; ``max_inflight``
    bounds dispatched-but-unsettled windows (backpressure: the oldest
    settles inline when exceeded — the pipeline's bounded-queue idiom).
    """

    def __init__(self, pool, store, context, window_size: int = DEFAULT_WINDOW,
                 rlc: "bool | None" = None, max_inflight: int = 2):
        self._lock = threading.Lock()
        self.pool = pool
        self.store = store
        self.context = context
        self.window_size = max(1, int(window_size))
        if rlc is None:
            rlc = _native() and not _rlc_disabled()
        elif rlc and (not _native() or _rlc_disabled()):
            _metrics.counter("pool.fallback.no_native").inc()
            rlc = False
        self.rlc = bool(rlc)
        self.max_inflight = max(1, int(max_inflight))
        self._window: list = []
        self._inflight: list = []  # (future|None, sets, attribution, entries, trace ctx)
        self._committees: dict = {}  # (root, slot, ckey) -> [committee, objs, raws|None]
        self._builders: dict = {}  # fork name -> container namespace
        self._scratches: dict = {}  # snapshot root -> mutable op scratch
        self._data_roots: dict = {}  # serialized AttestationData -> root
        self._order = 0

    # -- plumbing ------------------------------------------------------------
    def _head(self):
        return self.store.head

    def _builder(self, fork: str):
        with self._lock:
            ns = self._builders.get(fork)
        if ns is None:
            ns = self._fork_module(fork).build(self.context.preset)
            with self._lock:
                self._builders[fork] = ns
        return ns

    def _fork_module(self, fork: str):
        import importlib

        return importlib.import_module(f"..models.{fork}", __package__)

    def _reject(self, entry: Admission, reason: str) -> Admission:
        with self._lock:
            entry.status = "rejected"
            entry.reason = reason
        _note_rejection(reason)
        return entry

    def _admit(self, entry: Admission) -> Admission:
        with self._lock:
            entry.status = "admitted"
        _metrics.counter(f"pool.admitted.{entry.kind}").inc()
        return entry

    def _next_entry(self, kind: str) -> Admission:
        with self._lock:
            self._order += 1
            return Admission(kind, self._order)

    # -- attestation admission ----------------------------------------------
    def admit_attestation(self, attestation) -> Admission:
        """Structural validation now, signature into the window (RLC) or
        verified inline (scalar twin). Returns the ticket."""
        if self.rlc:
            return self.admit_attestation_batch([attestation])[0]
        t0 = time.perf_counter()
        entry = Admission("attestation", 0)
        try:
            with trace.span("pool.admit", kind="attestation"):
                snap = self._head()
                if snap is None:
                    return self._reject(entry, "no_head")
                committee = self._attestation_structural(
                    entry, attestation, snap
                )
                if committee is None:
                    return entry
                # the per-message twin rejects pool redundancy BEFORE
                # any cryptography (the batched engine resolves the same
                # verdicts at settle time, in admission order)
                verdict = self.pool.classify_attestation(
                    entry.key, len(committee), list(entry.bits),
                    scalar=True,
                )
                if verdict != "new":
                    return self._reject(entry, verdict)
                with self._lock:
                    self._order += 1
                    entry.order = self._order
                return self._admit_scalar_attestation(entry, snap,
                                                      committee)
        finally:
            _metrics.histogram("pool.admit_s").observe(
                time.perf_counter() - t0
            )

    def admit_attestation_batch(self, attestations) -> "list[Admission]":
        """Admit a gossip batch: per-message structural validation, the
        signature claims deferred into the window — ONE span, one lock
        cycle, and at most one flush dispatch per filled window for the
        whole batch, so the per-message admission cost approaches the
        field-adds that fold its claim into the running batch. Dedup
        against the pool resolves at settle time in admission order,
        giving verdicts bit-identical to the per-message twin's."""
        if not self.rlc:
            return [self.admit_attestation(a) for a in attestations]
        t0 = time.perf_counter()
        entries: list = []
        accepted: list = []
        with trace.span("pool.admit", kind="attestation",
                        batch=len(attestations)):
            snap = self._head()
            for att in attestations:
                entry = Admission("attestation", 0)
                entries.append(entry)
                if snap is None:
                    self._reject(entry, "no_head")
                    continue
                committee = self._attestation_structural(entry, att, snap)
                if committee is None:
                    continue
                rc, raw, is_inf = self._g2_parse(entry.sig_bytes)
                if rc != 0:
                    self._reject(entry, "malformed")
                    continue
                if is_inf:
                    self._reject(entry, "signature")
                    continue
                entry.sig_raw = raw
                entry.committee_ref = self._committee_record(
                    snap, entry.key, committee
                )
                accepted.append(entry)
            dispatches = []
            with self._lock:
                for entry in accepted:
                    self._order += 1
                    entry.order = self._order
                    self._window.append(entry)
                    if len(self._window) >= self.window_size:
                        dispatches.append(self._window)
                        self._window = []
                _metrics.gauge("pool.window_pending").set(
                    len(self._window)
                )
            for window in dispatches:
                self._dispatch(window)
        elapsed = time.perf_counter() - t0
        _metrics.histogram("pool.admit_s").observe(elapsed)
        _metrics.counter("pool.admit_batches").inc()
        return entries

    def _g2_parse(self, sig_bytes: bytes):
        from ..native import bls as native_bls

        return native_bls.g2_decompress(sig_bytes, check_subgroup=False)

    def _attestation_structural(self, entry: Admission, att, snap):
        """The gossip-validation checks shared verbatim by both engines
        (structural order IS the rejection-reason contract). Fills the
        entry and returns the committee, or rejects and returns None."""
        from ..models.phase0 import helpers as h

        context = self.context
        try:
            data = att.data
            slot = int(data.slot)
            bit_list = [bool(b) for b in att.aggregation_bits]
        except Exception:  # noqa: BLE001 — not attestation-shaped
            self._reject(entry, "malformed")
            return None
        head_slot = int(snap.slot)
        if not bit_list or not any(bit_list):
            self._reject(entry, "malformed")
            return None
        if slot > head_slot:
            self._reject(entry, "future_slot")
            return None
        if slot + int(context.SLOTS_PER_EPOCH) < head_slot:
            self._reject(entry, "expired")
            return None
        target_epoch = int(data.target.epoch)
        if target_epoch != h.compute_epoch_at_slot(slot, context):
            self._reject(entry, "invalid")
            return None
        committee_bits = getattr(att, "committee_bits", None)
        if committee_bits is not None:  # electra EIP-7549 shape
            if int(data.index) != 0:
                self._reject(entry, "invalid")
                return None
            committee_indices = [
                i for i, b in enumerate(committee_bits) if b
            ]
            if not committee_indices:
                self._reject(entry, "malformed")
                return None
            committee_key = tuple(committee_indices)
        else:
            committee_indices = [int(data.index)]
            committee_key = int(data.index)
        count = snap.memo(
            ("pool_committee_count", target_epoch),
            lambda: h.get_committee_count_per_slot(
                snap.raw, target_epoch, context
            ),
        )
        if any(ci >= count for ci in committee_indices):
            self._reject(entry, "unknown_committee")
            return None
        committee: list = []
        for ci in committee_indices:
            committee.extend(
                snap.memo(
                    ("pool_committee", slot, ci),
                    lambda ci=ci: tuple(
                        h.get_beacon_committee(snap.raw, slot, ci, context)
                    ),
                )
            )
        if len(bit_list) != len(committee):
            self._reject(entry, "bits_mismatch")
            return None

        # hash-consed data root: gossip repeats the same AttestationData
        # across many aggregators, so the merkleization runs once per
        # DISTINCT data (keyed by its serialization, which is cheaper
        # than the tree walk)
        data_ser = bytes(type(data).serialize(data))
        data_root = self._data_roots.get(data_ser)
        if data_root is None:
            data_root = bytes(type(data).hash_tree_root(data))
            with self._lock:
                if len(self._data_roots) >= 4096:
                    self._data_roots = {}
                self._data_roots[data_ser] = data_root
        domain = snap.memo(
            ("pool_att_domain", target_epoch),
            lambda: bytes(
                h.get_domain(
                    snap.raw, _attester_domain_type(), target_epoch,
                    context,
                )
            ),
        )
        entry.key = (slot, committee_key, data_root)
        entry.bits = tuple(bit_list)
        entry.indices = [committee[i] for i, b in enumerate(bit_list) if b]
        # the signing root of SSZ SigningData(object_root, domain) is
        # exactly hash(object_root || domain) — two 32-byte chunks, one
        # compression (asserted against compute_signing_root in tests)
        entry.msg_root = _sha256(data_root + domain)
        entry.sig_bytes = bytes(att.signature)
        entry.container = att
        entry.snap = snap
        return committee

    def _admit_scalar_attestation(self, entry, snap, committee) -> Admission:
        """The per-message twin: parse every key, parse the signature,
        one pairing pair — then insert. The naive gossip validator."""
        validators = snap.raw.validators
        try:
            sig = bls.Signature.from_bytes(entry.sig_bytes)
        except Exception:  # noqa: BLE001 — unparseable point
            return self._reject(entry, "malformed")
        try:
            keys = [
                bls.PublicKey.from_bytes(bytes(validators[i].public_key))
                for i in entry.indices
            ]
        except Exception:  # noqa: BLE001 — registry keys are valid; this
            return self._reject(entry, "malformed")  # guards exotic states
        if not bls.fast_aggregate_verify(keys, entry.msg_root, sig):
            return self._reject(entry, "signature")
        return self._finalize_attestation(entry)

    def _finalize_attestation(self, entry: Admission) -> Admission:
        """Insert a signature-verified aggregate + record its votes (the
        equivocation ledger may surface a slashing). The insert's own
        locked re-classification is the redundancy verdict — one vector
        pass covers both the race guard and in-order settle dedup."""
        row, verdict = self.pool.insert_attestation(
            entry.key, len(entry.bits), list(entry.bits),
            entry.sig_bytes, entry.container, scalar=not self.rlc,
        )
        if row is None:
            return self._reject(entry, verdict)
        builder = self._builder(entry.snap.fork)
        surfaced = self.pool.note_votes(
            entry.indices, entry.container.data,
            entry.key[2], entry.sig_bytes, builder,
        )
        for _ in surfaced:
            trace.event("pool.slashing_surfaced",
                        slot=entry.key[0])
        return self._admit(entry)

    def _committee_record(self, snap, key, committee) -> list:
        """[committee, pk objects, raws|None] for the fused flush,
        cached per (snapshot root, slot, committee key)."""
        cache_key = (snap.root, key[0], key[1])
        with self._lock:
            record = self._committees.get(cache_key)
            if record is not None:
                return record
        validators = snap.raw.validators
        objs = [
            bls.PublicKey.from_validated_bytes(
                bytes(validators[i].public_key)
            )
            for i in committee
        ]
        record = [tuple(committee), objs, None]
        with self._lock:
            if len(self._committees) >= 1024:
                self._committees = {}
            self._committees.setdefault(cache_key, record)
            record = self._committees[cache_key]
        return record

    # -- singleton-op admission ----------------------------------------------
    def admit_voluntary_exit(self, signed_exit) -> Admission:
        return self._admit_op("voluntary_exit", signed_exit,
                              "process_voluntary_exit")

    def admit_proposer_slashing(self, slashing) -> Admission:
        return self._admit_op("proposer_slashing", slashing,
                              "process_proposer_slashing")

    def admit_attester_slashing(self, slashing) -> Admission:
        return self._admit_op("attester_slashing", slashing,
                              "process_attester_slashing")

    def admit_bls_change(self, signed_change) -> Admission:
        return self._admit_op("bls_change", signed_change,
                              "process_bls_to_execution_change")

    def _admit_op(self, kind: str, container, processor_name: str) -> Admission:
        """Run the fork's OWN processor on the snapshot's scratch state
        inside a signature-collection scope: structural checks are the
        spec's, the collected sets defer into the window (RLC) or verify
        inline (scalar twin)."""
        t0 = time.perf_counter()
        entry = self._next_entry(kind)
        try:
            with trace.span("pool.admit", kind=kind):
                return self._admit_op_inner(entry, container, processor_name)
        finally:
            _metrics.histogram("pool.admit_s").observe(
                time.perf_counter() - t0
            )

    def _admit_op_inner(self, entry, container, processor_name) -> Admission:
        snap = self._head()
        if snap is None:
            return self._reject(entry, "no_head")
        if self._op_is_duplicate(entry.kind, container):
            return self._reject(entry, "duplicate")
        bp = self._fork_module(snap.fork).block_processing
        processor = getattr(bp, processor_name, None)
        if processor is None:  # e.g. BLS change before capella
            return self._reject(entry, "invalid")
        scratch = self._op_scratch(snap)
        entry.container = container
        entry.snap = snap
        # the scratch mutates as ops admit (an exit initiates, a slashing
        # slashes) — deliberately: co-admitted ops validate sequentially,
        # exactly as they will execute in a produced block. One engine
        # lock scope serializes scratch access.
        with self._lock:
            try:
                with collect_signatures() as batch:
                    processor(scratch, container, self.context)
            except Error:
                reject_invalid = True
            else:
                reject_invalid = False
                entry.sets = list(batch.sets)
        if reject_invalid:
            return self._reject(entry, "invalid")
        if not self.rlc:
            for s in entry.sets:
                if not s.verify():
                    return self._reject(entry, "signature")
            return self._finalize_op(entry)
        entry.set_verdicts = []
        self._enqueue(entry)
        return entry

    def _op_is_duplicate(self, kind: str, container) -> bool:
        return self.pool.op_held(kind, container)

    def _op_scratch(self, snap):
        """This ENGINE's mutable validation state for ``snap`` (never
        shared: a parallel engine — the scalar differential twin — must
        see its own op sequence, not ours). Bounded: one live scratch;
        a head rotation drops the old one."""
        with self._lock:
            scratch = self._scratches.get(snap.root)
        if scratch is None:
            built = snap.raw.copy()
            with self._lock:
                if len(self._scratches) >= 2:
                    self._scratches = {}
                self._scratches.setdefault(snap.root, built)
                scratch = self._scratches[snap.root]
        return scratch

    def _finalize_op(self, entry: Admission) -> Admission:
        pool = self.pool
        inserted = {
            "voluntary_exit": pool.insert_voluntary_exit,
            "proposer_slashing": pool.insert_proposer_slashing,
            "attester_slashing": pool.insert_attester_slashing,
            "bls_change": pool.insert_bls_change,
        }[entry.kind](entry.container)
        if not inserted:
            return self._reject(entry, "duplicate")
        return self._admit(entry)

    # -- the RLC window ------------------------------------------------------
    def _enqueue(self, entry: Admission) -> None:
        dispatch = None
        with self._lock:
            self._window.append(entry)
            _metrics.gauge("pool.window_pending").set(len(self._window))
            if len(self._window) >= self.window_size:
                dispatch, self._window = self._window, []
        if dispatch:
            self._dispatch(dispatch)

    def flush(self) -> None:
        """Dispatch the current partial window (if any)."""
        with self._lock:
            dispatch, self._window = self._window, []
        if dispatch:
            self._dispatch(dispatch)

    def _dispatch(self, entries: list) -> None:
        with trace.span("pool.flush.dispatch", messages=len(entries)):
            # the window's causal handoff token: anchored here (under
            # the admitting span when the dispatch rode an admit call),
            # stamped onto every ticket, adopted by the verify lane and
            # the settle path — admission→settle is one connected tree
            ctx = trace.context()
            tid = ctx.trace_id if ctx is not None else None
            for e in entries:
                e.trace_id = tid
            entries = self._membership_cull(entries)
            sets, attribution = self._build_sets(entries)
            if sets:
                future = bls.verify_signature_sets_async(
                    sets,
                    timer=lambda s: _metrics.histogram(
                        "pool.flush_verify_s"
                    ).observe(s, trace_id=tid),
                    trace_ctx=ctx,
                )
            else:
                future = None
        _metrics.counter("pool.flushes").inc()
        _metrics.histogram("pool.flush_window_messages").observe(len(entries))
        _metrics.histogram("pool.flush_sets").observe(len(sets))
        settle_now = None
        with self._lock:
            self._inflight.append((future, sets, attribution, entries, ctx))
            _metrics.gauge("pool.window_pending").set(len(self._window))
            if len(self._inflight) > self.max_inflight:
                settle_now = self._inflight.pop(0)
        if settle_now is not None:
            self._settle_one(settle_now)

    def _membership_cull(self, entries: list) -> list:
        """Batched G2 subgroup membership for the window's attestation
        signature points: one blinded MSM + one checked round-trip. On
        failure, per-point checks cull the offenders as ``malformed``."""
        att = [e for e in entries if e.kind == "attestation"]
        if not att:
            return entries
        from ..native import bls as native_bls

        if len(att) == 1:  # a lone point just gets the direct check
            rc, _, _ = native_bls.g2_decompress(
                att[0].sig_bytes, check_subgroup=True
            )
            if rc != 0:
                self._reject(att[0], "malformed")
                return [e for e in entries if e is not att[0]]
            return entries
        points = b"".join(e.sig_raw for e in att)
        blinders = b"".join(
            _nonzero_scalar16().rjust(32, b"\x00") for _ in att
        )
        try:
            combined, is_inf = native_bls.g2_msm(points, blinders, len(att))
            rc, _, _ = native_bls.g2_decompress(
                native_bls.g2_compress_raw(combined, is_inf),
                check_subgroup=True,
            )
            membership_ok = rc == 0 and not is_inf
        except Exception:  # noqa: BLE001 — fall back to per-point checks
            membership_ok = False
        _metrics.counter("pool.membership_batches").inc()
        if membership_ok:
            return entries
        _metrics.counter("pool.membership_batch_failures").inc()
        survivors = []
        for e in entries:
            if e.kind != "attestation":
                survivors.append(e)
                continue
            rc, _, _ = native_bls.g2_decompress(
                e.sig_bytes, check_subgroup=True
            )
            if rc == 0:
                survivors.append(e)
            else:
                self._reject(e, "malformed")
        return survivors

    def _group_raws(self, record: list) -> list:
        """Materialize (once) the committee's raw affine pubkeys through
        the eight-wide bulk decompression."""
        if record[2] is None:
            bls.warm_raw_keys(record[1])
            raws = [pk.raw_uncompressed() for pk in record[1]]
            with self._lock:
                if record[2] is None:
                    record[2] = raws
        return record[2]

    def _build_sets(self, entries: list) -> "tuple[list, list]":
        """The window's fused signature sets + attribution:
        ``("group", [entries])`` for a fused attestation claim,
        ``("op", entry, k)`` for a singleton op's k-th collected set."""
        from ..native import bls as native_bls

        sets: list = []
        attribution: list = []
        groups: dict = {}
        for e in entries:
            if e.kind == "attestation":
                groups.setdefault((e.key, bytes(e.msg_root)), []).append(e)
        for (key, msg_root), members in sorted(
            groups.items(), key=lambda kv: (kv[0][0][0], str(kv[0][0][1]),
                                            kv[0][0][2], kv[0][1])
        ):
            fused = self._fused_set(members, msg_root, native_bls)
            if fused is None:
                # MSM trouble: verify members individually (split path)
                for m in members:
                    sets.append(self._member_set(m))
                    attribution.append(("group", [m]))
                continue
            sets.append(fused)
            attribution.append(("group", members))
        for e in entries:
            if e.kind == "attestation":
                continue
            for k, s in enumerate(e.sets):
                sets.append(s)
                attribution.append(("op", e, k))
        return sets, attribution

    def _fused_set(self, members: list, msg_root: bytes, native_bls):
        """One SignatureSet proving every member's claim at once:
        multiplicity-weighted G1 MSM over the committee for the key
        side, signature sum for the G2 side."""
        record = members[0].committee_ref
        committee = record[0]
        raws = self._group_raws(record)
        try:
            import numpy as np

            counts = np.array(
                [m.bits for m in members], dtype=np.uint32
            ).sum(axis=0).tolist()
        except Exception:  # noqa: BLE001 — numpy-less: scalar sum
            counts = [0] * len(committee)
            for m in members:
                for i, b in enumerate(m.bits):
                    if b:
                        counts[i] += 1
        nz = [i for i, c in enumerate(counts) if c]
        try:
            points = b"".join(raws[i] for i in nz)
            scalars = b"".join(
                counts[i].to_bytes(32, "big") for i in nz
            )
            agg_raw, is_inf = native_bls.g1_msm(points, scalars, len(nz))
            if is_inf:
                return None
            agg_pk = bls.PublicKey._from_valid_bytes(
                native_bls.g1_compress_raw(agg_raw)
            )
            agg_pk._raw = agg_raw
            ones = b"".join(
                (1).to_bytes(32, "big") for _ in members
            )
            sig_raw, sig_inf = native_bls.g2_msm(
                b"".join(m.sig_raw for m in members), ones, len(members)
            )
            merged_sig = bls.Signature._from_valid_bytes(
                native_bls.g2_compress_raw(sig_raw, sig_inf)
            )
        except Exception:  # noqa: BLE001 — degrade to the split path
            _metrics.counter("pool.fallback.fuse_failed").inc()
            return None
        _metrics.counter("pool.fused_groups").inc()
        return bls.SignatureSet([agg_pk], msg_root, merged_sig)

    def _member_set(self, entry: Admission):
        record = entry.committee_ref
        keys = [record[1][i] for i, b in enumerate(entry.bits) if b]
        return bls.SignatureSet(
            keys, entry.msg_root,
            bls.Signature._from_valid_bytes(entry.sig_bytes),
        )

    # -- settlement ----------------------------------------------------------
    def settle(self, flush: bool = True) -> None:
        """Drain every dispatched window (optionally flushing the
        partial one first) and resolve all tickets."""
        if flush:
            self.flush()
        while True:
            with self._lock:
                if not self._inflight:
                    return
                item = self._inflight.pop(0)
            self._settle_one(item)

    def _settle_one(self, item) -> None:
        future, sets, attribution, entries, ctx = item
        verdicts = future.result() if future is not None else []
        # the settle span joins the window's causal tree (adopting the
        # context anchored at its dispatch span)
        with trace.adopt(ctx), \
                trace.span("pool.flush.settle", messages=len(entries)):
            # sig_ok writes are settle-private: a window settles exactly
            # once (popped under the engine lock), so its entries have
            # one writer here; callers read only the status field
            for (tag, *rest), verdict in zip(attribution, verdicts):
                if tag == "group":
                    members = rest[0]
                    if verdict:
                        for m in members:
                            m.sig_ok = True
                    else:
                        # split: re-verify each member's own claim so
                        # only the offenders reject — exact blame
                        _metrics.counter("pool.flush_splits").inc()
                        for m in members:
                            m.sig_ok = self._member_set(m).verify()
                else:
                    entry, _k = rest
                    entry.set_verdicts.append(bool(verdict))
            # resolve tickets in ADMISSION order: in-window redundancy
            # (a duplicate of a not-yet-settled aggregate) resolves
            # exactly as the scalar twin's message-by-message pool would
            for entry in sorted(
                (e for e in entries if e.status == "pending"),
                key=lambda e: e.order,
            ):
                if entry.kind == "attestation":
                    if entry.sig_ok:
                        # the insert's locked classify IS the in-order
                        # redundancy verdict (duplicate/subset reject
                        # inside _finalize)
                        self._finalize_attestation(entry)
                    else:
                        # a failed signature still reports redundancy
                        # FIRST — the per-message twin never reaches
                        # the pairing for a duplicate/subset
                        verdict = self.pool.classify_attestation(
                            entry.key, len(entry.bits), list(entry.bits)
                        )
                        self._reject(
                            entry,
                            "signature" if verdict == "new" else verdict,
                        )
                else:
                    if entry.set_verdicts is not None and all(
                        entry.set_verdicts
                    ) and len(entry.set_verdicts) == len(entry.sets):
                        self._finalize_op(entry)
                    else:
                        self._reject(entry, "signature")
        if ctx is not None:
            # one settled pool window = one linked trace: count it and
            # feed the slow-trace ring (dispatch capture → settle done)
            _metrics.counter("trace.windows_linked").inc()
            trace.note_trace(
                ctx, "pool.window",
                max(0.0, time.perf_counter() - ctx.ts),
                messages=len(entries), sets=len(sets),
            )

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rlc": self.rlc,
                "window_size": self.window_size,
                "window_pending": len(self._window),
                "inflight_windows": len(self._inflight),
            }


def _attester_domain_type():
    from ..domains import DomainType

    return DomainType.BEACON_ATTESTER


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _nonzero_scalar16() -> bytes:
    while True:
        s = secrets.token_bytes(16)
        if any(s):
            return s
