"""Columnar operation-pool store.

The write data plane's hot state: every attestation aggregate the
admission engine accepts lands here as ONE ROW of a packed uint64
bitfield matrix keyed by ``(slot, committee_key, data_root)`` — the
``AggregateGroup``. Redundancy elimination (exact duplicates, subsets of
an already-held aggregate) is a vectorized mask over the group's matrix,
so the common gossip case — aggregators re-publishing near-identical
views of the same committee — is rejected for the cost of a few word-ops
before any cryptography runs. Best-aggregate selection for block
production walks the same matrices (``pool/selection.py``).

The scalar twin of every bitfield operation lives right next to the
vectorized one (python ints as bitmasks, ``scalar=True``) — the live
fallback when numpy is absent AND the differential oracle
the pool's tests diff against, the ``ops_vector`` house pattern.

Beyond attestations the pool holds the block-includable singleton ops —
voluntary exits, proposer slashings, attester slashings, BLS-to-execution
changes — deduplicated by their natural key, plus the equivocation
ledger: one vote record per ``(validator, target_epoch)``; a verified
attestation contradicting a recorded vote surfaces an
``AttesterSlashing`` into the pool (``pool.slashings_surfaced``), which
block production then executes through ``process_attester_slashing``.

Concurrency: every read and write of pool state holds
``OperationPool._lock``; the lock is never held while calling into a
snapshot or the bls layer, so it can never participate in a lock-order
cycle with ``Snapshot._lock`` or the metric locks.

Reference parity: ethereum_consensus_tpu/pool/store.py.
"""

from __future__ import annotations

import threading
import weakref

from ..telemetry import metrics as _metrics

__all__ = ["AggregateGroup", "OperationPool", "pack_bits", "bits_to_int",
           "registered_pools"]

# every live OperationPool, for the memory observatory's ``pool.store``
# owner census (telemetry/memory.py): bitfield-matrix bytes + held rows
# across the process.
_POOLS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def registered_pools() -> list:
    """Live OperationPool instances (census snapshot, GC-safe)."""
    return [p for p in (r() for r in _POOLS.valuerefs()) if p is not None]

# one uint64 lane holds 64 committee members; mainnet committees are
# ~64-2048 members → 1-32 words per row
_WORD = 64


def _np():
    try:
        import numpy

        return numpy
    except Exception:  # noqa: BLE001 — environment without numpy
        return None


def pack_bits(bits) -> "object":
    """Bool sequence → little-endian packed uint64 row (numpy)."""
    np = _np()
    arr = np.asarray(bits, dtype=np.uint8)
    n_words = (arr.shape[0] + _WORD - 1) // _WORD
    packed = np.packbits(arr, bitorder="little")
    out = np.zeros(n_words * 8, dtype=np.uint8)
    out[: packed.shape[0]] = packed
    return out.view("<u8")


def bits_to_int(bits) -> int:
    """Bool sequence → python int bitmask (the scalar twin's row)."""
    mask = 0
    for i, b in enumerate(bits):
        if b:
            mask |= 1 << i
    return mask


class AggregateGroup:
    """Every aggregate held for one ``(slot, committee_key, data_root)``.

    ``bits`` is the packed matrix (rows = aggregates, columns = packed
    committee positions); ``masks`` is the scalar twin (one python int
    per row) maintained in lockstep so the vectorized and scalar engines
    answer dedup/selection questions identically. Rows are append-only;
    the matrix grows by doubling, and readers always slice ``[:n]``.
    Access is guarded by the owning pool's lock."""

    __slots__ = (
        "slot",
        "committee_key",
        "data_root",
        "committee_size",
        "bits",
        "masks",
        "n",
        "signatures",
        "attestations",
    )

    def __init__(self, slot: int, committee_key, data_root: bytes,
                 committee_size: int):
        self.slot = int(slot)
        self.committee_key = committee_key
        self.data_root = bytes(data_root)
        self.committee_size = int(committee_size)
        self.bits = None  # lazily shaped on first insert
        self.masks: list = []  # scalar-twin rows (python ints)
        self.n = 0
        self.signatures: list = []  # compressed signature bytes per row
        self.attestations: list = []  # the SSZ containers, row-aligned

    # -- dedup ---------------------------------------------------------------
    def classify(self, bit_list, scalar: bool = False) -> str:
        """``new`` / ``duplicate`` / ``subset`` of an incoming aggregate
        against the held rows. A duplicate is an exact row match; a
        subset adds no attester any held row doesn't already cover."""
        mask = bits_to_int(bit_list)
        if scalar or self.bits is None or _np() is None:
            for held in self.masks[: self.n]:
                if held == mask:
                    return "duplicate"
            for held in self.masks[: self.n]:
                if mask & ~held == 0:
                    return "subset"
            return "new"
        np = _np()
        row = pack_bits(bit_list)
        held = self.bits[: self.n]
        if bool(np.any(np.all(held == row, axis=1))):
            return "duplicate"
        if bool(np.any(np.all(row & ~held == 0, axis=1))):
            return "subset"
        return "new"

    def insert(self, bit_list, signature: bytes, attestation) -> int:
        """Append one aggregate row (caller already classified it as
        ``new``); returns the row index."""
        np = _np()
        mask = bits_to_int(bit_list)
        if np is not None:
            row = pack_bits(bit_list)
            if self.bits is None:
                self.bits = np.zeros((4, row.shape[0]), dtype=np.uint64)
            elif self.n == self.bits.shape[0]:
                grown = np.zeros(
                    (self.bits.shape[0] * 2, self.bits.shape[1]),
                    dtype=np.uint64,
                )
                grown[: self.n] = self.bits[: self.n]
                self.bits = grown
            self.bits[self.n] = row
        self.masks.append(mask)
        self.signatures.append(bytes(signature))
        self.attestations.append(attestation)
        self.n += 1
        return self.n - 1

    def coverage_mask(self) -> int:
        """Union of every held row (scalar form)."""
        covered = 0
        for mask in self.masks[: self.n]:
            covered |= mask
        return covered

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        return (
            f"AggregateGroup(slot={self.slot}, key={self.committee_key!r}, "
            f"root=0x{self.data_root.hex()[:8]}…, rows={self.n})"
        )


class _VoteRecord:
    """One verified attester vote per (validator, target_epoch): enough
    of the indexed attestation to rebuild it for a slashing. The source
    epoch is denormalized out of ``data`` so the surround scan reads an
    int per record instead of walking SSZ containers."""

    __slots__ = ("data_root", "indices", "data", "signature",
                 "source_epoch")

    def __init__(self, data_root: bytes, indices, data, signature: bytes):
        self.data_root = bytes(data_root)
        self.indices = tuple(int(i) for i in indices)
        self.data = data
        self.signature = bytes(signature)
        self.source_epoch = int(data.source.epoch)


class OperationPool:
    """The write data plane's operation state: attestation aggregate
    groups plus the singleton op pools, all behind one lock."""

    def __init__(self, max_groups: int = 4096, max_votes: int = 1 << 16):
        self._lock = threading.Lock()
        self._groups: dict = {}  # (slot, committee_key, data_root) -> group
        self._exits: dict = {}  # validator index -> SignedVoluntaryExit
        self._proposer_slashings: dict = {}  # proposer index -> slashing
        self._attester_slashings: dict = {}  # htr root -> container
        self._bls_changes: dict = {}  # validator index -> signed change
        self._votes: dict = {}  # (validator, target_epoch) -> _VoteRecord
        self._max_groups = int(max_groups)
        self._max_votes = int(max_votes)
        self._seq = 0
        _POOLS[id(self)] = self  # memory-observatory census membership

    # -- attestations --------------------------------------------------------
    def classify_attestation(self, key, committee_size: int, bit_list,
                             scalar: bool = False) -> str:
        """Dedup verdict for an incoming aggregate without inserting —
        the admission engine's pre-crypto redundancy gate."""
        with self._lock:
            group = self._groups.get(key)
            if group is None:
                return "new"
            return group.classify(bit_list, scalar=scalar)

    def insert_attestation(self, key, committee_size: int, bit_list,
                           signature: bytes, attestation,
                           scalar: bool = False) -> "tuple[int | None, str]":
        """Insert a VERIFIED aggregate; returns ``(row index, "new")``
        on insertion, or ``(None, "duplicate"|"subset")`` — the insert
        re-classifies under the pool lock, so it doubles as the settle
        path's in-order redundancy verdict (one vector pass, no
        classify-then-insert double walk)."""
        slot, committee_key, data_root = key
        with self._lock:
            group = self._groups.get(key)
            if group is None:
                if len(self._groups) >= self._max_groups:
                    oldest = min(self._groups, key=lambda k: k[0])
                    del self._groups[oldest]
                    _metrics.counter("pool.groups.evicted").inc()
                group = AggregateGroup(slot, committee_key, data_root,
                                       committee_size)
                self._groups[key] = group
            verdict = group.classify(bit_list, scalar=scalar)
            if verdict != "new":
                return None, verdict
            row = group.insert(bit_list, signature, attestation)
            self._seq += 1
        _metrics.counter("pool.attestations.held").inc()
        _metrics.gauge("pool.groups").set(len(self._groups))
        return row, "new"

    def groups(self, slot=None, committee_index=None) -> list:
        """Consistent list of groups (sorted by key — the canonical
        selection / serving order), optionally filtered the Beacon-API
        way (``?slot=`` / ``?committee_index=``)."""
        with self._lock:
            out = [
                self._groups[k]
                for k in sorted(self._groups, key=_group_sort_key)
            ]
        if slot is not None:
            out = [g for g in out if g.slot == int(slot)]
        if committee_index is not None:
            wanted = int(committee_index)
            out = [
                g for g in out
                if (g.committee_key == wanted
                    or (isinstance(g.committee_key, tuple)
                        and wanted in g.committee_key))
            ]
        return out

    def attestations_view(self, slot=None, committee_index=None) -> list:
        """Every held aggregate as its SSZ container, group-sorted then
        row-ordered — the ``GET /eth/v1/beacon/pool/attestations`` body,
        identical between the vectorized and scalar engines because
        insertion order is admission order in both."""
        out = []
        for group in self.groups(slot=slot, committee_index=committee_index):
            with self._lock:
                out.extend(group.attestations[: group.n])
        return out

    # -- the equivocation ledger --------------------------------------------
    def note_votes(self, attesting_indices, data, data_root: bytes,
                   signature: bytes, builder) -> list:
        """Record one verified attestation's votes; returns any
        ``AttesterSlashing`` containers surfaced by a contradiction —
        BOTH arms of ``is_slashable_attestation_data``:

        * **double vote** — same validator, same target epoch, different
          data (the ledger's primary key collides);
        * **surround vote** — the same validator's vote in ANOTHER
          target epoch where one vote's (source, target) span strictly
          contains the other's (``source_1 < source_2`` and
          ``target_2 < target_1``). The scan walks the validator's
          records across the ledger's target-epoch maps — O(live
          epochs) int compares per attester, and the spec's surround
          arm needs exactly the cross-epoch records the ledger already
          keeps.

        ``builder`` is the fork namespace used to rebuild the two
        ``IndexedAttestation`` halves; ``attestation_1`` is always the
        half the spec predicate orders first (the earlier double vote /
        the SURROUNDING vote). Slashings land in the pool's own
        attester-slashing pool as well as being returned."""
        data_root = bytes(data_root)
        target_epoch = int(data.target.epoch)
        record = _VoteRecord(data_root, sorted(attesting_indices), data,
                             signature)
        surfaced = []
        with self._lock:
            epoch_votes = self._votes.get(target_epoch)
            if epoch_votes is None:
                epoch_votes = self._votes[target_epoch] = {}
            if len(epoch_votes) >= self._max_votes:
                epoch_votes.clear()  # bounded ledger, epoch-scoped
            pairs = []  # (surrounding-or-earlier, other) in spec order
            for index in record.indices:
                prior = epoch_votes.setdefault(index, record)
                if prior is not record and prior.data_root != data_root:
                    pairs.append((prior, record))
                for other_epoch, other_votes in self._votes.items():
                    if other_epoch == target_epoch:
                        continue
                    other = other_votes.get(index)
                    if other is None:
                        continue
                    if (other.source_epoch < record.source_epoch
                            and target_epoch < other_epoch):
                        # the OTHER vote surrounds the new one
                        pairs.append((other, record))
                    elif (record.source_epoch < other.source_epoch
                            and other_epoch < target_epoch):
                        # the new vote surrounds the other
                        pairs.append((record, other))
            for first, second in pairs:
                slashing = _build_slashing(first, second, builder)
                root = bytes(type(slashing).hash_tree_root(slashing))
                if root not in self._attester_slashings:
                    self._attester_slashings[root] = slashing
                    surfaced.append(slashing)
        for _ in surfaced:
            _metrics.counter("pool.slashings_surfaced").inc()
        return surfaced

    def vote_ledger_digest(self) -> "list":
        """A deterministic digest of the equivocation ledger — one
        ``(target_epoch, validator, data_root hex, source_epoch)`` row
        per recorded vote, sorted — the production soak's end-of-run
        ledger bit-identity comparand."""
        with self._lock:
            return sorted(
                (epoch, index, record.data_root.hex(),
                 record.source_epoch)
                for epoch, votes in self._votes.items()
                for index, record in votes.items()
            )

    # -- singleton op pools --------------------------------------------------
    def insert_voluntary_exit(self, signed_exit) -> bool:
        index = int(signed_exit.message.validator_index)
        with self._lock:
            if index in self._exits:
                return False
            self._exits[index] = signed_exit
        _metrics.counter("pool.voluntary_exits.held").inc()
        return True

    def insert_proposer_slashing(self, slashing) -> bool:
        index = int(slashing.signed_header_1.message.proposer_index)
        with self._lock:
            if index in self._proposer_slashings:
                return False
            self._proposer_slashings[index] = slashing
        _metrics.counter("pool.proposer_slashings.held").inc()
        return True

    def insert_attester_slashing(self, slashing) -> bool:
        root = bytes(type(slashing).hash_tree_root(slashing))
        with self._lock:
            if root in self._attester_slashings:
                return False
            self._attester_slashings[root] = slashing
        _metrics.counter("pool.attester_slashings.held").inc()
        return True

    def insert_bls_change(self, signed_change) -> bool:
        index = int(signed_change.message.validator_index)
        with self._lock:
            if index in self._bls_changes:
                return False
            self._bls_changes[index] = signed_change
        _metrics.counter("pool.bls_changes.held").inc()
        return True

    def op_held(self, kind: str, container) -> bool:
        """Pre-crypto duplicate probe for a singleton op (the admission
        engine's cheap-reject gate; insertion re-checks under the same
        lock, so a racing admit is still counted as a duplicate)."""
        with self._lock:
            if kind == "voluntary_exit":
                return int(container.message.validator_index) in self._exits
            if kind == "proposer_slashing":
                return (
                    int(container.signed_header_1.message.proposer_index)
                    in self._proposer_slashings
                )
            if kind == "attester_slashing":
                root = bytes(type(container).hash_tree_root(container))
                return root in self._attester_slashings
            return (
                int(container.message.validator_index) in self._bls_changes
            )

    def voluntary_exits(self) -> list:
        with self._lock:
            return [self._exits[k] for k in sorted(self._exits)]

    def proposer_slashings(self) -> list:
        with self._lock:
            return [
                self._proposer_slashings[k]
                for k in sorted(self._proposer_slashings)
            ]

    def attester_slashings(self) -> list:
        with self._lock:
            return [
                self._attester_slashings[k]
                for k in sorted(self._attester_slashings)
            ]

    def bls_changes(self) -> list:
        with self._lock:
            return [self._bls_changes[k] for k in sorted(self._bls_changes)]

    # -- lifecycle -----------------------------------------------------------
    def prune_included(self, body) -> None:
        """Drop ops a just-produced (or observed) block body carries —
        the post-production drain."""
        with self._lock:
            for att in body.attestations:
                data_root = bytes(
                    type(att.data).hash_tree_root(att.data)
                )
                for key in [
                    k for k in self._groups if k[2] == data_root
                ]:
                    del self._groups[key]
            for op in body.voluntary_exits:
                self._exits.pop(int(op.message.validator_index), None)
            for op in body.proposer_slashings:
                self._proposer_slashings.pop(
                    int(op.signed_header_1.message.proposer_index), None
                )
            for op in body.attester_slashings:
                root = bytes(type(op).hash_tree_root(op))
                self._attester_slashings.pop(root, None)
            for op in getattr(body, "bls_to_execution_changes", ()):
                self._bls_changes.pop(int(op.message.validator_index), None)
        _metrics.gauge("pool.groups").set(len(self._groups))

    def prune_expired(self, slot: int, slots_per_epoch: int) -> int:
        """Drop attestation groups past their inclusion window (and the
        vote ledger's expired epochs); returns groups dropped."""
        slot = int(slot)
        horizon_epoch = max(0, slot // int(slots_per_epoch) - 2)
        with self._lock:
            stale = [
                key for key, g in self._groups.items()
                if g.slot + int(slots_per_epoch) < slot
            ]
            for key in stale:
                del self._groups[key]
            dead_votes = [
                epoch for epoch in self._votes if epoch < horizon_epoch
            ]
            for epoch in dead_votes:
                del self._votes[epoch]
        if stale:
            _metrics.counter("pool.groups.expired").inc(len(stale))
            _metrics.gauge("pool.groups").set(len(self._groups))
        return len(stale)

    def counts(self) -> dict:
        """The ``/pool`` introspection summary."""
        with self._lock:
            return {
                "attestation_groups": len(self._groups),
                "attestation_rows": sum(
                    g.n for g in self._groups.values()
                ),
                "voluntary_exits": len(self._exits),
                "proposer_slashings": len(self._proposer_slashings),
                "attester_slashings": len(self._attester_slashings),
                "bls_to_execution_changes": len(self._bls_changes),
                "vote_records": sum(
                    len(v) for v in self._votes.values()
                ),
            }

    def memory_census(self) -> "tuple[int, int]":
        """(resident bytes, held aggregate rows) for the memory
        observatory's ``pool.store`` owner: the packed bitfield
        matrices (full allocated capacity, not just the ``[:n]`` live
        slice — doubling growth retains the whole buffer), the
        signature bytes, and the vote ledger's fixed-size records
        (pointer-width estimate per record)."""
        with self._lock:
            nbytes = 0
            rows = 0
            for group in self._groups.values():
                rows += group.n
                bits = group.bits
                if bits is not None:
                    nbytes += int(bits.nbytes)
                nbytes += sum(len(s) for s in group.signatures)
                nbytes += len(group.masks) * 8
            nbytes += sum(len(v) for v in self._votes.values()) * 128
            return nbytes, rows

    def clear(self) -> None:
        with self._lock:
            self._groups = {}
            self._exits = {}
            self._proposer_slashings = {}
            self._attester_slashings = {}
            self._bls_changes = {}
            self._votes = {}

    def __repr__(self) -> str:
        c = self.counts()
        return (
            f"OperationPool({c['attestation_groups']} groups / "
            f"{c['attestation_rows']} aggregates, "
            f"{c['voluntary_exits']} exits, "
            f"{c['attester_slashings']} att-slashings)"
        )


def _build_slashing(first, second, builder):
    """One ``AttesterSlashing`` from two vote records already ordered
    for ``is_slashable_attestation_data`` (attestation_1 = the earlier
    double vote / the surrounding vote)."""
    return builder.AttesterSlashing(
        attestation_1=builder.IndexedAttestation(
            attesting_indices=list(first.indices),
            data=first.data.copy(),
            signature=first.signature,
        ),
        attestation_2=builder.IndexedAttestation(
            attesting_indices=list(second.indices),
            data=second.data.copy(),
            signature=second.signature,
        ),
    )


def _group_sort_key(key):
    """Canonical group order shared by serving and selection: slot, then
    committee key (ints before tuples, both orderable), then data root."""
    slot, committee_key, data_root = key
    if isinstance(committee_key, tuple):
        ck = (1,) + committee_key
    else:
        ck = (0, int(committee_key))
    return (slot, ck, data_root)
