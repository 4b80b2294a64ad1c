"""HeadStore — immutable per-commit snapshots for the Beacon-API read
plane.

The pipeline engine copies the post-window state at dispatch (while the
live state IS it) and publishes the copy on the commit hook's STATE
channel when the window's verdicts come back clean
(``telemetry/flight.py``). This module is the subscriber: a bounded
history of ``Snapshot`` objects — committed state handle, its
``RegistryColumns`` read-only bundle, slot/root/fork metadata — with
``state_id`` resolution (head / slot / root / finalized / justified).

Isolation contract: a snapshot's state is a structural copy that
NOTHING mutates after publication. The copy-on-write column travel
across ``state.copy()`` (models/ops_vector.py) means the columns the live
pipeline keeps warm arrive for free; the first reader-side sync clones
before refreshing any residual dirty rows, so the live state's later
writes can never tear a response — a reader resolves exactly one
snapshot per request and serves entirely from it. Rolled-back states
are structurally unservable: the engine publishes only at commit
boundaries, after the window's signatures proved.

Locking: store mutations hold
``HeadStore._lock``; per-snapshot lazy builds (column bundle, duty
maps, memoized documents) hold ``Snapshot._lock``. Neither lock is ever
held while calling into the other, and resolution returns plain
references, so readers gather lock-free once a bundle exists.

Reference parity: ethereum_consensus_tpu/serving/headstore.py.
"""

from __future__ import annotations

import threading
import time
import weakref

from ..models import ops_vector
from ..telemetry import flight as _flight
from ..telemetry import metrics as _metrics

__all__ = ["Snapshot", "HeadStore", "DEFAULT_CAPACITY",
           "registered_stores"]

# every live HeadStore, for the memory observatory's
# ``serving.snapshots`` owner census (telemetry/memory.py): snapshot
# counts + frozen-bundle bytes across the process. WeakValueDictionary
# keyed by id (stores die, the census must not pin them).
_STORES: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def registered_stores() -> list:
    """Live HeadStore instances (census snapshot, GC-safe)."""
    return [s for s in (r() for r in _STORES.valuerefs()) if s is not None]

DEFAULT_CAPACITY = 64

# per-snapshot memoized-document cap: a pathological query mix clears
# the memo rather than growing it without bound (snapshots are already
# bounded by the store's history, this bounds each one's footprint)
_MEMO_CAP = 256


class Snapshot:
    """One committed state frozen for readers.

    ``state`` may be the executor's polymorphic ``BeaconState`` wrapper
    or a bare fork container; ``raw`` is always the container (what the
    spec helpers and the columnar engine take). ``root`` is the state's
    hash_tree_root as bytes — for pipeline-published snapshots it is the
    block's claimed (and stage-A-verified) post-state root, a free field
    read. ``block_root`` is the head BLOCK's hash_tree_root (the
    flight-lineage claimed block root for pipeline publishes, derived
    from ``latest_block_header`` otherwise) — the duties endpoints'
    ``dependent_root`` anchor and the store's block-root index key."""

    __slots__ = (
        "state",
        "raw",
        "context",
        "slot",
        "root",
        "block_root",
        "block",
        "fork",
        "seq",
        "published_at",
        "_lock",
        "_bundle",
        "_bundle_built",
        "_memo",
    )

    def __init__(self, state, context, slot: int, root: bytes, seq=None,
                 block_root: "bytes | None" = None, block=None):
        self.state = state
        self.raw = getattr(state, "data", state)
        self.context = context
        self.slot = int(slot)
        self.root = bytes(root)
        if block_root is None:
            from . import oracle as _oracle

            block_root = _oracle.head_block_root(self.raw)
        self.block_root = bytes(block_root)
        # the committed SignedBeaconBlock (pipeline publishes carry it
        # since the proof plane landed; None for pipeline-less publishes
        # that don't pass one): the light-client endpoints read its
        # sync_aggregate and prove execution_branch over its body
        self.block = block
        version = getattr(state, "version", None)
        self.fork = version().name.lower() if version is not None else None
        self.seq = seq
        self.published_at = time.time()
        self._lock = threading.Lock()
        self._bundle = None
        self._bundle_built = False
        self._memo: dict = {}

    # -- columnar bundle -----------------------------------------------------
    def bundle(self) -> "dict | None":
        """The frozen ``registry_snapshot`` column bundle (read-only
        views), built once under the snapshot lock — the column sync
        machinery mutates list-resident cache records, so the build must
        not race; afterwards readers share the views lock-free. None →
        scalar fallback (no numpy / exotic values / engine off)."""
        if self._bundle_built:  # benign race: build is idempotent
            return self._bundle
        with self._lock:
            if not self._bundle_built:
                cols = ops_vector.columns_for(self.raw)
                self._bundle = (
                    cols.registry_snapshot(self.raw)
                    if cols is not None
                    else None
                )
                self._bundle_built = True
        return self._bundle

    # -- per-snapshot document memo ------------------------------------------
    def memo(self, key, build):
        """Memoize an immutable response document per snapshot (duty
        maps, committee tables, rewards summaries — all pure functions
        of this frozen state). ``build`` runs under the snapshot lock:
        the spec helpers it calls keep ``state.__dict__`` memo caches
        that must not be rebuilt concurrently."""
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        with self._lock:
            hit = self._memo.get(key)
            if hit is None:
                hit = build()
                if len(self._memo) >= _MEMO_CAP:
                    self._memo = {}
                self._memo[key] = hit
        return hit

    def root_hex(self) -> str:
        return "0x" + self.root.hex()

    def __repr__(self) -> str:
        return (
            f"Snapshot(slot={self.slot}, fork={self.fork}, "
            f"root=0x{self.root.hex()[:12]}…)"
        )


class HeadStore:
    """Bounded history of committed snapshots + ``state_id`` resolution.

    ``attach()`` subscribes the store to the process-wide commit hook's
    state channel — from then on every pipeline commit publishes a new
    head here (and flips the engine's ``state_active`` guard, paying one
    state copy per flush window). ``publish()`` feeds the store directly
    for pipeline-less serving (tests, benches, a warm state put up for
    reads)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._capacity = max(1, int(capacity))
        self._history: list = []  # oldest → newest
        self._by_root: dict = {}
        self._by_block_root: dict = {}  # the block-root index
        self._attached = False
        _STORES[id(self)] = self  # memory-observatory census membership

    # -- lifecycle -----------------------------------------------------------
    def attach(self) -> "HeadStore":
        with self._lock:
            if not self._attached:
                self._attached = True
                _flight.HOOK.subscribe_states(self.handle_state)
        return self

    def detach(self) -> None:
        with self._lock:
            attached, self._attached = self._attached, False
        if attached:
            _flight.HOOK.unsubscribe_states(self.handle_state)

    def __enter__(self) -> "HeadStore":
        return self.attach()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.detach()

    # -- publication ---------------------------------------------------------
    def handle_state(self, payload: dict) -> None:
        """Commit-hook state-channel subscriber (must never raise into
        the pipeline — the hook counts and swallows if we do)."""
        root = payload["root"]
        block_root = payload.get("block_root")
        if block_root is not None:
            block_root = bytes.fromhex(
                block_root[2:] if block_root.startswith("0x") else block_root
            )
        self._install(
            Snapshot(
                payload["state"],
                payload["context"],
                payload["slot"],
                bytes.fromhex(root[2:] if root.startswith("0x") else root),
                seq=payload.get("seq"),
                block_root=block_root,
                block=payload.get("block"),
            )
        )

    def publish(self, state, context, slot=None, root=None, seq=None,
                block_root=None, block=None):
        """Directly publish ``state`` (NOT copied — hand the store a
        state nothing else will mutate). Root/slot/block root computed
        from the state when omitted; pass ``block`` (the committed
        SignedBeaconBlock) to enable the light-client endpoints that
        need a sync aggregate or an execution branch."""
        raw = getattr(state, "data", state)
        if root is None:
            root = type(raw).hash_tree_root(raw)
        if slot is None:
            slot = int(raw.slot)
        snap = Snapshot(state, context, slot, root, seq=seq,
                        block_root=block_root, block=block)
        self._install(snap)
        return snap

    def _install(self, snap: Snapshot) -> None:
        with self._lock:
            self._history.append(snap)
            self._by_root[snap.root] = snap
            self._by_block_root[snap.block_root] = snap
            while len(self._history) > self._capacity:
                old = self._history.pop(0)
                if self._by_root.get(old.root) is old:
                    del self._by_root[old.root]
                if self._by_block_root.get(old.block_root) is old:
                    del self._by_block_root[old.block_root]
                _metrics.counter("serving.snapshots.evicted").inc()
        _metrics.counter("serving.snapshots.published").inc()
        _metrics.gauge("serving.head_slot").set(snap.slot)

    def clear(self) -> None:
        with self._lock:
            self._history = []
            self._by_root = {}
            self._by_block_root = {}

    def memory_census(self) -> "tuple[int, int]":
        """(resident bytes, retained snapshots) for the memory
        observatory: the frozen column bundles' array bytes (deduped —
        copy-on-write travel can share buffers across snapshots). The
        state handles themselves are attributed through the SSZ list
        census (their lists are tracked), not double-counted here."""
        nbytes = 0
        seen: set = set()
        snaps = self.snapshots()
        for snap in snaps:
            bundle = snap._bundle
            if isinstance(bundle, dict):
                for arr in bundle.values():
                    if id(arr) not in seen:
                        seen.add(id(arr))
                        nbytes += int(getattr(arr, "nbytes", 0))
        return nbytes, len(snaps)

    # -- resolution ----------------------------------------------------------
    @property
    def head(self) -> "Snapshot | None":
        with self._lock:
            return self._history[-1] if self._history else None

    def __len__(self) -> int:
        return len(self._history)

    def snapshots(self) -> "list[Snapshot]":
        """Every retained snapshot, oldest first (consistent copy)."""
        with self._lock:
            return list(self._history)

    def resolve(self, state_id) -> "Snapshot | None":
        """``head`` / slot number / ``0x``-root / ``finalized`` /
        ``justified`` → the matching retained snapshot, or None (the
        handler's 404). ``genesis`` resolves only while a slot-0
        snapshot is retained. Slot resolution is exact-match newest-
        first: snapshots exist per commit, not per slot. A 0x-root
        resolves against the state-root index first, then the
        block-root index (duties clients pin reads to dependent_root)."""
        value = getattr(state_id, "value", state_id)
        if isinstance(value, str):
            if value == "head":
                return self.head
            if value in ("finalized", "justified"):
                return self._checkpoint_snapshot(value)
            if value == "genesis":
                return self._newest(lambda s: s.slot == 0)
            if value.startswith("0x"):
                try:
                    value = bytes.fromhex(value[2:])
                except ValueError:
                    return None
            elif value.isdigit():
                value = int(value)
            else:
                return None
        if isinstance(value, bytes):
            with self._lock:
                hit = self._by_root.get(bytes(value))
                if hit is None:
                    # the block-root index: duties clients pin follow-up
                    # reads to dependent_root, which is a BLOCK root
                    hit = self._by_block_root.get(bytes(value))
                return hit
        if isinstance(value, int):
            return self._newest(lambda s: s.slot == value)
        return None

    def _newest(self, predicate) -> "Snapshot | None":
        with self._lock:
            for snap in reversed(self._history):
                if predicate(snap):
                    return snap
        return None

    def _checkpoint_snapshot(self, which: str) -> "Snapshot | None":
        head = self.head
        if head is None:
            return None
        field = (
            "finalized_checkpoint"
            if which == "finalized"
            else "current_justified_checkpoint"
        )
        checkpoint = getattr(head.raw, field, None)
        if checkpoint is None:
            return None
        boundary = int(checkpoint.epoch) * int(
            head.context.SLOTS_PER_EPOCH
        )
        return self._newest(lambda s: s.slot <= boundary)

    def __repr__(self) -> str:
        head = self.head
        return (
            f"HeadStore({len(self._history)}/{self._capacity} snapshots, "
            f"head={head!r})"
        )
