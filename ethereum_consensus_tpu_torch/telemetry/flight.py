"""Chain flight recorder: per-block lineage off the pipeline commit hook.

Reference parity: ethereum_consensus_tpu/telemetry/flight.py.

Spans answer "where did the microseconds go inside one call"; the bench
answers "how fast is the hot path on average". Neither answers the
operational question a serving node gets paged for: *why was block N
slow / rolled back / late*. The flight recorder does — one bounded ring
journal of ``BlockLineage`` records, one record per block disposition,
assembled by the pipeline engine (``pipeline/engine.py``) at its
commit/rollback boundaries and published through the process-wide
``CommitHook`` this module owns.

Each record carries the block's whole trip through the two-stage
pipeline: slot, root, fork, stage-A apply seconds (with the span-derived
phase split when the span recorder is live), queue wait, the flush
window it rode (seq + membership — which blocks shared the RLC
multi-pairing), the window's verify seconds and settle wall time, the
outcome (``committed`` / ``rolled-back`` with structured blame /
``degraded-inline`` / ``retried-N`` / ``discarded``), and — when the
scenario harness drove a storm — the measured recovery latency.

The hook is also the live-event bus: the reference's introspection
server (``telemetry/server.py``, not yet in the port) subscribes the same
``head`` / ``commit`` / ``rollback`` / ``broken`` events onto SSE
streams, and its serving layer the state channel.

Cost discipline: the engine guards every assembly site with one read of
``HOOK.active`` (a plain bool — no call, no lock), so a pipeline with
neither the recorder nor a server attached pays nothing measurable (the
same contract as the disabled-span fast path).

Lock discipline: every write to shared structures
holds the owner's ``_lock``; ``HOOK.active`` and subscriber fan-out read
an immutable tuple snapshot lock-free. No lock is ever held while
calling out (subscriber callbacks run outside the hook lock), so the
lockorder analyzer sees no cross-module edges.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

__all__ = [
    "BlockLineage",
    "CommitHook",
    "FlightRecorder",
    "HOOK",
    "RECORDER",
    "DEFAULT_CAPACITY",
    "LATENCY_FIELDS",
    "start",
    "stop",
    "is_recording",
    "read_jsonl",
]

DEFAULT_CAPACITY = 1 << 12

# the queryable latency axes of a lineage record (worst-N API + docs)
LATENCY_FIELDS = (
    "stage_a_s",
    "queue_wait_s",
    "verify_s",
    "settle_s",
    "total_s",
    "recovery_s",
)

_OUTCOMES = ("committed", "rolled-back", "discarded")


class BlockLineage:
    """One block's trip through the pipeline, flattened to plain values
    (JSON-ready via ``to_dict``). Latency decomposition on the success
    path: ``stage_a_s`` (speculative application on the submitting
    thread) + ``queue_wait_s`` (applied → window dispatch) +
    ``settle_s`` (dispatch → verdicts in hand) ≈ ``total_s`` (submit →
    disposition); ``verify_s`` is the window's stage-B busy seconds and
    overlaps later blocks' stage A — it is membership-shared, not
    additive."""

    __slots__ = (
        "slot",
        "root",
        "block_root",
        "fork",
        "outcome",
        "stage_a_s",
        "phases",
        "queue_wait_s",
        "flush_seq",
        "flush_slots",
        "flush_sets",
        "verify_s",
        "verify_route",
        "settle_s",
        "total_s",
        "retries",
        "degraded",
        "blame",
        "recovery_s",
        "trace_id",
        "finished_at",
    )

    def __init__(
        self,
        slot: int,
        root: str,
        block_root: "str | None" = None,
        fork: "str | None" = None,
        outcome: str = "committed",
        stage_a_s: "float | None" = None,
        phases: "dict | None" = None,
        queue_wait_s: float = 0.0,
        flush_seq: "int | None" = None,
        flush_slots: tuple = (),
        flush_sets: int = 0,
        verify_s: "float | None" = None,
        verify_route: "str | None" = None,
        settle_s: "float | None" = None,
        total_s: "float | None" = None,
        retries: int = 0,
        degraded: bool = False,
        blame: "dict | None" = None,
        recovery_s: "float | None" = None,
        trace_id: "int | None" = None,
        finished_at: "float | None" = None,
    ):
        if outcome not in _OUTCOMES:
            raise ValueError(f"unknown outcome {outcome!r}")
        self.slot = slot
        self.root = root
        self.block_root = block_root
        self.fork = fork
        self.outcome = outcome
        self.stage_a_s = stage_a_s
        self.phases = phases
        self.queue_wait_s = queue_wait_s
        self.flush_seq = flush_seq
        self.flush_slots = tuple(flush_slots)
        self.flush_sets = flush_sets
        self.verify_s = verify_s
        # which pairing route proved this block's flush window:
        # "device" / "host" / None (no RLC batch ran — empty flush or
        # per-set fallback) — the device observatory's lineage hook
        self.verify_route = verify_route
        self.settle_s = settle_s
        self.total_s = total_s
        self.retries = retries
        self.degraded = degraded
        self.blame = blame
        self.recovery_s = recovery_s
        # the causal trace this block's flush window recorded under
        # (telemetry/spans.py TraceContext), None when tracing was off
        self.trace_id = trace_id
        self.finished_at = time.time() if finished_at is None else finished_at

    @property
    def committed(self) -> bool:
        return self.outcome == "committed"

    @property
    def disposition(self) -> str:
        """The disposition taxonomy: ``committed`` / ``rolled-back`` /
        ``degraded-inline`` (committed, but verified on the host thread
        instead of the overlapped worker) / ``retried-N`` (committed
        after N transient-fault re-dispatches) / ``discarded``
        (speculative work abandoned by someone else's failure)."""
        if self.outcome != "committed":
            return self.outcome
        if self.degraded:
            return "degraded-inline"
        if self.retries:
            return f"retried-{self.retries}"
        return "committed"

    def to_dict(self) -> dict:
        d = {name: getattr(self, name) for name in self.__slots__}
        d["flush_slots"] = list(self.flush_slots)
        d["disposition"] = self.disposition
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "BlockLineage":
        kwargs = {name: d[name] for name in cls.__slots__ if name in d}
        kwargs["flush_slots"] = tuple(kwargs.get("flush_slots", ()))
        return cls(**kwargs)

    def __repr__(self) -> str:
        return (
            f"BlockLineage(slot={self.slot}, {self.disposition}, "
            f"flush_seq={self.flush_seq}, total_s={self.total_s})"
        )


class CommitHook:
    """Pub/sub fan-out for pipeline lifecycle events.

    ``emit(kind, payload)`` calls every subscriber with the event; kinds
    in flight today: ``block`` (payload: ``BlockLineage``), ``head`` /
    ``commit`` / ``rollback`` / ``broken`` (payload: JSON-ready dict).

    ``active`` is the engine's zero-overhead guard: a plain bool that is
    True exactly while at least one subscriber is attached — the hot
    path reads it without a call or a lock. Subscribers must never
    raise into the pipeline; a raising subscriber is dropped from the
    fan-out for the event and counted (``flight.hook_errors``).

    The STATE channel (``subscribe_states``/``emit_state``) is the
    serving data plane's feed and deliberately separate from the event
    channel: its payloads carry live state handles (a committed
    ``BeaconState`` copy — not JSON-ready, never put on an SSE wire),
    and its guard ``state_active`` gates an O(registry) state copy per
    flush window in the engine, a cost only a mounted ``HeadStore``
    should ever switch on. Same contracts otherwise: lock-free tuple
    snapshot fan-out, subscribers never raise into the pipeline."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: tuple = ()
        self._state_subs: tuple = ()
        self.active = False
        self.state_active = False

    def subscribe(self, fn) -> None:
        with self._lock:
            if fn not in self._subs:
                self._subs = self._subs + (fn,)
            self.active = True

    def unsubscribe(self, fn) -> None:
        # equality, not identity: a bound method (RECORDER.handle) is a
        # fresh object per attribute access, but compares equal
        with self._lock:
            self._subs = tuple(s for s in self._subs if s != fn)
            self.active = bool(self._subs)

    def subscribe_states(self, fn) -> None:
        with self._lock:
            if fn not in self._state_subs:
                self._state_subs = self._state_subs + (fn,)
            self.state_active = True

    def unsubscribe_states(self, fn) -> None:
        with self._lock:
            self._state_subs = tuple(s for s in self._state_subs if s != fn)
            self.state_active = bool(self._state_subs)

    def emit(self, kind: str, payload) -> None:
        for fn in self._subs:  # tuple snapshot: safe without the lock
            try:
                fn(kind, payload)
            except Exception:  # noqa: BLE001 — never break the pipeline
                from . import metrics as _metrics

                _metrics.counter("flight.hook_errors").inc()

    def emit_state(self, payload: dict) -> None:
        """Fan a committed-state snapshot out to the data plane:
        ``payload`` carries ``state`` (an immutable-by-convention copy),
        ``context``, ``slot``, ``root`` (hex), ``seq``."""
        for fn in self._state_subs:  # tuple snapshot, same as emit
            try:
                fn(payload)
            except Exception:  # noqa: BLE001 — never break the pipeline
                from . import metrics as _metrics

                _metrics.counter("flight.hook_errors").inc()


class FlightRecorder:
    """Bounded ring journal of ``BlockLineage`` records with a small
    query API and JSONL export. Subscribe it to ``HOOK`` (via
    ``flight.start()``) to record a live pipeline."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=capacity)
        self._last_broken: "dict | None" = None

    # -- hook subscriber -----------------------------------------------------
    def handle(self, kind: str, payload) -> None:
        if kind == "block":
            dropped = False
            with self._lock:
                if len(self._records) == self._records.maxlen:
                    dropped = True  # ring full: oldest lineage evicted
                self._records.append(payload)
            if dropped:
                from . import metrics as _metrics

                _metrics.counter("flight.ring_dropped").inc()
        elif kind == "broken":
            with self._lock:
                self._last_broken = dict(payload)

    # -- recording control ---------------------------------------------------
    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._last_broken = None

    def resize(self, capacity: int) -> None:
        with self._lock:
            self._records = deque(self._records, maxlen=capacity)

    @property
    def capacity(self) -> int:
        return self._records.maxlen

    @property
    def last_broken(self) -> "dict | None":
        """Attribution of the newest ``PipelineBrokenError`` observed
        (stuck window seq + slots), or None — the /healthz detail."""
        return self._last_broken

    def __len__(self) -> int:
        return len(self._records)

    # -- query API -----------------------------------------------------------
    def records(self) -> "list[BlockLineage]":
        """Every retained record, oldest first (consistent copy)."""
        with self._lock:
            return list(self._records)

    def by_slot_range(self, lo: int, hi: int) -> "list[BlockLineage]":
        """Records with ``lo <= slot <= hi``, oldest first."""
        return [r for r in self.records() if lo <= r.slot <= hi]

    def by_outcome(self, outcome: str) -> "list[BlockLineage]":
        """Records whose ``outcome`` OR derived ``disposition`` matches
        (so both ``committed`` and ``degraded-inline`` are queryable)."""
        return [
            r
            for r in self.records()
            if r.outcome == outcome or r.disposition == outcome
        ]

    def for_slot(self, slot: int) -> "list[BlockLineage]":
        return [r for r in self.records() if r.slot == slot]

    def by_trace(self, trace_id: int) -> "list[BlockLineage]":
        """Records settled under the causal trace ``trace_id`` (the
        ``/trace`` endpoint's lineage join), oldest first."""
        return [r for r in self.records() if r.trace_id == trace_id]

    def worst(self, n: int = 5, field: str = "total_s") -> "list[BlockLineage]":
        """The ``n`` records with the largest ``field`` (any
        ``LATENCY_FIELDS`` axis), descending; records without the field
        populated sort last and are excluded."""
        if field not in LATENCY_FIELDS:
            raise ValueError(
                f"unknown latency field {field!r} (one of {LATENCY_FIELDS})"
            )
        populated = [
            r for r in self.records() if getattr(r, field) is not None
        ]
        populated.sort(key=lambda r: getattr(r, field), reverse=True)
        return populated[:n]

    # -- annotation ----------------------------------------------------------
    def annotate_recovery(self, slot: int, seconds: float) -> bool:
        """Stamp the measured rollback-recovery latency onto the NEWEST
        non-committed record for ``slot`` (the scenario harness measures
        recovery outside the engine — error caught → fresh pipeline
        ready — so it back-fills the record the rollback emitted).
        Returns whether a record was found."""
        with self._lock:
            for rec in reversed(self._records):
                if rec.slot == slot and rec.outcome != "committed":
                    rec.recovery_s = seconds
                    return True
        return False

    # -- JSONL ---------------------------------------------------------------
    def write_jsonl(self, path: str) -> int:
        """One JSON object per line, oldest first; returns the record
        count written."""
        records = self.records()
        with open(path, "w", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec.to_dict(), sort_keys=True))
                f.write("\n")
        return len(records)


def read_jsonl(path: str) -> "list[BlockLineage]":
    """Load a ``write_jsonl`` export back into records."""
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(BlockLineage.from_dict(json.loads(line)))
    return out


# -- the process-wide instances ----------------------------------------------

HOOK = CommitHook()
RECORDER = FlightRecorder()


def start(capacity: "int | None" = None) -> FlightRecorder:
    """Begin a fresh flight recording: clear the ring (resizing it if
    asked) and subscribe the process-wide recorder to the commit hook.
    Idempotent."""
    RECORDER.clear()
    if capacity is not None and capacity != RECORDER.capacity:
        RECORDER.resize(capacity)
    HOOK.subscribe(RECORDER.handle)
    return RECORDER


def stop() -> None:
    """Detach the recorder from the hook (records stay readable)."""
    HOOK.unsubscribe(RECORDER.handle)


def is_recording() -> bool:
    return HOOK.active
