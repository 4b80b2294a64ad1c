"""Structured span recorder: thread-aware ring buffer + Chrome-trace export.

The tracing facade (``utils/trace.py``) stays the only API call sites
use; this module is the recording sink behind it. When recording is off
(the default) the facade never calls in here beyond one attribute read
of ``enabled``, so a disabled span costs one bool read.

When recording is on, every ``trace.span`` exit appends one fixed-size
record — name, thread lane, parent span, start/end ``perf_counter``
stamps, the call site's fields, the error repr if the body raised — into
a bounded ``deque`` (oldest spans drop first; spans in progress live
only on a per-thread stack). ``chrome_trace()`` renders the buffer as
Chrome trace-event JSON (the ``{"traceEvents": [...]}`` flavor), loadable
in Perfetto / ``chrome://tracing``: each recording thread becomes one
``tid`` lane with its Python thread name as metadata, spans are ``"X"``
complete events in microseconds, point events are ``"i"`` instants.

Thread lanes are small sequential ints (0 = first thread to record, in
practice the main thread) rather than raw ``threading.get_ident()``
values, so the Perfetto track list stays readable; the real ident is
kept in the thread-name metadata.

Besides thread lanes there are **named virtual lanes** (``named_lane``):
tid tracks that belong to no Python thread. The device observatory
(``telemetry/device.py``) renders kernel-library loads, kernel launches
and host<->device copies on a ``device`` track, and the memory
observatory (``telemetry/memory.py``) its copies and phase marks on a
``memory`` track, through ``add_complete``/``add_instant`` (pre-timed
records appended without touching any thread's span stack).

Lock discipline: every write to the recorder's shared structures holds
``self._lock``; the hot ``enabled`` read and the per-thread span stack
(``threading.local``) stay lock-free.

**Causal trace plane.** Spans only parent within a thread (the TLS
stack). A ``TraceContext`` is the explicit handoff token across threads:
``SpanRecorder.context()`` captures the current span as ``(trace_id,
span_id, lane, ts)``, the receiving thread brackets its work in
``adopt(ctx)``, and every top-of-stack span begun under an adopted
context parents to ``ctx.span_id`` and inherits ``ctx.trace_id``. A span
with no parent and no adopted context roots its own trace (``trace_id ==
span_id``). Cross-lane adoptions record a flow source, rendered by
``chrome_trace()`` as Chrome flow events (``ph:"s"``/``"f"``). The ring
drops its oldest records when full, and counts them: ``dropped`` and the
``spans.dropped`` counter. Completed traces noted via ``note_trace``
feed a bounded worst-N slow-trace ring.

Reference parity: ethereum_consensus_tpu/telemetry/spans.py, whole.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

__all__ = [
    "SpanRecord",
    "SpanRecorder",
    "TraceContext",
    "RECORDER",
    "DEFAULT_CAPACITY",
    "SLOW_TRACE_RING",
    "is_recording",
    "start_recording",
    "stop_recording",
    "recording",
    "write_chrome_trace",
]

DEFAULT_CAPACITY = 1 << 16

# worst-N slow-trace ring size (completed traces, by duration)
SLOW_TRACE_RING = 32


class TraceContext:
    """Immutable cross-thread handoff token: ``trace_id`` names the
    causal tree, ``span_id`` the parent span the receiving side should
    link under, ``lane``/``ts`` the handoff origin (the flow-arrow
    source in the Chrome trace). Captured with ``context()`` on the
    sending thread, passed explicitly (a ticket field, a closure arg —
    never ambient), adopted with ``adopt(ctx)`` on the receiving
    thread."""

    __slots__ = ("trace_id", "span_id", "lane", "ts")

    def __init__(self, trace_id: int, span_id: int, lane: int, ts: float):
        self.trace_id = trace_id
        self.span_id = span_id
        self.lane = lane
        self.ts = ts

    def __repr__(self) -> str:
        return (
            f"TraceContext(trace={self.trace_id}, span={self.span_id}, "
            f"lane={self.lane})"
        )


class SpanRecord:
    """One completed span (or, transiently, one in progress on its
    thread's stack). ``parent_id`` is 0 for top-level spans; parents are
    resolved per thread at begin time, so cross-thread work (the
    verifier) starts its own tree."""

    __slots__ = (
        "span_id",
        "parent_id",
        "trace_id",
        "name",
        "lane",
        "t0",
        "t1",
        "fields",
        "error",
        "flow_src",
    )

    def __init__(self, span_id: int, parent_id: int, name: str, lane: int,
                 t0: float, fields: dict, trace_id: int = 0):
        self.span_id = span_id
        self.parent_id = parent_id
        # the causal tree this span belongs to: its own span_id when it
        # roots a fresh trace, the adopted/inherited trace_id otherwise
        self.trace_id = trace_id or span_id
        self.name = name
        self.lane = lane
        self.t0 = t0
        self.t1 = t0
        self.fields = fields
        self.error = None
        # (src_span_id, src_lane, src_ts) when this span was begun under
        # a context adopted from another lane — the flow-arrow source
        self.flow_src = None

    @property
    def duration_s(self) -> float:
        return max(0.0, self.t1 - self.t0)


class _EventRecord:
    __slots__ = ("name", "lane", "ts", "fields")

    def __init__(self, name: str, lane: int, ts: float, fields: dict):
        self.name = name
        self.lane = lane
        self.ts = ts
        self.fields = fields


def _json_safe(value):
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    return str(value)


class SpanRecorder:
    """In-process ring-buffer recorder; one module-level instance
    (``RECORDER``) serves the whole process."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._spans: deque = deque(maxlen=capacity)
        self._events: deque = deque(maxlen=capacity)
        self._lanes: dict = {}        # thread ident -> small lane int
        self._lane_names: dict = {}   # lane int -> thread name
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._t0 = 0.0                # perf_counter origin of the recording
        self._wall0 = 0.0             # wall-clock at start (metadata only)
        self._slow: list = []         # worst-N completed traces, ascending
        self.dropped = 0              # ring evictions (spans + events)
        self.enabled = False

    # -- lifecycle -----------------------------------------------------------
    def start(self, capacity: "int | None" = None) -> None:
        """Begin a fresh recording (drops any previous buffer)."""
        with self._lock:
            if capacity is not None and capacity != self._capacity:
                self._capacity = capacity
                self._spans = deque(maxlen=capacity)
                self._events = deque(maxlen=capacity)
            else:
                self._spans.clear()
                self._events.clear()
            self._lanes.clear()
            self._lane_names.clear()
            self._slow = []
            self.dropped = 0
            self._t0 = time.perf_counter()
            self._wall0 = time.time()
            self.enabled = True

    def stop(self) -> None:
        with self._lock:
            self.enabled = False

    # -- recording (called from the trace facade) ---------------------------
    def _lane(self) -> int:
        ident = threading.get_ident()
        lane = self._lanes.get(ident)
        if lane is None:
            with self._lock:
                lane = self._lanes.get(ident)
                if lane is None:
                    lane = len(self._lanes)
                    self._lanes[ident] = lane
                    self._lane_names[lane] = (
                        f"{threading.current_thread().name} ({ident})"
                    )
        return lane

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def begin(self, name: str, fields: dict) -> SpanRecord:
        stack = self._stack()
        lane = self._lane()
        flow_src = None
        if stack:
            # in-thread nesting wins: parent is the enclosing span
            parent_id = stack[-1].span_id
            trace_id = stack[-1].trace_id
        else:
            ctx = getattr(self._tls, "adopted", None)
            if ctx is not None:
                # cross-seam handoff: link under the sender's span
                parent_id = ctx.span_id
                trace_id = ctx.trace_id
                if ctx.lane != lane:
                    flow_src = (ctx.span_id, ctx.lane, ctx.ts)
            else:
                parent_id = 0
                trace_id = 0  # self-rooted: SpanRecord uses its span_id
        rec = SpanRecord(
            span_id=next(self._ids),
            parent_id=parent_id,
            name=name,
            lane=lane,
            t0=time.perf_counter(),
            fields=fields,
            trace_id=trace_id,
        )
        rec.flow_src = flow_src
        stack.append(rec)
        return rec

    def end(self, rec: SpanRecord, error: "str | None" = None) -> None:
        rec.t1 = time.perf_counter()
        rec.error = error
        stack = self._stack()
        # the facade pairs begin/end via try/finally, so rec is the top;
        # remove by identity anyway in case a caller misnests
        if stack and stack[-1] is rec:
            stack.pop()
        else:  # pragma: no cover - defensive
            try:
                stack.remove(rec)
            except ValueError:
                pass
        self._append_span(rec)

    def _append_span(self, rec: SpanRecord) -> None:
        dropped = False
        with self._lock:
            if len(self._spans) == self._capacity:
                self.dropped += 1
                dropped = True
            self._spans.append(rec)
        if dropped:
            from . import metrics as _metrics

            _metrics.counter("spans.dropped").inc()

    def event(self, name: str, fields: dict) -> None:
        rec = _EventRecord(name, self._lane(), time.perf_counter(), fields)
        self._append_event(rec)

    def _append_event(self, rec: _EventRecord) -> None:
        dropped = False
        with self._lock:
            if len(self._events) == self._capacity:
                self.dropped += 1
                dropped = True
            self._events.append(rec)
        if dropped:
            from . import metrics as _metrics

            _metrics.counter("spans.dropped").inc()

    # -- causal trace plane --------------------------------------------------
    def context(self) -> "TraceContext | None":
        """The current causal position as a handoff token: the top of
        this thread's span stack if one is open (the common case — call
        inside the span that should parent the downstream work), else
        the context this thread itself adopted, else None."""
        stack = getattr(self._tls, "stack", None)
        if stack:
            top = stack[-1]
            return TraceContext(
                top.trace_id, top.span_id, top.lane, time.perf_counter()
            )
        return getattr(self._tls, "adopted", None)

    @contextmanager
    def adopt(self, ctx: "TraceContext | None"):
        """Bracket the receiving side of a handoff: top-of-stack spans
        begun inside the block parent to ``ctx.span_id`` and inherit its
        trace. Nests (the previous adoption is restored on exit); TLS
        only, so it is lock-free."""
        prev = getattr(self._tls, "adopted", None)
        self._tls.adopted = ctx
        try:
            yield ctx
        finally:
            self._tls.adopted = prev

    def note_trace(self, trace_id: int, name: str, duration_s: float,
                   fields: "dict | None" = None) -> None:
        """Feed the worst-N slow-trace ring: called once per completed
        trace (a caller that hands work across threads notes each
        settled unit) with its end-to-end duration."""
        entry = {
            "trace_id": trace_id,
            "name": name,
            "duration_s": duration_s,
        }
        if fields:
            entry.update({k: _json_safe(v) for k, v in fields.items()})
        with self._lock:
            slow = self._slow
            if len(slow) < SLOW_TRACE_RING:
                slow.append(entry)
                slow.sort(key=lambda e: e["duration_s"])
            elif duration_s > slow[0]["duration_s"]:
                slow[0] = entry
                slow.sort(key=lambda e: e["duration_s"])

    def slow_traces(self) -> "list[dict]":
        """The worst-N completed traces, slowest first (consistent
        copy)."""
        with self._lock:
            return [dict(e) for e in reversed(self._slow)]

    def trace_records(self, trace_id: int) -> "list[SpanRecord]":
        """Completed spans belonging to ``trace_id`` (consistent copy,
        sorted by start time)."""
        with self._lock:
            spans = [r for r in self._spans if r.trace_id == trace_id]
        spans.sort(key=lambda r: r.t0)
        return spans

    def trace_tree(self, trace_id: int) -> dict:
        """One trace assembled as a JSON-ready causal tree: its spans
        (start-ordered), root/orphan accounting, and the wall window it
        covered. ``connected`` is the gate the tests and the ``/trace``
        endpoint assert: at least one span, exactly one root, zero
        orphans (an orphan parents to a span id absent from the
        trace)."""
        spans = self.trace_records(trace_id)
        ids = {r.span_id for r in spans}
        roots = sum(1 for r in spans if r.parent_id == 0)
        orphans = sum(
            1 for r in spans if r.parent_id and r.parent_id not in ids
        )
        t0 = self._t0
        out_spans = []
        for rec in spans:
            d = {
                "span_id": rec.span_id,
                "parent_id": rec.parent_id,
                "name": rec.name,
                "lane": rec.lane,
                "t0_s": max(0.0, rec.t0 - t0),
                "duration_s": rec.duration_s,
                "fields": {k: _json_safe(v) for k, v in rec.fields.items()},
            }
            if rec.error is not None:
                d["error"] = rec.error
            if rec.flow_src is not None:
                d["flow_from"] = {
                    "span_id": rec.flow_src[0],
                    "lane": rec.flow_src[1],
                }
            out_spans.append(d)
        return {
            "trace_id": trace_id,
            "spans": out_spans,
            "span_count": len(spans),
            "roots": roots,
            "orphans": orphans,
            "connected": bool(spans) and roots == 1 and orphans == 0,
            "t0_s": out_spans[0]["t0_s"] if out_spans else None,
            "duration_s": (
                max(r.t1 for r in spans) - min(r.t0 for r in spans)
                if spans
                else None
            ),
            "lanes": sorted({r.lane for r in spans}),
        }

    def audit(self) -> dict:
        """Whole-buffer trace health (a recorded run's evidence block):
        distinct traces, spans that parent to an id absent from the
        buffer (orphans), and ring evictions."""
        with self._lock:
            spans = list(self._spans)
            dropped = self.dropped
        ids = {r.span_id for r in spans}
        orphans = sum(
            1 for r in spans if r.parent_id and r.parent_id not in ids
        )
        return {
            "spans": len(spans),
            "traces": len({r.trace_id for r in spans}),
            "orphans": orphans,
            "dropped": dropped,
        }

    # -- named virtual lanes (non-thread tid tracks) -------------------------
    def named_lane(self, name: str) -> int:
        """The lane int for the virtual track ``name`` (allocated on
        first use). Virtual lanes share the tid namespace with thread
        lanes but belong to no thread — the device observatory's
        ``device`` track."""
        key = ("virtual", name)
        lane = self._lanes.get(key)
        if lane is None:
            with self._lock:
                lane = self._lanes.get(key)
                if lane is None:
                    lane = len(self._lanes)
                    self._lanes[key] = lane
                    self._lane_names[lane] = name
        return lane

    def add_complete(self, name: str, t0: float, t1: float, fields: dict,
                     lane: "int | None" = None) -> SpanRecord:
        """Append a pre-timed completed span (``perf_counter`` stamps)
        without touching any thread's span stack — the virtual-lane
        writer's API."""
        rec = SpanRecord(
            span_id=next(self._ids),
            parent_id=0,
            name=name,
            lane=self._lane() if lane is None else lane,
            t0=t0,
            fields=fields,
        )
        rec.t1 = t1
        self._append_span(rec)
        return rec

    def add_instant(self, name: str, ts: float, fields: dict,
                    lane: "int | None" = None) -> None:
        """Append a pre-timed instant event, optionally on a virtual
        lane."""
        rec = _EventRecord(
            name, self._lane() if lane is None else lane, ts, fields
        )
        self._append_event(rec)

    # -- reading -------------------------------------------------------------
    @property
    def origin(self) -> float:
        """``perf_counter`` stamp of the recording start — the zero
        point of every relative ``t0_s`` this recorder emits
        (``trace_tree``, ``chrome_trace``). Readers holding absolute
        ``perf_counter`` stamps (``records()``/``event_records()``)
        rebase with ``t - origin`` before comparing against them."""
        return self._t0

    def records(self) -> "list[SpanRecord]":
        """Completed spans, consistent copy (any order; sort by ``t0``)."""
        with self._lock:
            return list(self._spans)

    def event_records(self) -> "list[_EventRecord]":
        """Instant events (the ``event``/``add_instant`` ring),
        consistent copy (any order; sort by ``ts``)."""
        with self._lock:
            return list(self._events)

    def mark(self) -> int:
        """A watermark for ``records_since``: consumes one span id, so
        every span begun after the mark has ``span_id > mark``. Cheap
        (no lock) — a per-block phase-split probe."""
        return next(self._ids)

    def records_since(self, mark: int) -> "list[SpanRecord]":
        """Completed spans begun after ``mark`` (consistent copy)."""
        with self._lock:
            return [r for r in self._spans if r.span_id > mark]

    def chrome_trace(self) -> dict:
        """The buffer as a Chrome trace-event JSON document
        (Perfetto / ``chrome://tracing`` loadable). Timestamps are
        microseconds relative to the recording start, strictly
        non-negative and monotonic per the ``perf_counter`` clock."""
        with self._lock:
            spans = sorted(self._spans, key=lambda r: r.t0)
            events = sorted(self._events, key=lambda r: r.ts)
            lane_names = dict(self._lane_names)
            t0 = self._t0
            wall0 = self._wall0
        pid = os.getpid()
        out = [
            {
                "ph": "M",
                "pid": pid,
                "name": "process_name",
                "args": {"name": "ethereum_consensus_tpu_torch"},
            }
        ]
        for lane in sorted(lane_names):
            out.append(
                {
                    "ph": "M",
                    "pid": pid,
                    "tid": lane,
                    "name": "thread_name",
                    "args": {"name": lane_names[lane]},
                }
            )
        for rec in spans:
            args = {k: _json_safe(v) for k, v in rec.fields.items()}
            args["span_id"] = rec.span_id
            args["trace_id"] = rec.trace_id
            if rec.parent_id:
                args["parent_id"] = rec.parent_id
            if rec.error is not None:
                args["error"] = rec.error
            out.append(
                {
                    "ph": "X",
                    "pid": pid,
                    "tid": rec.lane,
                    "name": rec.name,
                    "cat": rec.name.split(".", 1)[0],
                    "ts": max(0.0, (rec.t0 - t0) * 1e6),
                    "dur": max(0.0, (rec.t1 - rec.t0) * 1e6),
                    "args": args,
                }
            )
            if rec.flow_src is not None:
                # cross-lane handoff: a flow-start at the sender's
                # capture point, a binding flow-finish at this span's
                # start — Perfetto draws the arrow between tid lanes
                src_span, src_lane, src_ts = rec.flow_src
                flow = {
                    "pid": pid,
                    "name": "trace.flow",
                    "cat": "flow",
                    "id": rec.span_id,
                }
                out.append(
                    dict(
                        flow,
                        ph="s",
                        tid=src_lane,
                        ts=max(0.0, (src_ts - t0) * 1e6),
                        args={"from_span": src_span},
                    )
                )
                out.append(
                    dict(
                        flow,
                        ph="f",
                        bp="e",
                        tid=rec.lane,
                        ts=max(0.0, (rec.t0 - t0) * 1e6),
                        args={"to_span": rec.span_id},
                    )
                )
        for rec in events:
            out.append(
                {
                    "ph": "i",
                    "s": "t",
                    "pid": pid,
                    "tid": rec.lane,
                    "name": rec.name,
                    "cat": rec.name.split(".", 1)[0],
                    "ts": max(0.0, (rec.ts - t0) * 1e6),
                    "args": {k: _json_safe(v) for k, v in rec.fields.items()},
                }
            )
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"recordingStartUnixTime": wall0},
        }


RECORDER = SpanRecorder()


def is_recording() -> bool:
    return RECORDER.enabled


def start_recording(capacity: "int | None" = None) -> None:
    RECORDER.start(capacity)


def stop_recording() -> None:
    RECORDER.stop()


@contextmanager
def recording(capacity: "int | None" = None):
    """Record spans for the duration of the block; yields ``RECORDER``."""
    RECORDER.start(capacity)
    try:
        yield RECORDER
    finally:
        RECORDER.stop()


def write_chrome_trace(path: str) -> None:
    """Serialize the current buffer as Chrome trace JSON at ``path``."""
    doc = RECORDER.chrome_trace()
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
