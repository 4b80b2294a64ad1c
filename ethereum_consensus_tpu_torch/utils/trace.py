"""Tracing facade.

The reference pulls in the `tracing` crate as a facade in its API client
(beacon-api-client/Cargo.toml:21, examples/sse.rs:4-20); the core library
emits nothing. Here the same facade fans out to three sinks:

* the **logging sink** (stdlib ``logging``, silent unless the application
  installs a handler — ``basic_setup``);
* the **span recorder** (``telemetry/spans.py``), an in-process ring
  buffer with Chrome-trace export, active only between
  ``telemetry.spans.start_recording()``/``stop_recording()``;
* the **memory observatory's phase ledger** (``telemetry/memory.py``),
  which brackets the ``transition.*``/``epoch_vector.*`` spans while it
  observes.

When no sink is active (the default), ``span`` takes a fast path that
does no formatting, no recording and no bookkeeping beyond one
``perf_counter`` read kept for the error log: three bool reads decide it.

Usage::

    from ethereum_consensus_tpu_torch.utils.trace import span, event
    with span("apply_block", slot=block.slot):
        ...
    event("epoch_vector.fallback", reason=reason)

Reference parity: ethereum_consensus_tpu/utils/trace.py, whole.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager

from ..telemetry import memory as _memory
from ..telemetry import spans as _spans

__all__ = [
    "logger",
    "span",
    "event",
    "basic_setup",
    "TraceContext",
    "context",
    "adopt",
    "note_trace",
]

TraceContext = _spans.TraceContext

logger = logging.getLogger("ethereum_consensus_tpu_torch")
logger.addHandler(logging.NullHandler())

_RECORDER = _spans.RECORDER
_MEMORY = _memory.OBSERVATORY


def _fmt_fields(fields: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in fields.items())


@contextmanager
def span(name: str, **fields):
    """A timed span, delivered to every active sink: the logging sink
    (DEBUG on enter, INFO with elapsed ms on exit, ERROR with the
    exception if the body raises) and, while recording, the telemetry
    span recorder (thread lane, parent span, wall window, fields)."""
    if not (
        _RECORDER.enabled
        or _MEMORY.active
        or logger.isEnabledFor(logging.INFO)
    ):
        # disabled fast path: no sink wants enter/exit; keep only the
        # error log the always-on path would emit
        start = time.perf_counter()
        try:
            yield
        except Exception as exc:
            logger.error(
                "abort %s %s error=%r elapsed_ms=%.2f",
                name, _fmt_fields(fields), exc,
                (time.perf_counter() - start) * 1e3,
            )
            raise
        return
    rec = _RECORDER.begin(name, fields) if _RECORDER.enabled else None
    # the memory observatory brackets the transition/epoch phase spans
    # into its RSS ledger (telemetry/memory.py PHASE_PREFIXES); every
    # other span costs it one prefix check
    mem = _MEMORY.phase_begin(name) if _MEMORY.active else None
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug("enter %s %s", name, _fmt_fields(fields))
    start = time.perf_counter()
    try:
        yield
    except Exception as exc:
        logger.error(
            "abort %s %s error=%r elapsed_ms=%.2f",
            name, _fmt_fields(fields), exc,
            (time.perf_counter() - start) * 1e3,
        )
        if rec is not None:
            _RECORDER.end(rec, error=repr(exc))
        if mem is not None:
            _MEMORY.phase_end(name, mem)
        raise
    else:
        if logger.isEnabledFor(logging.INFO):
            logger.info(
                "exit %s %s elapsed_ms=%.2f",
                name, _fmt_fields(fields), (time.perf_counter() - start) * 1e3,
            )
        if rec is not None:
            _RECORDER.end(rec)
        if mem is not None:
            _MEMORY.phase_end(name, mem)


def event(name: str, **fields) -> None:
    """A point-in-time structured event, delivered to every active sink."""
    if _RECORDER.enabled:
        _RECORDER.event(name, fields)
    if logger.isEnabledFor(logging.INFO):
        logger.info("%s %s", name, _fmt_fields(fields))


# -- causal trace plane (telemetry/spans.py TraceContext) ---------------------

class _NullAdopt:
    """Shared no-op context manager: the ``adopt`` off path allocates
    nothing (one ``enabled`` read, one shared instance)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_ADOPT = _NullAdopt()


def context() -> "TraceContext | None":
    """Capture the current causal position as a cross-thread handoff
    token (None when recording is off — callers pass it through
    unconditionally; the off path is one attribute read)."""
    if not _RECORDER.enabled:
        return None
    return _RECORDER.context()


def adopt(ctx: "TraceContext | None"):
    """Bracket the receiving side of a handoff: top-level spans opened
    inside the block link under ``ctx`` (same trace, cross-lane flow
    arrow in the Chrome trace). With ``ctx=None`` or recording off this
    is a shared no-op context manager."""
    if ctx is None or not _RECORDER.enabled:
        return _NULL_ADOPT
    return _RECORDER.adopt(ctx)


def note_trace(ctx: "TraceContext | None", name: str, duration_s: float,
               **fields) -> None:
    """Note a completed trace into the worst-N slow-trace ring (no-op
    when ``ctx`` is None or recording is off)."""
    if ctx is not None and _RECORDER.enabled:
        _RECORDER.note_trace(ctx.trace_id, name, duration_s, fields)


_BASIC_HANDLER: "logging.Handler | None" = None
_BASIC_SETUP_LOCK = threading.Lock()


def basic_setup(level: int = logging.INFO) -> None:
    """Install a stderr handler (the tracing_subscriber equivalent,
    reference examples/sse.rs:20). Idempotent: repeated calls adjust the
    level instead of stacking duplicate handlers."""
    global _BASIC_HANDLER
    with _BASIC_SETUP_LOCK:
        if _BASIC_HANDLER is None:
            handler = logging.StreamHandler()
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
            )
            logger.addHandler(handler)
            _BASIC_HANDLER = handler
        logger.setLevel(level)
