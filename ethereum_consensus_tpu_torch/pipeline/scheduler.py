"""Stage-B scheduling: bounded async dispatch of coalesced flushes.

The scheduler owns the pipeline's work queue discipline — and nothing
else. It knows signature batches and futures; it does NOT know states,
forks, or rollback (engine.py's job). Three rules:

* **Coalesce**: one dispatched window carries the merged signature sets
  of up to ``FlushPolicy.window_size`` consecutive blocks; the verifier
  proves them in ONE random-linear-combination multi-pairing (N+K Miller
  loops, one shared final exponentiation) via
  ``crypto.bls.verify_signature_sets`` — which itself routes to the
  native IFMA engine or, above the ``ops`` pairing threshold, the
  device/mesh pairing kernels.
* **Bound**: at most ``FlushPolicy.max_in_flight`` windows may be queued
  or running at once. ``dispatch`` on a full scheduler is a programming
  error (the engine settles the oldest window first — that blocking wait
  IS the backpressure, so an unbounded block stream cannot pile
  unverified speculative state in memory).
* **Order**: windows settle strictly FIFO (the verifier pool is a single
  worker), so chain order and commit order agree by construction.

Hardening (the scenario harness's fault targets, docs/SCENARIOS.md):
every settle is TIMEOUT-BOUNDED (``FlushPolicy.settle_timeout_s``; a
wedged worker raises ``PipelineBrokenError`` carrying the stuck window's
attribution instead of deadlocking the submitter), a
``TransientFlushError`` from the worker is retried with bounded backoff
(``flush_retries`` × ``retry_backoff_s``), and a worker death degrades
THAT window to in-line verification on the submitting thread — the
verdicts stay exact, only the overlap is lost. Every path is counted
(``pipeline.fault.*``, ``pipeline.degraded_flushes``) and the
process-wide ``pipeline.degraded`` gauge latches once any window
degraded.

Reference parity: ethereum_consensus_tpu/pipeline/scheduler.py, with one
divergence. The reference degrades a window on ANY exception from the
verifier future (``except (WorkerKilled, Exception)``). In the port a
device kernel that fails to build or launch raises out of
``crypto.bls`` on the verifier's thread, and degrading would hide it
behind a counted worker death. Here only ``WorkerKilled`` (and exhausted
``TransientFlushError`` retries) degrade; any other exception — from the
future or from an in-line re-verification — raises
``PipelineBrokenError`` chained from it, and the engine restores the
last committed state first. The in-line re-verification goes through
the same ``verify_signature_sets`` routing as the worker (the routing is
process-wide: ``ops.install``), so a device window is re-verified on the
device, never on the host.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import TimeoutError as _FutureTimeout

from .. import _env
from ..crypto import bls
from ..telemetry import metrics as _metrics
from ..utils import trace
from .errors import PipelineBrokenError, TransientFlushError, WorkerKilled
from .stats import PipelineStats

__all__ = ["FlushPolicy", "VerifyScheduler", "Window", "auto_verify_lanes"]

# verifier-lane auto-sizing cap: each lane is one persistent
# single-thread pool (crypto/bls._verify_pool), so an unbounded core
# count must not spawn an unbounded worker census
_AUTO_LANES_CAP = 8


def auto_verify_lanes() -> int:
    """The lane count an unset ``FlushPolicy(verify_lanes=...)``
    resolves to: ``min(cpu_cores, mesh devices)`` when the mesh runtime
    is switched on (``ECT_MESH`` — each mesh dispatch already owns the
    device axis, so more lanes than devices just queue), plain
    ``cpu_cores`` otherwise (one GIL-released native pairing per core),
    capped at 8 lanes and floored at 1. The consult is a plain env read
    first — a mesh-off process never provisions a mesh here."""
    cores = os.cpu_count() or 1
    lanes = cores
    # the env read duplicates runtime.requested() on purpose: the mesh-off
    # path decides without importing parallel/ (which imports torch)
    value = _env.mode("ECT_MESH")
    if value not in ("", "off", "0", "none", "host"):
        from ..parallel import runtime as _mesh_runtime

        devices = _mesh_runtime.device_count()
        if devices:
            lanes = min(cores, devices)
    return max(1, min(lanes, _AUTO_LANES_CAP))


class FlushPolicy:
    """When to cut a window and how many may be in flight.

    * ``window_size`` — blocks coalesced per flush. 1 = per-block flushes
      (sequential per-block batching, just asynchronous); larger
      windows amortize the final exponentiation and per-call overheads
      across blocks, at the cost of a coarser rollback granule.
    * ``max_in_flight`` — the bounded verify queue's cap (backpressure).
    * ``checkpoint_interval`` — every Nth dispatched window carries a
      full state snapshot for the commit bookkeeping. A snapshot is the
      only O(registry) cost the pipeline adds to the success path (the
      object-graph copy; root memos travel), so it is amortized: between
      checkpoints the committed position is represented as "newest
      checkpoint + proven blocks", and a rollback (rare, terminal)
      re-derives it by deterministic replay.
    * ``flush_empty`` — whether windows whose blocks deferred zero sets
      (Validation.DISABLED replay) still pass through the scheduler; off
      by default, they commit immediately.
    * ``settle_timeout_s`` — the bound on every settle wait: a window
      whose future hasn't resolved after this long raises
      ``PipelineBrokenError`` with the window's attribution. None
      disables the bound (NOT recommended — a wedged worker then hangs
      the submitter forever, which is exactly the failure mode this
      exists to close).
    * ``flush_retries`` — how many times a ``TransientFlushError`` from
      the worker is re-dispatched before the window degrades to in-line
      verification.
    * ``retry_backoff_s`` — base backoff before retry k (linear:
      ``k * retry_backoff_s``), bounding total stall to
      ``flush_retries * (flush_retries + 1) / 2 * retry_backoff_s``.
    * ``verify_lanes`` — how many single-thread verifier workers the
      windows fan over (``crypto.bls`` keeps one FIFO pool per lane).
      1 = the historical shared worker. With N lanes, window ``seq``
      dispatches to lane ``seq % N`` — DETERMINISTIC, so a replay hits
      the same lanes — and up to N windows verify concurrently (the
      native pairing releases the GIL, so N cores prove N windows at
      once). Settle order is untouched: the engine always settles the
      OLDEST window first and blocks on its future, so commits stay in
      chain order no matter which lane finishes first. Raise
      ``max_in_flight`` to at least ``verify_lanes`` or the backpressure
      wait will idle the extra lanes. Unset (``None``) auto-sizes from
      the machine: ``min(cpu_cores, mesh devices)`` under ``ECT_MESH``,
      ``cpu_cores`` otherwise, capped at 8 (``auto_verify_lanes`` — the
      production-soak default; a single-core box resolves to the
      historical 1).
    """

    __slots__ = (
        "window_size", "max_in_flight", "checkpoint_interval", "flush_empty",
        "settle_timeout_s", "flush_retries", "retry_backoff_s",
        "verify_lanes",
    )

    def __init__(self, window_size: int = 8, max_in_flight: int = 2,
                 checkpoint_interval: int = 8, flush_empty: bool = False,
                 settle_timeout_s: "float | None" = 300.0,
                 flush_retries: int = 2, retry_backoff_s: float = 0.05,
                 verify_lanes: "int | None" = None):
        if window_size < 1:
            raise ValueError("window_size must be >= 1")
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        if checkpoint_interval < 1:
            raise ValueError("checkpoint_interval must be >= 1")
        if settle_timeout_s is not None and settle_timeout_s <= 0:
            raise ValueError("settle_timeout_s must be positive or None")
        if flush_retries < 0:
            raise ValueError("flush_retries must be >= 0")
        if verify_lanes is None:
            verify_lanes = auto_verify_lanes()
        if verify_lanes < 1:
            raise ValueError("verify_lanes must be >= 1")
        self.window_size = window_size
        self.max_in_flight = max_in_flight
        self.checkpoint_interval = checkpoint_interval
        self.flush_empty = flush_empty
        self.settle_timeout_s = settle_timeout_s
        self.flush_retries = flush_retries
        self.retry_backoff_s = retry_backoff_s
        self.verify_lanes = verify_lanes

    def __repr__(self) -> str:
        return (
            f"FlushPolicy(window_size={self.window_size}, "
            f"max_in_flight={self.max_in_flight}, "
            f"checkpoint_interval={self.checkpoint_interval}, "
            f"settle_timeout_s={self.settle_timeout_s}, "
            f"verify_lanes={self.verify_lanes})"
        )


class Window:
    """One dispatched flush: consecutive block entries, their merged
    signature batch, and — on checkpoint-carrying windows — the
    post-window state snapshot the engine installs as the new checkpoint
    when the verdicts come back clean (``post_state`` is None
    otherwise; the committed position is then checkpoint + blocks).
    ``attempts`` counts dispatches (retries of transient faults).

    The timing stamps are the flight recorder's raw material
    (telemetry/flight.py): ``t_dispatch``/``t_settled`` bound the settle
    wall, ``verify_s`` accumulates the worker's busy seconds across
    attempts (plus any in-line re-verification), and ``degraded``
    latches when the window fell back to host verification. They are
    written by the scheduler/worker strictly BEFORE the engine reads
    them at commit/rollback (the future's result is the happens-before
    edge), so no lock is needed."""

    __slots__ = (
        "entries", "batch", "post_state", "snap_state", "future", "seq",
        "attempts", "t_dispatch", "t_settled", "verify_s", "degraded",
        "verify_route", "trace_ctx",
    )

    def __init__(self, entries, batch, post_state, seq: int):
        self.entries = entries
        self.batch = batch
        self.post_state = post_state
        # serving-layer copy of the post-window state, taken at dispatch
        # when the live state IS the post-window state; published on the
        # commit hook's state channel when the verdicts come back clean
        # (None unless a HeadStore is attached — HOOK.state_active)
        self.snap_state = None
        self.future = None
        self.seq = seq
        self.attempts = 0
        self.t_dispatch = None
        self.t_settled = None
        self.verify_s = 0.0
        self.degraded = False
        # which pairing route proved this window's batch ("device" /
        # "host" / None when no RLC batch ran) — written by the worker
        # via the verify route_sink (same happens-before edge as the
        # timer), folded into BlockLineage.verify_route
        self.verify_route = None
        # the causal trace the window's blocks recorded under (a
        # utils/trace TraceContext anchored at the window's first
        # stage-A span; None when tracing is off) — the handoff token
        # the verify lane and settle path adopt, and the trace_id the
        # SLO histograms exemplar against
        self.trace_ctx = None


class VerifyScheduler:
    """Bounded FIFO dispatch onto the shared background verifier."""

    def __init__(self, policy: FlushPolicy, stats: PipelineStats,
                 fault_injector=None):
        self.policy = policy
        self.stats = stats
        self.fault_injector = fault_injector
        self._in_flight: list[Window] = []

    # -- queue state ---------------------------------------------------------
    @property
    def in_flight(self) -> int:
        return len(self._in_flight)

    @property
    def full(self) -> bool:
        return len(self._in_flight) >= self.policy.max_in_flight

    @property
    def idle(self) -> bool:
        return not self._in_flight

    # -- dispatch / settle ---------------------------------------------------
    def _window_slots(self, window: Window) -> tuple:
        return tuple(
            e.slot for e in window.entries if getattr(e, "slot", None) is not None
        )

    def _submit(self, window: Window) -> None:
        """One verify dispatch of ``window`` (initial or retry). A failed
        SUBMIT (the pool itself is gone — interpreter shutdown, a test
        tore the pool down) degrades immediately: the overlap is
        unavailable, the verdicts must not be."""
        pre = None
        if self.fault_injector is not None:
            pre = self.fault_injector.hook_for(window.seq, window.attempts)
        window.attempts += 1
        stats = self.stats

        def timer(seconds, _w=window):
            # runs on the worker; the engine reads verify_s only after
            # the future resolves, so the write needs no lock
            stats.stage_b_busy(seconds)
            _w.verify_s += seconds

        def route_sink(route, _w=window):
            # same worker-side write discipline as the timer
            _w.verify_route = route

        try:
            window.future = bls.verify_signature_sets_async(
                window.batch.sets, timer=timer, pre=pre,
                route_sink=route_sink,
                # deterministic window→lane assignment: retries of one
                # window stay on its lane (FIFO with its successors),
                # consecutive windows round-robin over the lanes
                lane=window.seq % self.policy.verify_lanes,
                # causal handoff: the verify lane adopts the window's
                # trace, so its span parents across the thread seam
                trace_ctx=window.trace_ctx,
            )
        except RuntimeError:
            _metrics.counter("pipeline.fault.dispatch_failure").inc()
            try:
                window.future = _InlineFuture(self._verify_inline(window))
            except Exception as exc:  # noqa: BLE001 — raised at settle
                window.future = _InlineFuture(None, exc)

    def dispatch(self, window: Window) -> None:
        """Queue one window onto the verifier. The caller must have made
        room (``not full``) by settling the oldest window first."""
        if self.full:
            raise RuntimeError(
                "VerifyScheduler.dispatch on a full queue — settle the "
                "oldest window first (the engine's backpressure wait)"
            )
        n_sets = len(window.batch)
        trace.event(
            "pipeline.flush.dispatch",
            seq=window.seq,
            blocks=len(window.entries),
            sets=n_sets,
            in_flight=len(self._in_flight) + 1,
        )
        window.t_dispatch = time.perf_counter()
        self._submit(window)
        self._in_flight.append(window)
        self.stats.flush_dispatched(n_sets)
        self.stats.queue_depth(len(self._in_flight))

    def _verify_inline(self, window: Window) -> "list[bool]":
        """Graceful degradation: prove the window's sets on THIS thread
        (the same ``verify_signature_sets`` call, and so the same route,
        as the worker's). Verdicts and attribution are exactly what the
        worker would have produced; only the stage overlap is lost — which
        the latched ``pipeline.degraded`` gauge makes visible. A device
        failure here raises (settle_oldest breaks the pipeline)."""
        # the stats mutator owns the pipeline.degraded_flushes registry
        # counter; only the latched gauge is set here
        _metrics.gauge("pipeline.degraded").set(1)
        window.degraded = True
        self.stats.degraded_flush()
        trace.event(
            "pipeline.degraded", seq=window.seq, sets=len(window.batch)
        )
        t0 = time.perf_counter()
        try:
            with trace.adopt(window.trace_ctx):
                with trace.span(
                    "pipeline.flush.verify_inline", seq=window.seq
                ):
                    verdicts = bls.verify_signature_sets(window.batch.sets)
            window.verify_route = bls.last_batch_route()
            return verdicts
        finally:
            window.verify_s += time.perf_counter() - t0

    @staticmethod
    def _observe_settled(window: Window) -> None:
        """Feed the window's stage-B latencies into the process-wide SLO
        histograms (bounded reservoirs, telemetry/metrics.py) — the
        production soak's p99 gates read these directly, so they observe
        unconditionally (two reservoir inserts per WINDOW, not per
        block; noise against a multi-pairing). Under tracing each
        observation carries the window's trace_id, so the histogram's
        worst-N exemplar table can name which window was the tail; the
        settled window also feeds the slow-trace ring and counts
        ``trace.windows_linked``."""
        ctx = window.trace_ctx
        tid = ctx.trace_id if ctx is not None else None
        fields = {"seq": window.seq} if tid is not None else None
        _metrics.histogram("pipeline.verify_s").observe(
            window.verify_s, trace_id=tid, fields=fields
        )
        if window.t_dispatch is not None and window.t_settled is not None:
            _metrics.histogram("pipeline.settle_s").observe(
                max(0.0, window.t_settled - window.t_dispatch),
                trace_id=tid, fields=fields,
            )
        if tid is not None:
            _metrics.counter("trace.windows_linked").inc()
            starts = [
                e.t_start
                for e in window.entries
                if getattr(e, "t_start", None) is not None
            ]
            t_begin = min(starts) if starts else window.t_dispatch
            if window.t_settled is not None and t_begin is not None:
                trace.note_trace(
                    ctx,
                    "pipeline.window",
                    max(0.0, window.t_settled - t_begin),
                    seq=window.seq,
                    blocks=len(window.entries),
                    sets=len(window.batch),
                )

    def settle_oldest(self) -> "tuple[Window, list[bool]]":
        """Block until the oldest in-flight window's verdicts are in;
        returns (window, per-set verdicts in call-site order).

        Bounded and fault-hardened: a worker stuck past
        ``settle_timeout_s`` raises ``PipelineBrokenError`` with the
        window's attribution; a ``TransientFlushError`` re-dispatches up
        to ``flush_retries`` times with linear backoff; a worker death
        falls back to in-line verification on this thread. Any other
        exception (a device kernel that failed on the verifier's thread,
        or in the in-line re-verification) raises ``PipelineBrokenError``
        chained from it, with the window's attribution: it is never
        counted as a worker death."""
        if not self._in_flight:
            raise RuntimeError("settle_oldest with nothing in flight")
        window = self._in_flight.pop(0)
        # the settle span joins the window's causal tree: the submitting
        # thread adopts the same context the verify lane did
        with trace.adopt(window.trace_ctx), \
                trace.span("pipeline.flush.settle", seq=window.seq):
            try:
                return window, self._settle(window)
            except PipelineBrokenError:
                raise
            except Exception as exc:  # noqa: BLE001 — raised, never degraded
                _metrics.counter("pipeline.fault.verifier_error").inc()
                trace.event(
                    "pipeline.fault.verifier_error",
                    seq=window.seq,
                    error=repr(exc),
                )
                slots = self._window_slots(window)
                broken = PipelineBrokenError(
                    f"flush window {window.seq} (slots {list(slots)}, "
                    f"{len(window.batch)} sets) failed on the verifier: "
                    f"{exc!r}; the pipeline is broken, the state is at the "
                    "last committed position",
                    window_seq=window.seq,
                    slots=slots,
                )
                broken.stuck_window = window
                raise broken from exc

    def _settle(self, window: Window) -> "list[bool]":
        policy = self.policy
        while True:
            try:
                verdicts = window.future.result(
                    timeout=policy.settle_timeout_s
                )
                window.t_settled = time.perf_counter()
                self._observe_settled(window)
                return verdicts
            except (_FutureTimeout, TimeoutError):
                _metrics.counter("pipeline.fault.settle_timeout").inc()
                window.future.cancel()
                slots = self._window_slots(window)
                broken = PipelineBrokenError(
                    f"flush window {window.seq} (slots {list(slots)}, "
                    f"{len(window.batch)} sets) did not settle within "
                    f"{policy.settle_timeout_s}s — verifier wedged; "
                    "the pipeline is broken, the state is at the last "
                    "committed position",
                    window_seq=window.seq,
                    slots=slots,
                )
                # the engine emits `discarded` lineage for the stuck
                # window's blocks (it was popped off the queue here,
                # so the error is the only path that still names it)
                broken.stuck_window = window
                raise broken from None
            except TransientFlushError as exc:
                _metrics.counter("pipeline.fault.transient").inc()
                if window.attempts > policy.flush_retries:
                    # retries exhausted: the fault is persistent —
                    # degrade this window rather than fail the chain
                    trace.event(
                        "pipeline.fault.retries_exhausted",
                        seq=window.seq,
                        attempts=window.attempts,
                        error=repr(exc),
                    )
                    verdicts = self._verify_inline(window)
                    window.t_settled = time.perf_counter()
                    self._observe_settled(window)
                    return verdicts
                _metrics.counter("pipeline.fault.retries").inc()
                self.stats.fault_retry()
                backoff = window.attempts * policy.retry_backoff_s
                trace.event(
                    "pipeline.fault.retry",
                    seq=window.seq,
                    attempt=window.attempts,
                    backoff_s=backoff,
                )
                if backoff > 0:
                    time.sleep(backoff)
                self._submit(window)
            except WorkerKilled as exc:
                # worker death: NOT a verdict (structured consensus errors
                # never propagate through the future — verify returns
                # verdict lists), so the sound recovery is to re-verify
                # in-line right here
                _metrics.counter("pipeline.fault.worker_death").inc()
                trace.event(
                    "pipeline.fault.worker_death",
                    seq=window.seq,
                    error=repr(exc),
                )
                verdicts = self._verify_inline(window)
                window.t_settled = time.perf_counter()
                self._observe_settled(window)
                return verdicts

    def drop_all(self) -> "list[Window]":
        """Abandon every in-flight window (rollback path): the futures
        run to completion on the worker — the single-thread pool keeps
        FIFO order, and a later submit would queue behind them anyway —
        but their verdicts are no longer consulted. Returns the dropped
        windows (the engine emits ``discarded`` lineage for their
        speculative blocks)."""
        dropped = self._in_flight
        self._in_flight = []
        return dropped


class _InlineFuture:
    """A pre-resolved future for the dispatch-failure degradation path:
    quacks like ``concurrent.futures.Future`` for the one consumer
    (``settle_oldest``); an in-line verification that raised re-raises
    there."""

    __slots__ = ("_verdicts", "_exc")

    def __init__(self, verdicts, exc: "BaseException | None" = None):
        self._verdicts = verdicts
        self._exc = exc

    def result(self, timeout=None):
        if self._exc is not None:
            raise self._exc
        return self._verdicts

    def cancel(self) -> bool:
        return False
