"""ChainPipeline — the streaming block-application engine.

The one-shot ``Executor`` (executor.rs:113) applies a block and
verifies its signatures synchronously, one block at a time. Serving
heavy sync/replay traffic wants the shape every inference-serving stack
uses instead: a bounded two-stage pipeline that keeps the pairing engine
busy while the host mutates state.

Stage A (the submitting thread) runs the full state transition for each
block — slot advance, operation processing, incremental hash-tree-root,
state-root check — but with every signature claim *collected*, not
verified: the transition's per-block batch flushes into a cross-block
window (``signature_batch.defer_flushes``) instead of pairing. The state
mutation is therefore **speculative**: structurally validated, signatures
pending. Deferred registry-key parses (``PublicKey.from_validated_bytes``)
keep the G1 decompression off this stage too.

Stage B (the background verifier, ``scheduler.py``) receives windows of
up to K consecutive blocks' merged sets and proves each window in ONE
random-linear-combination multi-pairing — N+K Miller loops, one shared
final exponentiation — preceded by the eight-wide bulk decompression of
any cold keys, on the native engine (ctypes releases the GIL for the
whole call, so the overlap is real parallelism) or, above the ``ops``
pairing threshold, the device/mesh pairing route: B6 and B7 launched
from the verifier's thread on the calling thread's current stream.

Commit protocol: a full state snapshot is the only O(registry) cost the
pipeline adds to the success path, so snapshots are **checkpoints**,
taken on every ``checkpoint_interval``-th window (at dispatch, when the
live state IS the post-window state; root memos travel with the copy
(``ssz/core.py`` ``copy``), so a checkpoint costs an object-graph walk,
never a rehash). Between checkpoints the committed position is
represented as "newest checkpoint + the proven blocks since", which a
(rare, terminal) failure re-derives by deterministic replay.

Rollback: when a window's verdicts come back dirty, the verifier's
per-set fallback has already re-verified the window sequentially in
call-site order, naming the first failing set and therefore the failing
block and operation. The engine discards the speculative state, rebuilds
the committed position, re-applies the proven prefix of the failed
window (signatures already proven, so no re-pairing), and raises the
failing set's structured error — the same exception the sequential path
raises. Semantics match the sequential Executor observably: identical
final state bit-for-bit on success, the same structured error and a
coherent last-committed state on failure.

Fault hardening: every settle wait is bounded by
``FlushPolicy.settle_timeout_s`` — a wedged verifier raises
``PipelineBrokenError`` with the stuck window's attribution and the
state restored to the last committed position, never a deadlock.
Transient flush faults retry with bounded backoff; a dead worker
degrades the window to in-line verification on the worker's route
(scheduler.py). An optional ``fault_injector`` (faults.FaultInjector)
drives these paths deterministically for the scenario harness.

Reference parity: ethereum_consensus_tpu/pipeline/engine.py. Divergences:
a device failure on the verifier's thread breaks the pipeline
(``PipelineBrokenError`` chained from it, the state at the last
committed position) where the reference degrades the window
(scheduler.py); and a non-consensus exception in stage A (a device
kernel that failed under the transition) restores the committed state
and breaks the pipeline before it propagates, where the reference
leaves the partial mutation in place.
"""

from __future__ import annotations

import time

from ..error import Error
from ..models.signature_batch import SignatureBatch, defer_flushes
from ..models.transition import Validation
from ..telemetry import flight as _flight
from ..telemetry import memory as _memory
from ..telemetry import metrics as _metrics
from ..telemetry import phases as _phases
from ..telemetry import spans as _spans
from ..utils import trace
from .errors import PipelineBrokenError
from .scheduler import FlushPolicy, VerifyScheduler, Window
from .stats import PipelineStats

__all__ = ["ChainPipeline", "PipelineBrokenError"]


def _snapshot_copy(state):
    """The serving layer's publication copy, with the memory
    observatory's ``pipeline.snapshot_copy`` bandwidth accounting: the
    copy's structural list traffic is attributed per list at the
    ``ssz.state_copy`` site; this site counts the publication EVENTS
    and their wall window so a profile shows what snapshot publication
    costs beside what it moves. One bool read while off."""
    obs = _memory.OBSERVATORY
    if not obs.active:
        return state.copy()
    before = obs.copy_summary()["sites"].get("ssz.state_copy", {})
    t0 = time.perf_counter()
    snap = state.copy()
    t1 = time.perf_counter()
    after = obs.copy_summary()["sites"].get("ssz.state_copy", {})
    obs.record_copy(
        "pipeline.snapshot_copy",
        after.get("bytes", 0) - before.get("bytes", 0),
        t0,
        t1,
    )
    return snap


def _state_root_hex(signed_block) -> str:
    """The block's claimed post-state root — a free field read, so the
    lineage root costs no hashing."""
    return bytes(signed_block.message.state_root).hex()


def _block_root_hex(signed_block) -> str:
    """The block's own hash_tree_root — the BLOCK-root index the serving
    duties endpoints resolve ``dependent_root`` against. An instance-
    cache hit in practice: stage A's proposer-signature check already
    merkleized the message for its signing root."""
    message = signed_block.message
    return type(message).hash_tree_root(message).hex()


class _Entry:
    """One speculatively applied block: the block itself (kept for the
    rollback re-application), its collected signature batch, and — when
    the flight-recorder hook is active — the stage-A timing stamps the
    lineage record is assembled from (telemetry/flight.py)."""

    __slots__ = (
        "signed_block", "slot", "batch",
        "t_start", "t_applied", "stage_a_s", "fork", "phases",
    )

    def __init__(self, signed_block, slot: int, batch: SignatureBatch):
        self.signed_block = signed_block
        self.slot = slot
        self.batch = batch
        self.t_start = None
        self.t_applied = None
        self.stage_a_s = None
        self.fork = None
        self.phases = None


class ChainPipeline:
    """Streaming chain engine over an ``Executor``.

    Usage::

        pipe = ChainPipeline(executor, policy=FlushPolicy(window_size=8))
        for signed_block in blocks:
            pipe.submit(signed_block)
        stats = pipe.close()          # settles every in-flight window

    or as a context manager (``close`` on clean exit, ``abort`` — which
    restores the last committed state — when the body raises). After a
    failed block the structured error has been raised, ``executor.state``
    is the last committed state, and the pipeline is broken (further
    ``submit`` raises ``PipelineBrokenError``).
    """

    def __init__(
        self,
        executor,
        policy: FlushPolicy | None = None,
        validation: Validation = Validation.ENABLED,
        stats: PipelineStats | None = None,
        fault_injector=None,
    ):
        self._executor = executor
        self.policy = policy or FlushPolicy()
        self._validation = validation
        self.stats = stats or PipelineStats()
        self._sched = VerifyScheduler(
            self.policy, self.stats, fault_injector=fault_injector
        )
        self._pending: list[_Entry] = []
        # the causal trace the current (accumulating) window records
        # under: anchored at the window's FIRST stage-A span, handed to
        # the scheduler at dispatch, None while tracing is off
        self._window_ctx = None
        # committed position = checkpoint + proven blocks since it
        self._checkpoint = executor.state.copy()
        self._since_checkpoint: list = []
        self._dispatched_since_checkpoint = 0
        self._seq = 0
        self._broken: Exception | None = None
        self._closed = False

    # -- public surface ------------------------------------------------------
    @property
    def state(self):
        """The executor's (possibly speculative) head state."""
        return self._executor.state

    @property
    def committed_state(self):
        """The last signature-verified state. Free when the pipeline is
        settled (nothing speculative: the head IS committed); otherwise
        rebuilt on a scratch executor from the newest checkpoint by
        replaying the proven blocks since."""
        if not self._pending and self._sched.idle:
            return self._executor.state
        scratch = type(self._executor)(
            self._checkpoint.copy(), self._executor.context
        )
        throwaway = SignatureBatch()
        with defer_flushes(throwaway):
            for block in self._since_checkpoint:
                scratch.apply_block_with_validation(block, self._validation)
        return scratch.state

    def submit(self, signed_block) -> None:
        """Speculatively apply one block (stage A) and queue its signature
        sets for windowed verification (stage B). Raises the block's
        structured error — or an earlier queued block's, settled first —
        exactly as the sequential path would, leaving ``state`` at the
        last committed position."""
        self._check_usable()
        self.stats.start()
        # zero-overhead guard: one bool read when no flight recorder or
        # other subscriber is attached
        hooked = _flight.HOOK.active
        mark = (
            _spans.RECORDER.mark()
            if hooked and _spans.RECORDER.enabled
            else None
        )
        t0 = time.perf_counter()
        sink = SignatureBatch()
        slot = int(signed_block.message.slot)
        try:
            # later blocks of an accumulating window adopt the context
            # anchored at the window's first stage-A span, so the whole
            # window records as ONE causal tree; the first block roots it
            with trace.adopt(self._window_ctx if self._pending else None):
                with trace.span("pipeline.stage_a", slot=slot):
                    if not self._pending:
                        self._window_ctx = trace.context()
                    with defer_flushes(sink):
                        self._executor.apply_block_with_validation(
                            signed_block, self._validation
                        )
        except Error as exc:
            t1 = time.perf_counter()
            self.stats.block_submitted(t1 - t0)
            if hooked:
                failed = self._make_entry(signed_block, slot, sink, t0, t1,
                                          mark)
                self._emit_block(failed, "rolled-back", blame=exc,
                                 trace_ctx=self._window_ctx)
                _flight.HOOK.emit(
                    "rollback",
                    {
                        "slot": slot,
                        "seq": None,
                        "structural": True,
                        "error": type(exc).__name__,
                    },
                )
            self._fail_structural(exc)  # never returns
        except Exception as exc:
            # not a verdict: a device or host fault mid-transition left the
            # live state partially mutated — restore and break (raises)
            self.stats.block_submitted(time.perf_counter() - t0)
            self._break(exc)
        t1 = time.perf_counter()
        if hooked:
            entry = self._make_entry(signed_block, slot, sink, t0, t1, mark)
        else:
            entry = _Entry(signed_block, slot, sink)
        self._pending.append(entry)
        self.stats.block_submitted(t1 - t0)
        if len(self._pending) >= self.policy.window_size:
            self._dispatch_pending()

    def close(self) -> PipelineStats:
        """Flush the partial window, settle every in-flight flush, and
        return the run's stats. Idempotent; a no-op (stats only) once the
        pipeline is broken — the failure was already raised."""
        if not self._closed and self._broken is None:
            try:
                if self._pending:
                    self._dispatch_pending()
                while not self._sched.idle:
                    self._settle_oldest()
            finally:
                self._closed = True
                self.stats.stop()
        return self.stats

    def abort(self) -> None:
        """Discard all speculative work and restore the last committed
        state (the context-manager exit path when the body raised)."""
        if self._closed:
            return
        dropped = self._sched.drop_all()
        pending, self._pending = self._pending, []
        if _flight.HOOK.active:
            self._emit_discards(dropped, pending)
        self._materialize_committed()
        if self._broken is None:
            self._broken = PipelineBrokenError("pipeline aborted")
        self._closed = True
        self.stats.stop()

    def __enter__(self) -> "ChainPipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()

    # -- flight-recorder lineage assembly ------------------------------------
    def _make_entry(self, signed_block, slot: int, sink, t0: float,
                    t1: float, mark) -> _Entry:
        """An entry carrying the stage-A stamps the lineage record needs
        (hook-active path only): apply window, post-apply fork, and the
        span-derived phase split when the span recorder is live."""
        entry = _Entry(signed_block, slot, sink)
        entry.t_start = t0
        entry.t_applied = t1
        entry.stage_a_s = t1 - t0
        entry.fork = self._executor.state.version().name.lower()
        if mark is not None:
            entry.phases = _phases.attribution(
                _spans.RECORDER.records_since(mark)
            )
        return entry

    def _emit_block(self, entry: _Entry, outcome: str, window=None,
                    blame=None, degraded=None, trace_ctx=None) -> None:
        """Assemble one ``BlockLineage`` from the entry's stage-A stamps
        and its window's stage-B stamps, and publish it on the commit
        hook. Callers guard with ``_flight.HOOK.active``. The lineage
        names the causal trace the block recorded under (the window's
        context, or ``trace_ctx`` on windowless paths), so a lineage
        record resolves via ``/trace`` into its span tree."""
        now = time.perf_counter()
        if trace_ctx is None and window is not None:
            trace_ctx = window.trace_ctx
        queue_wait = 0.0
        settle_s = None
        if window is not None and window.t_dispatch is not None:
            if entry.t_applied is not None:
                queue_wait = max(0.0, window.t_dispatch - entry.t_applied)
            if window.t_settled is not None:
                settle_s = max(0.0, window.t_settled - window.t_dispatch)
        if degraded is None:
            degraded = bool(window.degraded) if window is not None else False
        _flight.HOOK.emit(
            "block",
            _flight.BlockLineage(
                slot=entry.slot,
                root=_state_root_hex(entry.signed_block),
                block_root=_block_root_hex(entry.signed_block),
                fork=entry.fork,
                outcome=outcome,
                stage_a_s=entry.stage_a_s,
                phases=entry.phases,
                queue_wait_s=queue_wait,
                flush_seq=window.seq if window is not None else None,
                flush_slots=(
                    tuple(e.slot for e in window.entries)
                    if window is not None
                    else ()
                ),
                flush_sets=len(window.batch) if window is not None else 0,
                verify_s=window.verify_s if window is not None else None,
                verify_route=(
                    window.verify_route if window is not None else None
                ),
                settle_s=settle_s,
                total_s=(
                    now - entry.t_start
                    if entry.t_start is not None
                    else None
                ),
                retries=(
                    max(0, window.attempts - 1) if window is not None else 0
                ),
                degraded=degraded,
                blame=(
                    {"error": type(blame).__name__, "detail": str(blame)}
                    if blame is not None
                    else None
                ),
                trace_id=(
                    trace_ctx.trace_id if trace_ctx is not None else None
                ),
            ),
        )

    def _emit_discards(self, dropped_windows, pending_entries,
                       blame=None) -> None:
        """Lineage for speculative work abandoned by someone else's
        failure: every block of every dropped in-flight window plus the
        never-dispatched pending entries."""
        for window in dropped_windows:
            for entry in window.entries:
                self._emit_block(entry, "discarded", window=window,
                                 blame=blame)
        for entry in pending_entries:
            self._emit_block(entry, "discarded", blame=blame)

    def _publish_state(self, entries, snap, seq=None) -> None:
        """Hand the serving layer an immutable snapshot of the committed
        state these entries produced (the commit hook's STATE channel —
        telemetry/flight.py). ``snap`` must be a state copy that nothing
        will mutate again: either a window's dispatch-time ``snap_state``
        or a copy taken while the live state IS the committed position.
        Callers guard with ``_flight.HOOK.state_active``."""
        last = entries[-1]
        _flight.HOOK.emit_state(
            {
                "state": snap,
                "context": self._executor.context,
                "slot": last.slot,
                "root": _state_root_hex(last.signed_block),
                "block_root": _block_root_hex(last.signed_block),
                # the committed signed block itself: the light-client
                # plane (proofs/light_client.py) reads sync_aggregate/
                # signature_slot from it and proves execution_branch
                # over its body — a reference, already immutable after
                # commit, so the channel stays copy-free
                "block": last.signed_block,
                "seq": seq,
            }
        )

    def _emit_head(self, entry: _Entry, blocks: int, seq=None,
                   trace_ctx=None) -> None:
        _flight.HOOK.emit(
            "head",
            {
                "slot": entry.slot,
                "root": _state_root_hex(entry.signed_block),
                "block_root": _block_root_hex(entry.signed_block),
                "blocks": blocks,
                "seq": seq,
                # the causal trace the head-advancing window recorded
                # under — SSE consumers can resolve it via /trace
                "trace_id": (
                    trace_ctx.trace_id if trace_ctx is not None else None
                ),
            },
        )

    # -- internals -----------------------------------------------------------
    def _check_usable(self) -> None:
        if self._broken is not None:
            raise PipelineBrokenError(
                f"pipeline is broken ({self._broken!r}); the state is at "
                "the last committed position"
            ) from self._broken
        if self._closed:
            raise PipelineBrokenError("pipeline is closed")

    def _dispatch_pending(self) -> None:
        entries, self._pending = self._pending, []
        trace_ctx, self._window_ctx = self._window_ctx, None
        merged = SignatureBatch()
        for entry in entries:
            merged.merge(entry.batch)
        # checkpoint-due windows snapshot the live state, which right now
        # IS the post-window state (nothing later has been applied yet)
        self._dispatched_since_checkpoint += 1
        candidate = None
        if self._dispatched_since_checkpoint >= self.policy.checkpoint_interval:
            candidate = self._executor.state.copy()
            self._dispatched_since_checkpoint = 0
            self.stats.checkpoint()
        if not len(merged) and not self.policy.flush_empty:
            # a window that deferred zero sets has nothing to prove
            self._commit(entries, candidate, window=None,
                         trace_ctx=trace_ctx)
            return
        window = Window(entries, merged, candidate, self._seq)
        window.trace_ctx = trace_ctx
        if _flight.HOOK.state_active:
            # serving data plane attached (telemetry/flight.py state
            # channel): copy the post-window state NOW, while the live
            # state is exactly it — the copy is published at commit and
            # never reused by the engine, so readers can't be torn by
            # later speculative applies. Deliberately NOT the checkpoint
            # object: the engine copy-shares checkpoints on failure
            # paths, which would race reader-side column syncs.
            window.snap_state = _snapshot_copy(self._executor.state)
        self._seq += 1
        # backpressure: the bounded queue admits a new window only after
        # the oldest one settles — this wait is where an over-eager
        # producer blocks instead of piling unverified state in memory
        while self._sched.full:
            self._settle_oldest()
        self._sched.dispatch(window)

    def _settle_oldest(self) -> None:
        try:
            window, verdicts = self._sched.settle_oldest()
        except PipelineBrokenError as exc:
            # a bounded settle expired (verifier wedged) or the verifier
            # raised (a device failure): abandon every in-flight window,
            # restore the committed position, and break the pipeline — the
            # submitter gets attribution, not a hang or a hidden fallback
            self._break(exc, stuck=getattr(exc, "stuck_window", None))
        if all(verdicts):
            self._commit(window.entries, window.post_state, window=window)
            return
        self._rollback(window, verdicts)  # raises

    def _break(self, exc: Exception, stuck=None) -> None:
        """Not a consensus verdict — a settle that timed out or raised
        (``PipelineBrokenError``, ``stuck`` its popped window), or a device
        or host fault in stage A: abandon every in-flight window and
        pending entry, restore the committed position, break the pipeline
        and re-raise."""
        _metrics.gauge("pipeline.broken").set(1)
        dropped = self._sched.drop_all()
        pending, self._pending = self._pending, []
        if _flight.HOOK.active:
            if stuck is not None:
                dropped = [stuck] + dropped
            self._emit_discards(dropped, pending, blame=exc)
            if isinstance(exc, PipelineBrokenError):
                _flight.HOOK.emit(
                    "broken",
                    {
                        "window_seq": exc.window_seq,
                        "slots": list(exc.slots),
                        "detail": str(exc),
                    },
                )
        self._materialize_committed()
        self._broken = exc
        self.stats.stop()
        raise exc

    def _commit(self, entries, checkpoint, window=None,
                trace_ctx=None) -> None:
        if trace_ctx is None and window is not None:
            trace_ctx = window.trace_ctx
        if checkpoint is not None:
            self._checkpoint = checkpoint
            self._since_checkpoint = []
        else:
            self._since_checkpoint.extend(e.signed_block for e in entries)
        self.stats.blocks_were_committed(len(entries))
        if _flight.HOOK.state_active and entries:
            if window is None:
                # the empty-flush path commits synchronously inside
                # dispatch: the live state IS the committed position
                self._publish_state(
                    entries, _snapshot_copy(self._executor.state)
                )
            elif window.snap_state is not None:
                self._publish_state(
                    entries, window.snap_state, seq=window.seq
                )
            # a window dispatched before the store attached has no
            # snapshot (and the live state may be speculatively ahead):
            # skip — the next dispatched window publishes the new head
        if _flight.HOOK.active and entries:
            for entry in entries:
                self._emit_block(entry, "committed", window=window,
                                 trace_ctx=trace_ctx)
            self._emit_head(
                entries[-1], len(entries),
                seq=window.seq if window is not None else None,
                trace_ctx=trace_ctx,
            )
            _flight.HOOK.emit(
                "commit",
                {
                    "seq": window.seq if window is not None else None,
                    "slots": [e.slot for e in entries],
                    "sets": len(window.batch) if window is not None else 0,
                    "checkpoint": checkpoint is not None,
                    "degraded": (
                        bool(window.degraded) if window is not None else False
                    ),
                    "trace_id": (
                        trace_ctx.trace_id
                        if trace_ctx is not None
                        else None
                    ),
                },
            )
        trace.event(
            "pipeline.commit",
            blocks=len(entries),
            checkpoint=checkpoint is not None,
        )

    def _materialize_committed(self) -> None:
        """Point the executor at the last committed state: the newest
        checkpoint plus a deterministic replay of the proven blocks since
        (signatures already proven, so the throwaway sink skips the
        re-pairing). Failure paths only."""
        self._executor.state = self._checkpoint.copy()
        if self._since_checkpoint:
            throwaway = SignatureBatch()
            with defer_flushes(throwaway):
                for block in self._since_checkpoint:
                    self._executor.apply_block_with_validation(
                        block, self._validation
                    )

    def _rollback(self, window: Window, verdicts: "list[bool]") -> None:
        """A window failed: the verifier's per-set fallback
        (crypto/bls.verify_signature_sets) has already re-verified the
        window's sets sequentially, so the verdicts are exact and the
        first False in call-site order names the failing block and
        operation. Discard the speculative state, rebuild the committed
        position, re-apply the proven prefix to land exactly at the
        failure boundary, and raise the failing set's structured error."""
        self.stats.rollback()
        self.stats.sequential_reverify()
        fail_idx = verdicts.index(False)
        at = 0
        fail_block = 0
        local_idx = fail_idx
        for i, entry in enumerate(window.entries):
            n = len(entry.batch)
            if fail_idx < at + n:
                fail_block, local_idx = i, fail_idx - at
                break
            at += n
        error = window.entries[fail_block].batch.errors[local_idx]
        trace.event(
            "pipeline.rollback",
            seq=window.seq,
            failed_slot=window.entries[fail_block].slot,
            committed_blocks=fail_block,
            error=type(error).__name__,
        )
        hooked = _flight.HOOK.active
        if hooked:
            # disposition of every block the failed window carried: the
            # proven prefix commits (re-applied below without re-pairing),
            # the blamed block rolls back, the rest of the speculative
            # window is discarded
            for entry in window.entries[:fail_block]:
                self._emit_block(entry, "committed", window=window)
            self._emit_block(
                window.entries[fail_block], "rolled-back", window=window,
                blame=error,
            )
            for entry in window.entries[fail_block + 1:]:
                self._emit_block(entry, "discarded", window=window)
            _flight.HOOK.emit(
                "rollback",
                {
                    "seq": window.seq,
                    "slot": window.entries[fail_block].slot,
                    "structural": False,
                    "error": type(error).__name__,
                    "committed_blocks": fail_block,
                },
            )
        dropped = self._sched.drop_all()
        pending, self._pending = self._pending, []
        if hooked:
            self._emit_discards(dropped, pending)
        self._materialize_committed()
        if fail_block > 0:
            proven = window.entries[:fail_block]
            throwaway = SignatureBatch()
            with defer_flushes(throwaway):
                for entry in proven:
                    self._executor.apply_block_with_validation(
                        entry.signed_block, self._validation
                    )
            self._since_checkpoint.extend(e.signed_block for e in proven)
            self.stats.blocks_were_committed(fail_block)
            if _flight.HOOK.state_active:
                # the live state IS the rolled-back committed position
                # (checkpoint + proven prefix, just re-applied): publish
                # it so the serving head lands exactly at the failure
                # boundary — the rolled-back state itself is never
                # published (it was discarded above, pre-commit)
                self._publish_state(
                    proven, self._executor.state.copy(), seq=window.seq
                )
            if hooked:
                self._emit_head(proven[-1], fail_block, seq=window.seq,
                                trace_ctx=window.trace_ctx)
        self._broken = error
        self.stats.stop()
        raise error

    def _fail_structural(self, exc: Exception) -> None:
        """Stage A aborted structurally mid-block: the live state is a
        discarded partial mutation. Earlier queued blocks must settle
        FIRST — an earlier block's bad signature preempts this later
        block's error, matching sequential order. In-flight windows
        settle through their normal paths; still-pending blocks re-apply
        sequentially with INLINE verification (the terminal sequential
        re-verify). Then the structural error propagates with the state
        at the last committed position."""
        pending, self._pending = self._pending, []
        hooked = _flight.HOOK.active
        try:
            while not self._sched.idle:
                self._settle_oldest()  # an earlier window failure raises
            self._materialize_committed()
            if pending:
                self.stats.sequential_reverify()
                for entry in pending:
                    try:
                        self._executor.apply_block_with_validation(
                            entry.signed_block, self._validation
                        )
                    except Error as inline_exc:
                        if hooked:
                            self._emit_block(
                                entry, "rolled-back", blame=inline_exc
                            )
                        raise
                    self._since_checkpoint.append(entry.signed_block)
                    self.stats.blocks_were_committed(1)
                    if _flight.HOOK.state_active:
                        # each inline re-apply advances the committed
                        # position with the live state sitting exactly on
                        # it (rare path: structural abort drain)
                        self._publish_state(
                            [entry], self._executor.state.copy()
                        )
                    if hooked:
                        # committed, but verified IN-LINE on this thread (the
                        # terminal sequential re-verify) — the lineage
                        # marks the lost overlap like a degraded window
                        self._emit_block(entry, "committed", degraded=True)
                if hooked:
                    self._emit_head(pending[-1], len(pending))
        except Error as earlier:
            if self._broken is None:  # a pending inline re-apply failed
                self._materialize_committed()
                self._broken = earlier
                self.stats.stop()
            raise earlier
        self._broken = exc
        self.stats.stop()
        raise exc
