"""Pipeline error taxonomy — shared by engine.py and scheduler.py.

Reference parity: ethereum_consensus_tpu/pipeline/errors.py.

These live in their own module (not engine.py) because the scheduler's
hardened settle path raises ``PipelineBrokenError`` too, and importing
it from the engine would be circular (engine imports scheduler).
"""

from __future__ import annotations

__all__ = ["PipelineBrokenError", "TransientFlushError", "WorkerKilled"]


class PipelineBrokenError(RuntimeError):
    """The pipeline already failed (the structured error was raised at the
    failure point), was aborted, or a bounded wait expired on a wedged
    verifier; it accepts no further blocks. ``window_seq`` / ``slots``
    carry the stuck window's attribution when a timeout raised it."""

    def __init__(self, message: str, window_seq: "int | None" = None,
                 slots: "tuple | None" = None):
        super().__init__(message)
        self.window_seq = window_seq
        self.slots = tuple(slots) if slots else ()


class TransientFlushError(RuntimeError):
    """A flush failed for an infrastructure (non-consensus) reason that a
    retry can plausibly clear — the scheduler retries it with bounded
    backoff before degrading to in-line verification. Consensus verdicts
    are NEVER modeled as transient: an invalid signature is a verdict,
    not an error."""


class WorkerKilled(BaseException):
    """The background verifier worker died mid-flush (fault injection's
    stand-in for a crashed/OOM-killed thread). Derives from BaseException
    so nothing on the worker accidentally swallows it; the scheduler
    catches it at the settle boundary and degrades to in-line verification
    on the route the worker took."""
