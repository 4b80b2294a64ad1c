"""Execution-engine interface (the consensus ↔ execution boundary).

Reference parity: ethereum-consensus/src/execution_engine.rs:9-27 —
`PayloadRequest` marker, `ExecutionEngine` with
``verify_and_notify_new_payload``, and the `bool` mock (True accepts every
payload, False rejects). ``Context.execution_engine`` carries the mock
toggle exactly like the reference's `Context` field. Ported from
ethereum_consensus_tpu/execution_engine.py.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

from .error import ExecutionEngineError

__all__ = ["PayloadRequest", "ExecutionEngine", "verify_and_notify_new_payload"]


@runtime_checkable
class PayloadRequest(Protocol):
    """Marker for data sent to the execution engine (an ExecutionPayload or
    a fork-specific NewPayloadRequest)."""


@runtime_checkable
class ExecutionEngine(Protocol):
    def verify_and_notify_new_payload(self, new_payload_request) -> None:
        """Raise ExecutionEngineError if the payload is invalid."""


def verify_and_notify_new_payload(engine, new_payload_request) -> None:
    """Dispatch that admits the reference's ``bool`` mock alongside real
    engines (execution_engine.rs:21-27)."""
    if isinstance(engine, bool):
        if not engine:
            raise ExecutionEngineError("execution engine rejected payload")
        return
    engine.verify_and_notify_new_payload(new_payload_request)
