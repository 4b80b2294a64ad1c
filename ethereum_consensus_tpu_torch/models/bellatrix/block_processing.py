"""bellatrix block processing.

Reference parity: ethereum-consensus/src/bellatrix/block_processing.rs —
process_execution_payload:14 (parent hash / prev_randao / timestamp checks +
ExecutionEngine notify), bellatrix process_block (payload gated on
is_execution_enabled). Ported from
ethereum_consensus_tpu/models/bellatrix/block_processing.py.
"""

from __future__ import annotations

from ...error import InvalidExecutionPayload
from ...execution_engine import verify_and_notify_new_payload
from .. import _diff
from ..altair import block_processing as _altair_bp
from ..altair.block_processing import (
    process_block_header,
    process_eth1_data,
    process_randao,
    process_sync_aggregate,
)
from .containers import execution_payload_to_header
from . import helpers as h

__all__ = ["process_execution_payload", "process_operations", "process_block"]


def process_operations(state, body, context) -> None:
    """altair operations loop with the bellatrix slash_validator."""
    _altair_bp.process_operations(state, body, context, slash_fn=h.slash_validator)


def process_execution_payload(state, body, context) -> None:
    """(block_processing.rs:14)"""
    payload = body.execution_payload

    if h.is_merge_transition_complete(state):
        expected = state.latest_execution_payload_header.block_hash
        if payload.parent_hash != expected:
            raise InvalidExecutionPayload(
                f"payload parent hash {bytes(payload.parent_hash).hex()} != "
                f"latest payload block hash {bytes(expected).hex()}"
            )

    current_epoch = h.get_current_epoch(state, context)
    randao_mix = h.get_randao_mix(state, current_epoch)
    if payload.prev_randao != randao_mix:
        raise InvalidExecutionPayload("payload prev_randao != randao mix")

    timestamp = h.compute_timestamp_at_slot(state, state.slot, context)
    if payload.timestamp != timestamp:
        raise InvalidExecutionPayload(
            f"payload timestamp {payload.timestamp} != slot timestamp {timestamp}"
        )

    verify_and_notify_new_payload(context.execution_engine, payload)

    state.latest_execution_payload_header = execution_payload_to_header(
        payload, type(state).__ssz_fields__["latest_execution_payload_header"]
    )


def process_block(state, block, context) -> None:
    """(block_processing.rs process_block, bellatrix)"""
    process_block_header(state, block, context)
    if h.is_execution_enabled(state, block.body):
        process_execution_payload(state, block.body, context)
    process_randao(state, block.body, context)
    process_eth1_data(state, block.body, context)
    process_operations(state, block.body, context)
    process_sync_aggregate(state, block.body.sync_aggregate, context)


_diff.inherit(globals(), _altair_bp)
