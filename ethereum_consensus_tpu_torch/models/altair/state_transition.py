"""altair state transition (generic skeleton + altair block and epoch
processing). Ported from ethereum_consensus_tpu/models/altair/state_transition.py."""

from __future__ import annotations

from ..transition import Validation, state_transition_block_in_slot_generic
from .block_processing import process_block
from .epoch_processing import process_epoch
from .slot_processing import process_slots

__all__ = [
    "Validation",
    "process_epoch",
    "process_slots",
    "state_transition",
    "state_transition_block_in_slot",
]


def state_transition_block_in_slot(state, signed_block, validation, context) -> None:
    state_transition_block_in_slot_generic(
        state, signed_block, validation, context, process_block
    )


def state_transition(state, signed_block, context, validation=Validation.ENABLED) -> None:
    """(state_transition.rs:67): slots to the block's slot, then the block."""
    process_slots(state, signed_block.message.slot, context)
    state_transition_block_in_slot(state, signed_block, validation, context)
