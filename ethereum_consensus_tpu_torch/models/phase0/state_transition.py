"""phase0 state transition (generic skeleton + phase0 block processing).

Reference parity: ethereum-consensus/src/phase0/state_transition.rs:15-106
(state_transition_block_in_slot, state_transition, Validation toggle).
A block whose slot lies past an epoch boundary crosses it in
``process_slots``.
"""

from __future__ import annotations

from ..transition import Validation, state_transition_block_in_slot_generic
from .block_processing import process_block
from .slot_processing import process_epoch, process_slots

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
