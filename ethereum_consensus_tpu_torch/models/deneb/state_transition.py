"""deneb state transition (generic skeleton + deneb block/epoch)."""

from __future__ import annotations

from ..transition import (
    Validation,
    state_transition_block_in_slot_generic,
    state_transition_generic,
)
from .block_processing import process_block
from .epoch_processing import process_epoch
from .slot_processing import process_slots

__all__ = [
    "Validation",
    "process_slots",
    "state_transition",
    "state_transition_block_in_slot",
]


def state_transition_block_in_slot(state, signed_block, validation, context) -> None:
    state_transition_block_in_slot_generic(
        state, signed_block, validation, context, process_block
    )


def state_transition(state, signed_block, context, validation=Validation.ENABLED) -> None:
    state_transition_generic(
        state, signed_block, context, process_epoch, process_block, validation
    )
