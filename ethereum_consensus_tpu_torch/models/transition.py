"""Fork-generic slot processing.

Every fork's state_transition has the same skeleton (the reference re-spins
phase0/state_transition.rs:15-106 per fork via spec-gen); here the skeleton
is written once and parameterized by the fork's ``process_epoch``. The
block half of the skeleton comes with the port's block-processing slice.
"""

from __future__ import annotations

from enum import Enum

from ..error import StateTransitionError, checked_add
from .phase0.containers import BeaconBlockHeader

__all__ = [
    "Validation",
    "process_slot_generic",
    "process_slots_generic",
]


class Validation(Enum):
    ENABLED = "enabled"
    DISABLED = "disabled"


def process_slot_generic(state, context) -> None:
    """(phase0/slot_processing.rs:45 — identical in every fork)"""
    previous_state_root = type(state).hash_tree_root(state)
    limit = len(state.state_roots)
    state.state_roots[state.slot % limit] = previous_state_root

    if state.latest_block_header.state_root == b"\x00" * 32:
        state.latest_block_header.state_root = previous_state_root

    previous_block_root = BeaconBlockHeader.hash_tree_root(state.latest_block_header)
    state.block_roots[state.slot % limit] = previous_block_root


def process_slots_generic(state, slot: int, context, process_epoch) -> None:
    """(phase0/slot_processing.rs:9)"""
    if state.slot >= slot:
        raise StateTransitionError(
            f"cannot process slots backwards: state at {state.slot}, target {slot}"
        )
    while state.slot < slot:
        process_slot_generic(state, context)
        if (state.slot + 1) % context.SLOTS_PER_EPOCH == 0:
            process_epoch(state, context)
        state.slot = checked_add(state.slot, 1)
