"""Fork-generic slot processing and state transition.

Every fork's state_transition has the same skeleton (the reference re-spins
phase0/state_transition.rs:15-106 per fork via spec-gen); here the skeleton
is written once and parameterized by the fork's ``process_epoch`` /
``process_block`` — the composition that replaces codegen.
"""

from __future__ import annotations

from enum import Enum

from ..error import Error, InvalidStateRoot, StateTransitionError, checked_add
from .phase0.containers import BeaconBlockHeader
from .phase0.helpers import verify_block_signature
from .signature_batch import collect_signatures

__all__ = [
    "Validation",
    "process_slot_generic",
    "process_slots_generic",
    "state_transition_generic",
    "state_transition_block_in_slot_generic",
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


def state_transition_block_in_slot_generic(
    state, signed_block, validation, context, process_block
) -> None:
    """(phase0/state_transition.rs:15)

    Every signature claim the block makes — proposer, randao, slashing
    headers, attestation aggregates, exits — is collected while processing
    and verified as ONE batch (signature_batch module) before the
    state-root check. An invalid signature aborts the transition with the
    same structured error the sequential path raises, attributed to the
    first failing operation in spec order. When block processing aborts
    structurally mid-collection, the sets already deferred (all from
    earlier call sites) are verified first, so a bad signature earlier in
    the block preempts the later structural error — exactly the order the
    sequential path surfaces them in."""
    block = signed_block.message
    with collect_signatures() as batch:
        try:
            if validation is Validation.ENABLED:
                verify_block_signature(state, signed_block, context)
            process_block(state, block, context)
        except Error:
            # any structured abort (invalid operation, crypto parse,
            # arithmetic guard): earlier call sites' signatures first
            batch.raise_if_any_invalid()
            raise
        if validation is Validation.ENABLED:
            state_root = type(state).hash_tree_root(state)
            if block.state_root != state_root:
                # sequentially this block's signature claims verify BEFORE
                # the root check, so a bad signature earlier in the block
                # preempts the root error
                batch.raise_if_any_invalid()
                raise InvalidStateRoot(block.state_root, state_root)
        batch.flush()


def state_transition_generic(
    state, signed_block, context, process_epoch, process_block, validation
) -> None:
    """(phase0/state_transition.rs:67)"""
    process_slots_generic(state, signed_block.message.slot, context, process_epoch)
    state_transition_block_in_slot_generic(
        state, signed_block, validation, context, process_block
    )
