"""phase0 slot processing.

Reference parity: ethereum-consensus/src/phase0/slot_processing.rs —
process_slots:9 / process_slot:45. The per-slot full-state hash_tree_root
here is the #1 merkleization hot path (SURVEY.md §3.1); large-leaf levels
route through the CUDA hasher when ops.install() has run.

phase0 epoch processing is not ported yet. A request that would cross an
epoch boundary raises ``NotImplementedError`` before the state is touched,
rather than skipping the epoch and producing a wrong state.
"""

from __future__ import annotations

from ..transition import process_slot_generic, process_slots_generic

__all__ = ["process_slot", "process_slots", "process_epoch"]


def process_epoch(state, context) -> None:
    raise NotImplementedError(
        "phase0 epoch processing (models/phase0/epoch_processing.py) is not "
        "ported yet; slots cannot cross an epoch boundary"
    )


def process_slot(state, context) -> None:
    """(slot_processing.rs:45)"""
    process_slot_generic(state, context)


def process_slots(state, slot: int, context) -> None:
    """(slot_processing.rs:9)"""
    next_epoch_start = (
        state.slot // context.SLOTS_PER_EPOCH + 1
    ) * context.SLOTS_PER_EPOCH
    if slot >= next_epoch_start:
        process_epoch(state, context)
    process_slots_generic(state, slot, context, process_epoch)
