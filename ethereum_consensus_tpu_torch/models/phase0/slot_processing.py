"""phase0 slot processing.

Reference parity: ethereum-consensus/src/phase0/slot_processing.rs —
process_slots:9 / process_slot:45. The per-slot full-state hash_tree_root
here is the #1 merkleization hot path (SURVEY.md §3.1); large-leaf levels
route through the CUDA hasher when ops.install() has run. At an epoch
boundary ``process_epoch`` (epoch_processing.py) makes the whole-registry
epoch pass.
"""

from __future__ import annotations

from ..transition import process_slot_generic, process_slots_generic
from .epoch_processing import process_epoch

__all__ = ["process_slot", "process_slots", "process_epoch"]


def process_slot(state, context) -> None:
    """(slot_processing.rs:45)"""
    process_slot_generic(state, context)


def process_slots(state, slot: int, context) -> None:
    """(slot_processing.rs:9)"""
    process_slots_generic(state, slot, context, process_epoch)
