"""deneb slot processing (generic skeleton + deneb process_epoch)."""

from __future__ import annotations

from ..transition import process_slots_generic
from ..capella.slot_processing import process_slot  # noqa: F401 — fork-diff re-export
from .epoch_processing import process_epoch

__all__ = ["process_slot", "process_slots"]


def process_slots(state, slot: int, context) -> None:
    process_slots_generic(state, slot, context, process_epoch)
