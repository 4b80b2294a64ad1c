"""altair slot processing (phase0 skeleton + altair process_epoch). At an
epoch boundary ``process_epoch`` (epoch_processing.py) makes the
whole-registry epoch pass."""

from __future__ import annotations

from ..transition import process_slots_generic
from ..phase0.slot_processing import process_slot  # noqa: F401 — fork-diff re-export
from .epoch_processing import process_epoch

__all__ = ["process_slot", "process_slots", "process_epoch"]


def process_slots(state, slot: int, context) -> None:
    process_slots_generic(state, slot, context, process_epoch)
