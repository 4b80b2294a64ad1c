"""capella epoch processing.

Reference parity: ethereum-consensus/src/capella/epoch_processing.rs —
process_historical_summaries_update (replaces historical_roots_update),
capella process_epoch; quotients unchanged from bellatrix. Ported from
ethereum_consensus_tpu/models/capella/epoch_processing.py.
"""

from __future__ import annotations

from .. import _diff
from ..bellatrix import epoch_processing as _bellatrix_ep
from ..bellatrix.epoch_processing import (
    process_effective_balance_updates,
    process_eth1_data_reset,
    process_inactivity_updates,
    process_justification_and_finalization,
    process_participation_flag_updates,
    process_randao_mixes_reset,
    process_registry_updates,
    process_rewards_and_penalties,
    process_slashings,
    process_slashings_reset,
    process_sync_committee_updates,
)
from ..phase0.containers import HistoricalSummary
from . import helpers as h

__all__ = ["process_historical_summaries_update", "process_epoch"]


def process_historical_summaries_update(state, context) -> None:
    """(epoch_processing.rs process_historical_summaries_update)"""
    next_epoch = h.get_current_epoch(state, context) + 1
    epochs_per_period = context.SLOTS_PER_HISTORICAL_ROOT // context.SLOTS_PER_EPOCH
    if next_epoch % epochs_per_period == 0:
        state_cls = type(state)
        summary = HistoricalSummary(
            block_summary_root=state_cls.__ssz_fields__["block_roots"].hash_tree_root(
                state.block_roots
            ),
            state_summary_root=state_cls.__ssz_fields__["state_roots"].hash_tree_root(
                state.state_roots
            ),
        )
        state.historical_summaries.append(summary)


def process_epoch(state, context) -> None:
    """(epoch_processing.rs process_epoch, capella) — columnar-primary
    pass above the engine threshold (models/epoch_vector.py); literal
    list = oracle."""
    from ..epoch_vector import process_epoch_columnar

    if process_epoch_columnar(state, context, "capella"):
        return
    process_justification_and_finalization(state, context)
    process_inactivity_updates(state, context)
    process_rewards_and_penalties(state, context)
    process_registry_updates(state, context)
    process_slashings(state, context)
    process_eth1_data_reset(state, context)
    process_effective_balance_updates(state, context)
    process_slashings_reset(state, context)
    process_randao_mixes_reset(state, context)
    process_historical_summaries_update(state, context)
    process_participation_flag_updates(state, context)
    process_sync_committee_updates(state, context)


_diff.inherit(globals(), _bellatrix_ep)
