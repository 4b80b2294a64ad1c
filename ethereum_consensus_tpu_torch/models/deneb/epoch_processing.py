"""deneb epoch processing.

Reference parity: ethereum-consensus/src/deneb/epoch_processing.rs —
process_registry_updates:11 (EIP-7514 activation churn limit), deneb
process_epoch. Ported from
ethereum_consensus_tpu/models/deneb/epoch_processing.py.
"""

from __future__ import annotations

from .. import _diff
from ..capella import epoch_processing as _capella_ep
from ..capella.epoch_processing import (
    process_effective_balance_updates,
    process_eth1_data_reset,
    process_historical_summaries_update,
    process_inactivity_updates,
    process_justification_and_finalization,
    process_participation_flag_updates,
    process_randao_mixes_reset,
    process_rewards_and_penalties,
    process_slashings,
    process_slashings_reset,
    process_sync_committee_updates,
)
from . import helpers as h

__all__ = ["process_registry_updates", "process_epoch"]


def process_registry_updates(state, context) -> None:
    """(epoch_processing.rs:11) — activations bounded by the EIP-7514
    activation churn limit instead of the exit churn limit; the scan
    itself is the shared (vectorized) phase0 sweep."""
    from ..phase0.epoch_processing import registry_scan_and_queue

    current_epoch = h.get_current_epoch(state, context)
    activation_queue = registry_scan_and_queue(state, context)
    churn_limit = h.get_validator_activation_churn_limit(state, context)
    activation_epoch = h.compute_activation_exit_epoch(current_epoch, context)
    for index in activation_queue[:churn_limit]:
        state.validators[index].activation_epoch = activation_epoch


def process_epoch(state, context) -> None:
    """(epoch_processing.rs process_epoch, deneb) — columnar-primary
    pass above the engine threshold (models/epoch_vector.py); literal
    list = oracle."""
    from ..epoch_vector import process_epoch_columnar

    if process_epoch_columnar(state, context, "deneb"):
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


_diff.inherit(globals(), _capella_ep)
