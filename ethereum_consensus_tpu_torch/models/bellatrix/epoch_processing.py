"""bellatrix epoch processing.

Reference parity: ethereum-consensus/src/bellatrix/epoch_processing.rs —
process_slashings:14 (bellatrix proportional multiplier), process_epoch:61;
inactivity deltas swap in via bellatrix helpers. Ported from
ethereum_consensus_tpu/models/bellatrix/epoch_processing.py.
"""

from __future__ import annotations

from .. import _diff
from ..altair import epoch_processing as _altair_ep
from ..altair.epoch_processing import (
    process_effective_balance_updates,
    process_eth1_data_reset,
    process_historical_roots_update,
    process_inactivity_updates,
    process_justification_and_finalization,
    process_participation_flag_updates,
    process_randao_mixes_reset,
    process_registry_updates,
    process_slashings_reset,
    process_sync_committee_updates,
)
from . import helpers as h

__all__ = ["process_rewards_and_penalties", "process_slashings", "process_epoch"]


def process_rewards_and_penalties(state, context) -> None:
    """altair shape with the bellatrix inactivity-penalty quotient and
    bellatrix helpers (same pack-once device path)."""
    _altair_ep.process_rewards_and_penalties(
        state,
        context,
        helpers=h,
        inactivity_quotient_name="INACTIVITY_PENALTY_QUOTIENT_BELLATRIX",
    )


def process_slashings(state, context) -> None:
    """(epoch_processing.rs:14) — PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX."""
    epoch = h.get_current_epoch(state, context)
    total_balance = h.get_total_active_balance(state, context)
    adjusted_total_slashing_balance = min(
        sum(state.slashings) * context.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX,
        total_balance,
    )
    increment = context.EFFECTIVE_BALANCE_INCREMENT
    for index, validator in enumerate(state.validators):
        if (
            validator.slashed
            and epoch + context.EPOCHS_PER_SLASHINGS_VECTOR // 2
            == validator.withdrawable_epoch
        ):
            penalty_numerator = (
                validator.effective_balance
                // increment
                * adjusted_total_slashing_balance
            )
            penalty = penalty_numerator // total_balance * increment
            h.decrease_balance(state, index, penalty)


def process_epoch(state, context) -> None:
    """(epoch_processing.rs:61) — columnar-primary pass above the
    engine threshold (models/epoch_vector.py); literal list = oracle."""
    from ..epoch_vector import process_epoch_columnar

    if process_epoch_columnar(state, context, "bellatrix"):
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
    process_historical_roots_update(state, context)
    process_participation_flag_updates(state, context)
    process_sync_committee_updates(state, context)


_diff.inherit(globals(), _altair_ep)
