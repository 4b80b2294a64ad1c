"""electra epoch processing.

Reference parity: ethereum-consensus/src/electra/epoch_processing.rs —
unbounded process_registry_updates (EIP-7251 removes the activation queue
churn; activations happen at the computed epoch directly),
process_pending_balance_deposits, process_pending_consolidations,
compounding-aware process_effective_balance_updates, electra process_epoch.

Ported from ethereum_consensus_tpu/models/electra/epoch_processing.py.
"""

from __future__ import annotations

from .. import _diff
from ..deneb import epoch_processing as _deneb_ep
from ..deneb.epoch_processing import (
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

__all__ = [
    "process_registry_updates",
    "process_pending_balance_deposits",
    "process_pending_consolidations",
    "process_effective_balance_updates",
    "process_epoch",
]


def process_registry_updates(state, context) -> None:
    """(epoch_processing.rs electra process_registry_updates) — EIP-7251:
    queue entry keys on MIN_ACTIVATION_BALANCE (>=, not == max) and every
    finalized-eligible validator activates immediately (no churn queue).
    Above the vectorized threshold the shared
    ``vectorized_registry_scan`` runs with the 7251 queue-entry rule and
    this fork's activation rule applied to its result; the literal loop
    below is the oracle and small-registry path."""
    current_epoch = h.get_current_epoch(state, context)
    n = len(state.validators)
    from ..phase0.epoch_processing import (
        _VECTORIZED_REWARDS_MIN_N,
        vectorized_registry_scan,
    )

    if n >= _VECTORIZED_REWARDS_MIN_N:
        activatable = vectorized_registry_scan(
            state,
            context,
            queue_entry_ge_min_activation=True,
            helpers=h,  # EIP-7251 balance-weighted exit churn
        )
        activation_epoch = h.compute_activation_exit_epoch(
            current_epoch, context
        )
        for index in activatable:
            state.validators[index].activation_epoch = activation_epoch
        return
    for index, validator in enumerate(state.validators):
        if h.is_eligible_for_activation_queue(validator, context):
            validator.activation_eligibility_epoch = current_epoch + 1
        if (
            h.is_active_validator(validator, current_epoch)
            and validator.effective_balance <= context.ejection_balance
        ):
            h.initiate_validator_exit(state, index, context)

    activation_epoch = h.compute_activation_exit_epoch(current_epoch, context)
    for validator in state.validators:
        if h.is_eligible_for_activation(state, validator):
            validator.activation_epoch = activation_epoch


def process_pending_balance_deposits(state, context) -> None:
    """(epoch_processing.rs process_pending_balance_deposits)"""
    available_for_processing = (
        state.deposit_balance_to_consume
        + h.get_activation_exit_churn_limit(state, context)
    )
    processed_amount = 0
    next_deposit_index = 0
    for deposit in state.pending_balance_deposits:
        if processed_amount + deposit.amount > available_for_processing:
            break
        h.increase_balance(state, deposit.index, deposit.amount)
        processed_amount += deposit.amount
        next_deposit_index += 1

    del state.pending_balance_deposits[:next_deposit_index]

    if len(state.pending_balance_deposits) == 0:
        state.deposit_balance_to_consume = 0
    else:
        state.deposit_balance_to_consume = (
            available_for_processing - processed_amount
        )


def process_pending_consolidations(state, context) -> None:
    """(epoch_processing.rs process_pending_consolidations)"""
    next_pending_consolidation = 0
    for pending in state.pending_consolidations:
        source_validator = state.validators[pending.source_index]
        if source_validator.slashed:
            next_pending_consolidation += 1
            continue
        if source_validator.withdrawable_epoch > h.get_current_epoch(state, context):
            break
        h.switch_to_compounding_validator(state, pending.target_index, context)
        active_balance = h.get_active_balance(state, pending.source_index, context)
        h.decrease_balance(state, pending.source_index, active_balance)
        h.increase_balance(state, pending.target_index, active_balance)
        next_pending_consolidation += 1

    del state.pending_consolidations[:next_pending_consolidation]


def process_effective_balance_updates(state, context) -> None:
    """(epoch_processing.rs electra process_effective_balance_updates) —
    per-validator limit depends on compounding credentials. Columnar host
    twin above the vectorized threshold (models/ops_vector.py, EIP-7251
    compounding-aware); the literal loop is the oracle/fallback."""
    # the ONLY spec site that mutates effective balances: drop the
    # total-active-balance memo (helpers.get_total_active_balance)
    state.__dict__.pop("_total_active_balance_cache", None)
    from ..phase0.epoch_processing import _VECTORIZED_REWARDS_MIN_N

    if len(state.validators) >= _VECTORIZED_REWARDS_MIN_N:
        from ..ops_vector import effective_balance_update_hits

        hits = effective_balance_update_hits(
            state, context, per_validator_limit=True
        )
        if hits is not None:
            validators = state.validators
            for index, value in hits:
                validators[index].effective_balance = value
            return
    hysteresis_increment = (
        context.EFFECTIVE_BALANCE_INCREMENT // context.HYSTERESIS_QUOTIENT
    )
    downward_threshold = hysteresis_increment * context.HYSTERESIS_DOWNWARD_MULTIPLIER
    upward_threshold = hysteresis_increment * context.HYSTERESIS_UPWARD_MULTIPLIER
    for index, validator in enumerate(state.validators):
        balance = state.balances[index]
        if h.has_compounding_withdrawal_credential(validator):
            limit = context.MAX_EFFECTIVE_BALANCE_ELECTRA
        else:
            limit = context.MIN_ACTIVATION_BALANCE
        if (
            balance + downward_threshold < validator.effective_balance
            or validator.effective_balance + upward_threshold < balance
        ):
            validator.effective_balance = min(
                balance - balance % context.EFFECTIVE_BALANCE_INCREMENT, limit
            )


def process_epoch(state, context) -> None:
    """(epoch_processing.rs electra process_epoch) — columnar-primary
    pass above the engine threshold (models/epoch_vector.py), including
    the EIP-7251 churn stages; literal list = oracle."""
    from ..epoch_vector import process_epoch_columnar

    if process_epoch_columnar(state, context, "electra"):
        return
    process_justification_and_finalization(state, context)
    process_inactivity_updates(state, context)
    process_rewards_and_penalties(state, context)
    process_registry_updates(state, context)
    process_slashings(state, context)
    process_eth1_data_reset(state, context)
    process_pending_balance_deposits(state, context)
    process_pending_consolidations(state, context)
    process_effective_balance_updates(state, context)
    process_slashings_reset(state, context)
    process_randao_mixes_reset(state, context)
    process_historical_summaries_update(state, context)
    process_participation_flag_updates(state, context)
    process_sync_committee_updates(state, context)


_diff.inherit(globals(), _deneb_ep)
