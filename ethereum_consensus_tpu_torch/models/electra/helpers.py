"""electra spec helpers: compounding credentials, balance churn,
committee-spanning attestation indexing, balance-driven exits.

Reference parity: ethereum-consensus/src/electra/helpers.rs —
compounding credentials :27-35, get_validator_max_effective_balance,
get_balance_churn_limit:72, get_active_balance,
get_pending_balance_to_withdraw, electra get_attesting_indices /
get_indexed_attestation, initiate_validator_exit (churn-based),
switch_to_compounding_validator:412, queue_excess_active_balance:452,
compute_exit_epoch_and_update_churn:536,
compute_consolidation_epoch_and_update_churn, electra slash_validator.

Ported from ethereum_consensus_tpu/models/electra/helpers.py.
"""

from __future__ import annotations

from ...error import checked_add
from ...primitives import COMPOUNDING_WITHDRAWAL_PREFIX, FAR_FUTURE_EPOCH
from .. import _diff
from ..altair.constants import PROPOSER_WEIGHT, WEIGHT_DENOMINATOR
from ..capella.helpers import has_eth1_withdrawal_credential
from ..deneb import helpers as _deneb_helpers
from ..deneb.helpers import (
    compute_activation_exit_epoch,
    decrease_balance,
    get_beacon_committee,
    get_beacon_proposer_index,
    get_current_epoch,
    get_total_active_balance,
    increase_balance,
)

__all__ = [
    "is_eligible_for_activation_queue",
    "is_compounding_withdrawal_credential",
    "has_compounding_withdrawal_credential",
    "has_execution_withdrawal_credential",
    "is_fully_withdrawable_validator",
    "is_partially_withdrawable_validator",
    "get_committee_indices",
    "get_validator_max_effective_balance",
    "get_balance_churn_limit",
    "get_activation_exit_churn_limit",
    "get_consolidation_churn_limit",
    "get_active_balance",
    "get_pending_balance_to_withdraw",
    "get_attesting_indices",
    "get_indexed_attestation",
    "initiate_validator_exit",
    "switch_to_compounding_validator",
    "queue_excess_active_balance",
    "queue_entire_balance_and_reset_validator",
    "compute_exit_epoch_and_update_churn",
    "compute_consolidation_epoch_and_update_churn",
    "slash_validator",
]


def is_eligible_for_activation_queue(validator, context) -> bool:
    """(helpers.rs:21) — min activation balance, not max effective."""
    return (
        validator.activation_eligibility_epoch == FAR_FUTURE_EPOCH
        and validator.effective_balance >= context.MIN_ACTIVATION_BALANCE
    )


def is_compounding_withdrawal_credential(withdrawal_credentials: bytes) -> bool:
    return bytes(withdrawal_credentials)[:1] == COMPOUNDING_WITHDRAWAL_PREFIX


def has_compounding_withdrawal_credential(validator) -> bool:
    return is_compounding_withdrawal_credential(validator.withdrawal_credentials)


def has_execution_withdrawal_credential(validator) -> bool:
    return has_compounding_withdrawal_credential(
        validator
    ) or has_eth1_withdrawal_credential(validator)


def is_fully_withdrawable_validator(validator, balance: int, epoch: int) -> bool:
    return (
        has_execution_withdrawal_credential(validator)
        and validator.withdrawable_epoch <= epoch
        and balance > 0
    )


def is_partially_withdrawable_validator(validator, balance: int, context) -> bool:
    max_effective_balance = get_validator_max_effective_balance(validator, context)
    return (
        has_execution_withdrawal_credential(validator)
        and validator.effective_balance == max_effective_balance
        and balance > max_effective_balance
    )


def get_committee_indices(committee_bits: list) -> list[int]:
    return [i for i, bit in enumerate(committee_bits) if bit]


def get_validator_max_effective_balance(validator, context) -> int:
    if has_compounding_withdrawal_credential(validator):
        return context.MAX_EFFECTIVE_BALANCE_ELECTRA
    return context.MIN_ACTIVATION_BALANCE


def get_balance_churn_limit(state, context) -> int:
    """(helpers.rs:72)"""
    churn_limit = (
        get_total_active_balance(state, context) // context.churn_limit_quotient
    )
    churn = max(context.min_per_epoch_churn_limit_electra, churn_limit)
    return churn - churn % context.EFFECTIVE_BALANCE_INCREMENT


def get_activation_exit_churn_limit(state, context) -> int:
    return min(
        context.max_per_epoch_activation_exit_churn_limit,
        get_balance_churn_limit(state, context),
    )


def get_consolidation_churn_limit(state, context) -> int:
    return get_balance_churn_limit(state, context) - get_activation_exit_churn_limit(
        state, context
    )


def get_active_balance(state, validator_index: int, context) -> int:
    max_effective_balance = get_validator_max_effective_balance(
        state.validators[validator_index], context
    )
    return min(state.balances[validator_index], max_effective_balance)


def get_pending_balance_to_withdraw(state, validator_index: int) -> int:
    return sum(
        w.amount
        for w in state.pending_partial_withdrawals
        if w.index == validator_index
    )


def get_attesting_indices(state, attestation, context) -> set[int]:
    """(helpers.rs electra get_attesting_indices) — committee-spanning
    aggregation bits indexed by committee offset (EIP-7549)."""
    indices: set[int] = set()
    committee_offset = 0
    for index in get_committee_indices(attestation.committee_bits):
        committee = get_beacon_committee(state, attestation.data.slot, index, context)
        for i, validator_index in enumerate(committee):
            if attestation.aggregation_bits[committee_offset + i]:
                indices.add(validator_index)
        committee_offset += len(committee)
    return indices


def get_indexed_attestation(state, attestation, context):
    from .containers import build

    ns = build(context.preset)
    return ns.IndexedAttestation(
        attesting_indices=sorted(get_attesting_indices(state, attestation, context)),
        data=attestation.data.copy(),
        signature=attestation.signature,
    )


def initiate_validator_exit(state, index: int, context) -> None:
    """(helpers.rs electra initiate_validator_exit) — balance-churn exits."""
    validator = state.validators[index]
    if validator.exit_epoch != FAR_FUTURE_EPOCH:
        return
    exit_queue_epoch = compute_exit_epoch_and_update_churn(
        state, validator.effective_balance, context
    )
    validator.exit_epoch = exit_queue_epoch
    validator.withdrawable_epoch = checked_add(
        exit_queue_epoch, context.min_validator_withdrawability_delay
    )


def switch_to_compounding_validator(state, index: int, context) -> None:
    """(helpers.rs:412)"""
    validator = state.validators[index]
    if has_eth1_withdrawal_credential(validator):
        validator.withdrawal_credentials = (
            COMPOUNDING_WITHDRAWAL_PREFIX
            + bytes(validator.withdrawal_credentials)[1:]
        )
        queue_excess_active_balance(state, index, context)


def queue_excess_active_balance(state, index: int, context) -> None:
    """(helpers.rs:452)"""
    from .containers import PendingBalanceDeposit

    balance = state.balances[index]
    if balance > context.MIN_ACTIVATION_BALANCE:
        excess = balance - context.MIN_ACTIVATION_BALANCE
        state.balances[index] = context.MIN_ACTIVATION_BALANCE
        state.pending_balance_deposits.append(
            PendingBalanceDeposit(index=index, amount=excess)
        )


def queue_entire_balance_and_reset_validator(state, index: int) -> None:
    from .containers import PendingBalanceDeposit

    balance = state.balances[index]
    state.balances[index] = 0
    validator = state.validators[index]
    validator.effective_balance = 0
    validator.activation_eligibility_epoch = FAR_FUTURE_EPOCH
    # a (pre-active) validator's effective balance changed outside
    # process_effective_balance_updates: drop the total memo defensively
    state.__dict__.pop("_total_active_balance_cache", None)
    state.pending_balance_deposits.append(
        PendingBalanceDeposit(index=index, amount=balance)
    )


def compute_exit_epoch_and_update_churn(state, exit_balance: int, context) -> int:
    """(helpers.rs:536)"""
    current_epoch = get_current_epoch(state, context)
    activation_exit_epoch = compute_activation_exit_epoch(current_epoch, context)
    earliest_exit_epoch = max(state.earliest_exit_epoch, activation_exit_epoch)
    per_epoch_churn = get_activation_exit_churn_limit(state, context)
    if state.earliest_exit_epoch < earliest_exit_epoch:
        exit_balance_to_consume = per_epoch_churn
    else:
        exit_balance_to_consume = state.exit_balance_to_consume

    if exit_balance > exit_balance_to_consume:
        balance_to_process = exit_balance - exit_balance_to_consume
        additional_epochs = (balance_to_process - 1) // per_epoch_churn + 1
        earliest_exit_epoch += additional_epochs
        exit_balance_to_consume += additional_epochs * per_epoch_churn

    state.exit_balance_to_consume = exit_balance_to_consume - exit_balance
    state.earliest_exit_epoch = earliest_exit_epoch
    return state.earliest_exit_epoch


def compute_consolidation_epoch_and_update_churn(
    state, consolidation_balance: int, context
) -> int:
    """(helpers.rs compute_consolidation_epoch_and_update_churn)"""
    current_epoch = get_current_epoch(state, context)
    activation_exit_epoch = compute_activation_exit_epoch(current_epoch, context)
    earliest_consolidation_epoch = max(
        state.earliest_consolidation_epoch, activation_exit_epoch
    )
    per_epoch_churn = get_activation_exit_churn_limit(state, context)
    if state.earliest_consolidation_epoch < earliest_consolidation_epoch:
        consolidation_balance_to_consume = per_epoch_churn
    else:
        consolidation_balance_to_consume = state.consolidation_balance_to_consume

    if consolidation_balance > consolidation_balance_to_consume:
        balance_to_process = consolidation_balance - consolidation_balance_to_consume
        additional_epochs = (balance_to_process - 1) // per_epoch_churn + 1
        earliest_consolidation_epoch += additional_epochs
        consolidation_balance_to_consume += additional_epochs * per_epoch_churn

    state.consolidation_balance_to_consume = (
        consolidation_balance_to_consume - consolidation_balance
    )
    state.earliest_consolidation_epoch = earliest_consolidation_epoch
    return state.earliest_consolidation_epoch


def slash_validator(state, slashed_index: int, whistleblower_index, context) -> None:
    """(helpers.rs electra slash_validator) — electra quotients, spec
    proposer split (see altair.helpers.slash_validator note)."""
    epoch = get_current_epoch(state, context)
    initiate_validator_exit(state, slashed_index, context)
    validator = state.validators[slashed_index]
    validator.slashed = True
    validator.withdrawable_epoch = max(
        validator.withdrawable_epoch, epoch + context.EPOCHS_PER_SLASHINGS_VECTOR
    )
    state.slashings[epoch % context.EPOCHS_PER_SLASHINGS_VECTOR] = checked_add(
        state.slashings[epoch % context.EPOCHS_PER_SLASHINGS_VECTOR],
        validator.effective_balance,
    )
    decrease_balance(
        state,
        slashed_index,
        validator.effective_balance // context.MIN_SLASHING_PENALTY_QUOTIENT_ELECTRA,
    )

    proposer_index = get_beacon_proposer_index(state, context)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    whistleblower_reward = (
        validator.effective_balance // context.WHISTLEBLOWER_REWARD_QUOTIENT_ELECTRA
    )
    proposer_reward = whistleblower_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower_index, whistleblower_reward - proposer_reward)


_diff.inherit(globals(), _deneb_helpers)
