"""deneb → electra state upgrade.

Reference parity: ethereum-consensus/src/electra/fork.rs:19 — unset deposit
receipts start, churn accumulators primed from the post state, pre-activation
balances and compounding excesses queued as pending deposits.

The three registry scans of the upgrade (the latest exit epoch, the
pre-activation queue in (eligibility, index) order, the compounding
validators) read the pre-state's registry columns (``ops_vector``) when
they are available, and walk the registry otherwise; both give the same
post-state.

Ported from ethereum_consensus_tpu/models/electra/fork.py.
"""

from __future__ import annotations

from ...primitives import FAR_FUTURE_EPOCH, UNSET_DEPOSIT_RECEIPTS_START_INDEX
from ..altair.helpers import compute_activation_exit_epoch, get_current_epoch
from ..phase0.containers import Fork
from .. import ops_vector
from . import helpers as h
from .containers import build

__all__ = ["upgrade_to_electra"]


def upgrade_to_electra(state, context):
    """(fork.rs:19)"""
    ns = build(context.preset)
    epoch = get_current_epoch(state, context)
    old = state.latest_execution_payload_header
    header = ns.ExecutionPayloadHeader(
        parent_hash=old.parent_hash,
        fee_recipient=old.fee_recipient,
        state_root=old.state_root,
        receipts_root=old.receipts_root,
        logs_bloom=old.logs_bloom,
        prev_randao=old.prev_randao,
        block_number=old.block_number,
        gas_limit=old.gas_limit,
        gas_used=old.gas_used,
        timestamp=old.timestamp,
        extra_data=old.extra_data,
        base_fee_per_gas=old.base_fee_per_gas,
        block_hash=old.block_hash,
        transactions_root=old.transactions_root,
        withdrawals_root=old.withdrawals_root,
        blob_gas_used=old.blob_gas_used,
        excess_blob_gas=old.excess_blob_gas,
        # deposit_receipts_root / withdrawal_requests_root zeroed
    )

    scans = _registry_scans(state)
    if scans is None:
        exit_epochs = [
            v.exit_epoch
            for v in state.validators
            if v.exit_epoch != FAR_FUTURE_EPOCH
        ]
        earliest_exit_epoch = max(exit_epochs, default=epoch) + 1
    else:
        latest_exit, pre_activation, compounding = scans
        earliest_exit_epoch = (
            epoch if latest_exit is None else latest_exit
        ) + 1

    post = ns.BeaconState(
        genesis_time=state.genesis_time,
        genesis_validators_root=state.genesis_validators_root,
        slot=state.slot,
        fork=Fork(
            previous_version=state.fork.current_version,
            current_version=context.electra_fork_version,
            epoch=epoch,
        ),
        latest_block_header=state.latest_block_header.copy(),
        block_roots=list(state.block_roots),
        state_roots=list(state.state_roots),
        historical_roots=list(state.historical_roots),
        eth1_data=state.eth1_data.copy(),
        eth1_data_votes=[v.copy() for v in state.eth1_data_votes],
        eth1_deposit_index=state.eth1_deposit_index,
        validators=[v.copy() for v in state.validators],
        balances=list(state.balances),
        randao_mixes=list(state.randao_mixes),
        slashings=list(state.slashings),
        previous_epoch_participation=list(state.previous_epoch_participation),
        current_epoch_participation=list(state.current_epoch_participation),
        justification_bits=list(state.justification_bits),
        previous_justified_checkpoint=state.previous_justified_checkpoint.copy(),
        current_justified_checkpoint=state.current_justified_checkpoint.copy(),
        finalized_checkpoint=state.finalized_checkpoint.copy(),
        inactivity_scores=list(state.inactivity_scores),
        current_sync_committee=state.current_sync_committee.copy(),
        next_sync_committee=state.next_sync_committee.copy(),
        latest_execution_payload_header=header,
        next_withdrawal_index=state.next_withdrawal_index,
        next_withdrawal_validator_index=state.next_withdrawal_validator_index,
        historical_summaries=[s.copy() for s in state.historical_summaries],
        deposit_receipts_start_index=UNSET_DEPOSIT_RECEIPTS_START_INDEX,
        earliest_exit_epoch=earliest_exit_epoch,
        earliest_consolidation_epoch=compute_activation_exit_epoch(epoch, context),
    )
    post.exit_balance_to_consume = h.get_activation_exit_churn_limit(post, context)
    post.consolidation_balance_to_consume = h.get_consolidation_churn_limit(
        post, context
    )

    # queue entire balances of not-yet-activated validators (sorted by
    # eligibility epoch then index), then compounding excess balances
    if scans is None:
        pre_activation = [
            index
            for _, index in sorted(
                (v.activation_eligibility_epoch, index)
                for index, v in enumerate(post.validators)
                if v.activation_epoch == FAR_FUTURE_EPOCH
            )
        ]
        compounding = [
            index
            for index, validator in enumerate(post.validators)
            if h.has_compounding_withdrawal_credential(validator)
        ]
    for index in pre_activation:
        h.queue_entire_balance_and_reset_validator(post, index)
    for index in compounding:
        h.queue_excess_active_balance(post, index, context)

    return post


def _registry_scans(state):
    """(latest exit epoch or None, pre-activation indices in
    (eligibility, index) order, compounding indices ascending) from the
    pre-state's registry columns; None when the columns decline. The
    post-state's validators are copies of these rows, and neither queue
    changes an activation epoch or a credential, so the scans of the
    pre-state are the scans of the post-state."""
    cols = ops_vector.columns_for(state)
    vc = cols.validator_columns(state) if cols is not None else None
    if vc is None:
        return None
    import numpy as np

    far = np.uint64(FAR_FUTURE_EPOCH)
    exits = vc["exit_epoch"]
    real = exits[exits != far]
    latest_exit = int(real.max()) if real.size else None
    pending = np.nonzero(vc["activation_epoch"] == far)[0]
    order = np.argsort(
        vc["activation_eligibility_epoch"][pending], kind="stable"
    )
    compounding = np.nonzero(vc["withdrawal_prefix"] == np.uint8(0x02))[0]
    return latest_exit, pending[order].tolist(), compounding.tolist()
