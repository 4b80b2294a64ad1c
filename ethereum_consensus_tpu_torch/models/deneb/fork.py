"""capella → deneb state upgrade.

Reference parity: ethereum-consensus/src/deneb/fork.rs:7 — payload header
gains zeroed blob_gas_used / excess_blob_gas. Ported from
ethereum_consensus_tpu/models/deneb/fork.py.
"""

from __future__ import annotations

from ..altair.helpers import get_current_epoch
from ..phase0.containers import Fork
from .containers import build

__all__ = ["upgrade_to_deneb"]


def upgrade_to_deneb(state, context):
    """(fork.rs:7)"""
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
        # blob_gas_used / excess_blob_gas zeroed
    )
    return ns.BeaconState(
        genesis_time=state.genesis_time,
        genesis_validators_root=state.genesis_validators_root,
        slot=state.slot,
        fork=Fork(
            previous_version=state.fork.current_version,
            current_version=context.deneb_fork_version,
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
    )
