"""electra genesis.

Reference parity: ethereum-consensus/src/electra/genesis.rs — deneb shape at
the electra fork version with the deposit-receipts start index unset.

Ported from ethereum_consensus_tpu/models/electra/genesis.py.
"""

from __future__ import annotations

from ...primitives import GENESIS_EPOCH, UNSET_DEPOSIT_RECEIPTS_START_INDEX
from ..altair.helpers import get_next_sync_committee
from ..genesis_common import initialize_state_generic
from ..phase0.genesis import is_valid_genesis_state  # noqa: F401 — unchanged
from .block_processing import process_deposit
from .containers import build
from .epoch_processing import process_pending_balance_deposits

__all__ = [
    "initialize_beacon_state_from_eth1",
    "is_valid_genesis_state",
    "get_genesis_block",
]


def initialize_beacon_state_from_eth1(
    eth1_block_hash: bytes,
    eth1_timestamp: int,
    deposits: list,
    context,
    execution_payload_header=None,
):
    ns = build(context.preset)
    state = initialize_state_generic(
        ns,
        context.electra_fork_version,
        eth1_block_hash,
        eth1_timestamp,
        deposits,
        context,
        process_deposit,
        # sync committees set after pending deposits settle (need effective
        # balances)
        get_next_sync_committee_fn=None,
        execution_payload_header=execution_payload_header,
    )
    state.deposit_receipts_start_index = UNSET_DEPOSIT_RECEIPTS_START_INDEX

    # electra deposits queue pending balances with zero effective balance;
    # settle them so bootstrap validators activate at genesis
    state.deposit_balance_to_consume = sum(
        d.amount for d in state.pending_balance_deposits
    )
    process_pending_balance_deposits(state, context)
    for validator, balance in zip(state.validators, state.balances):
        validator.effective_balance = min(
            balance - balance % context.EFFECTIVE_BALANCE_INCREMENT,
            context.MIN_ACTIVATION_BALANCE,
        )
        if validator.effective_balance >= context.MIN_ACTIVATION_BALANCE:
            validator.activation_eligibility_epoch = GENESIS_EPOCH
            validator.activation_epoch = GENESIS_EPOCH
    # direct current-epoch activation is unique to genesis: drop the
    # (future-epoch-mutation-invariant) active-set cache it violates
    state.__dict__.pop("_active_idx_cache", None)
    state.__dict__.pop("_total_active_balance_cache", None)

    state.genesis_validators_root = type(state).__ssz_fields__[
        "validators"
    ].hash_tree_root(state.validators)

    sync_committee = get_next_sync_committee(state, context)
    state.current_sync_committee = sync_committee
    state.next_sync_committee = sync_committee.copy()
    return state


def get_genesis_block(state, context):
    ns = build(context.preset)
    return ns.BeaconBlock(state_root=type(state).hash_tree_root(state))
