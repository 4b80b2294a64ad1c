"""phase0 genesis.

Reference parity: ethereum-consensus/src/phase0/genesis.rs —
initialize_beacon_state_from_eth1:15, is_valid_genesis_state:107,
get_genesis_block:137.

Ported from ethereum_consensus_tpu/models/phase0/genesis.py.
"""

from __future__ import annotations

from ...primitives import GENESIS_EPOCH
from . import helpers as h
from .block_processing import process_deposit
from .containers import BeaconBlockHeader, Eth1Data, Fork, build

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
    """(genesis.rs:15)"""
    ns = build(context.preset)
    fork = Fork(
        previous_version=context.genesis_fork_version,
        current_version=context.genesis_fork_version,
        epoch=GENESIS_EPOCH,
    )
    state = ns.BeaconState(
        genesis_time=eth1_timestamp + context.genesis_delay,
        fork=fork,
        eth1_data=Eth1Data(
            block_hash=eth1_block_hash, deposit_count=len(deposits)
        ),
        latest_block_header=BeaconBlockHeader(
            body_root=ns.BeaconBlockBody.hash_tree_root(ns.BeaconBlockBody())
        ),
        randao_mixes=[eth1_block_hash] * context.EPOCHS_PER_HISTORICAL_VECTOR,
    )

    # the shared genesis fold (incremental deposit roots + one batched
    # RLC multi-pairing for every deposit signature), with one shared
    # pubkey index instead of a per-deposit O(n) registry scan
    from ..genesis_common import fold_genesis_deposits

    pubkey_index = {
        bytes(v.public_key): i for i, v in enumerate(state.validators)
    }
    fold_genesis_deposits(
        state,
        deposits,
        context,
        lambda st, dep, ctx, signature_valid=None: process_deposit(
            st, dep, ctx, pubkey_index=pubkey_index,
            signature_valid=signature_valid,
        ),
    )

    # activate bootstrap validators
    for index, validator in enumerate(state.validators):
        balance = state.balances[index]
        validator.effective_balance = min(
            balance - balance % context.EFFECTIVE_BALANCE_INCREMENT,
            context.MAX_EFFECTIVE_BALANCE,
        )
        if validator.effective_balance == context.MAX_EFFECTIVE_BALANCE:
            validator.activation_eligibility_epoch = GENESIS_EPOCH
            validator.activation_epoch = GENESIS_EPOCH
    # direct current-epoch activation is unique to genesis: drop the
    # (future-epoch-mutation-invariant) active-set cache it violates
    state.__dict__.pop("_active_idx_cache", None)
    state.__dict__.pop("_total_active_balance_cache", None)

    state.genesis_validators_root = type(state).__ssz_fields__[
        "validators"
    ].hash_tree_root(state.validators)
    return state


def is_valid_genesis_state(state, context) -> bool:
    """(genesis.rs:107)"""
    if state.genesis_time < context.min_genesis_time:
        return False
    active = h.get_active_validator_indices(state, GENESIS_EPOCH)
    return len(active) >= context.min_genesis_active_validator_count


def get_genesis_block(state, context):
    """(genesis.rs:137)"""
    ns = build(context.preset)
    return ns.BeaconBlock(
        state_root=type(state).hash_tree_root(state),
    )
