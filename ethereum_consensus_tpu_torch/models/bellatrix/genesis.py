"""bellatrix genesis.

Reference parity: ethereum-consensus/src/bellatrix/genesis.rs:11 — adds the
optional genesis ExecutionPayloadHeader (post-merge genesis, devnets).

Ported from ethereum_consensus_tpu/models/bellatrix/genesis.py.
"""

from __future__ import annotations

from ..altair.helpers import get_next_sync_committee
from ..genesis_common import initialize_state_generic
from ..phase0.genesis import is_valid_genesis_state  # noqa: F401 — unchanged
from .block_processing import process_deposit
from .containers import build

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
    """(genesis.rs:11)"""
    ns = build(context.preset)
    return initialize_state_generic(
        ns,
        context.bellatrix_fork_version,
        eth1_block_hash,
        eth1_timestamp,
        deposits,
        context,
        process_deposit,
        get_next_sync_committee_fn=get_next_sync_committee,
        execution_payload_header=execution_payload_header,
    )


def get_genesis_block(state, context):
    ns = build(context.preset)
    return ns.BeaconBlock(state_root=type(state).hash_tree_root(state))
