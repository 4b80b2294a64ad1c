"""altair genesis.

Reference parity: ethereum-consensus/src/altair/genesis.rs — same shape as
phase0 but with the altair fork version and sync committees initialized
after bootstrap deposits.

Ported from ethereum_consensus_tpu/models/altair/genesis.py, on the shared
skeleton of ``models/genesis_common.py`` as the later forks' are.
"""

from __future__ import annotations

from ..genesis_common import initialize_state_generic
from ..phase0.genesis import is_valid_genesis_state  # noqa: F401 — unchanged
from . import helpers as h
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
    """(genesis.rs:12) — ``execution_payload_header`` is accepted and
    ignored: altair has no payload."""
    return initialize_state_generic(
        build(context.preset),
        context.altair_fork_version,
        eth1_block_hash,
        eth1_timestamp,
        deposits,
        context,
        process_deposit,
        get_next_sync_committee_fn=h.get_next_sync_committee,
    )


def get_genesis_block(state, context):
    """(phase0 genesis.rs:137 shape with the altair block type)"""
    ns = build(context.preset)
    return ns.BeaconBlock(state_root=type(state).hash_tree_root(state))
