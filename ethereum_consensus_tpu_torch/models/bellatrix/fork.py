"""altair → bellatrix state upgrade.

Reference parity: ethereum-consensus/src/bellatrix/fork.rs:7 — field-wise
copy with the bellatrix fork version and a default (empty) execution payload
header. Ported from ethereum_consensus_tpu/models/bellatrix/fork.py.
"""

from __future__ import annotations

from ..phase0.containers import Fork
from ..altair.helpers import get_current_epoch
from .containers import build

__all__ = ["upgrade_to_bellatrix"]


def upgrade_to_bellatrix(state, context):
    """(fork.rs:7)"""
    ns = build(context.preset)
    epoch = get_current_epoch(state, context)
    return ns.BeaconState(
        genesis_time=state.genesis_time,
        genesis_validators_root=state.genesis_validators_root,
        slot=state.slot,
        fork=Fork(
            previous_version=state.fork.current_version,
            current_version=context.bellatrix_fork_version,
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
        # latest_execution_payload_header left default (pre-merge)
    )
