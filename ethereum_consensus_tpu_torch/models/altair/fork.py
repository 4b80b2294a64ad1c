"""phase0 → altair state upgrade.

Reference parity: ethereum-consensus/src/altair/fork.rs —
translate_participation (pending attestations → participation flags) and
upgrade_to_altair:51. Ported from ethereum_consensus_tpu/models/altair/fork.py.
"""

from __future__ import annotations

from ..phase0.containers import Fork
from . import helpers as h
from .containers import build

__all__ = ["upgrade_to_altair", "translate_participation"]


def translate_participation(post_state, pending_attestations, context) -> None:
    """(fork.rs translate_participation)"""
    for attestation in pending_attestations:
        data = attestation.data
        participation_flag_indices = h.get_attestation_participation_flag_indices(
            post_state, data, attestation.inclusion_delay, context
        )
        indices = h.get_attesting_indices(
            post_state, data, attestation.aggregation_bits, context
        )
        for index in indices:
            for flag_index in participation_flag_indices:
                post_state.previous_epoch_participation[index] = h.add_flag(
                    post_state.previous_epoch_participation[index], flag_index
                )


def upgrade_to_altair(state, context):
    """(fork.rs:51)"""
    ns = build(context.preset)
    epoch = h.get_current_epoch(state, context)
    n = len(state.validators)
    post_state = ns.BeaconState(
        genesis_time=state.genesis_time,
        genesis_validators_root=state.genesis_validators_root,
        slot=state.slot,
        fork=Fork(
            previous_version=state.fork.current_version,
            current_version=context.altair_fork_version,
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
        previous_epoch_participation=[0] * n,
        current_epoch_participation=[0] * n,
        justification_bits=list(state.justification_bits),
        previous_justified_checkpoint=state.previous_justified_checkpoint.copy(),
        current_justified_checkpoint=state.current_justified_checkpoint.copy(),
        finalized_checkpoint=state.finalized_checkpoint.copy(),
        inactivity_scores=[0] * n,
    )

    translate_participation(
        post_state, state.previous_epoch_attestations, context
    )

    sync_committee = h.get_next_sync_committee(post_state, context)
    post_state.current_sync_committee = sync_committee
    post_state.next_sync_committee = sync_committee.copy()
    return post_state
