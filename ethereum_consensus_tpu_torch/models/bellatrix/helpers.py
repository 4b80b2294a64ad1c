"""bellatrix spec helpers: merge predicates + bellatrix-quotient penalties.

Reference parity: ethereum-consensus/src/bellatrix/helpers.rs —
get_inactivity_penalty_deltas (bellatrix quotient), slash_validator
(bellatrix quotient), is_merge_transition_complete:115,
is_merge_transition_block:143, is_execution_enabled:193,
compute_timestamp_at_slot:243. Ported from
ethereum_consensus_tpu/models/bellatrix/helpers.py.
"""

from __future__ import annotations

from ... import _device_flags
from ...error import checked_add
from ...primitives import GENESIS_SLOT
from ..altair.constants import (
    PROPOSER_WEIGHT,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
)
from ..altair import helpers as _altair_helpers
from ..altair.helpers import (
    decrease_balance,
    get_beacon_proposer_index,
    get_current_epoch,
    get_eligible_validator_indices,
    get_previous_epoch,
    get_unslashed_participating_indices,
    increase_balance,
    initiate_validator_exit,
)
from .._diff import inherit

__all__ = [
    "get_inactivity_penalty_deltas",
    "slash_validator",
    "is_merge_transition_complete",
    "is_merge_transition_block",
    "is_execution_enabled",
    "compute_timestamp_at_slot",
]


def get_inactivity_penalty_deltas(state, context):
    """(helpers.rs:14) — INACTIVITY_PENALTY_QUOTIENT_BELLATRIX. The CUDA
    kernel above threshold (ops/sweeps.py inactivity_penalties_device)."""
    n = len(state.validators)
    if _device_flags.sweeps_enabled(n):
        from ...ops import sweeps as _sweeps

        prev_epoch = get_previous_epoch(state, context)
        packed = _sweeps.pack_registry(
            state, prev_epoch,
            use_current_participation=(
                prev_epoch == get_current_epoch(state, context)
            ),
        )
        penalties = _sweeps.inactivity_penalties_device(
            packed, context, context.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX,
            device=_device_flags.DEVICE,
        )
        return [0] * n, [int(p) for p in penalties]
    rewards = [0] * n
    penalties = [0] * n
    previous_epoch = get_previous_epoch(state, context)
    matching_target = get_unslashed_participating_indices(
        state, TIMELY_TARGET_FLAG_INDEX, previous_epoch, context
    )
    for i in get_eligible_validator_indices(state, context):
        if i not in matching_target:
            penalty_numerator = (
                state.validators[i].effective_balance * state.inactivity_scores[i]
            )
            penalty_denominator = (
                context.inactivity_score_bias
                * context.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX
            )
            penalties[i] += penalty_numerator // penalty_denominator
    return rewards, penalties


def slash_validator(state, slashed_index: int, whistleblower_index, context) -> None:
    """(helpers.rs slash_validator) — MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX,
    spec proposer-reward split (see altair.helpers.slash_validator note)."""
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
        validator.effective_balance
        // context.MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX,
    )

    proposer_index = get_beacon_proposer_index(state, context)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    whistleblower_reward = (
        validator.effective_balance // context.WHISTLEBLOWER_REWARD_QUOTIENT
    )
    proposer_reward = whistleblower_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower_index, whistleblower_reward - proposer_reward)


def is_merge_transition_complete(state) -> bool:
    """(helpers.rs:115)"""
    header_cls = type(state).__ssz_fields__["latest_execution_payload_header"]
    return state.latest_execution_payload_header != header_cls()


def is_merge_transition_block(state, body) -> bool:
    """(helpers.rs:143)"""
    payload_cls = type(body).__ssz_fields__["execution_payload"]
    return (
        not is_merge_transition_complete(state)
        and body.execution_payload != payload_cls()
    )


def is_execution_enabled(state, body) -> bool:
    """(helpers.rs:193)"""
    return is_merge_transition_block(state, body) or is_merge_transition_complete(
        state
    )


def compute_timestamp_at_slot(state, slot: int, context) -> int:
    """(helpers.rs:243)"""
    slots_since_genesis = slot - GENESIS_SLOT
    return state.genesis_time + slots_since_genesis * context.seconds_per_slot


inherit(globals(), _altair_helpers)
