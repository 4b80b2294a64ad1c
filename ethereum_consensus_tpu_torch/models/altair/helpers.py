"""altair spec helpers: participation flags, sync committees, flag deltas,
altair base reward and slashing.

Reference parity: ethereum-consensus/src/altair/helpers.rs — add_flag/
has_flag:27-33, get_next_sync_committee{_indices}:39,93,
get_base_reward_per_increment, get_unslashed_participating_indices:153,
get_attestation_participation_flag_indices:205, get_flag_index_deltas:265,
get_inactivity_penalty_deltas, slash_validator (altair quotients); altair
get_base_reward from epoch_processing.rs:22.

Unchanged phase0 helpers are re-exported so altair callers use one module.
Ported from ethereum_consensus_tpu/models/altair/helpers.py.
"""

from __future__ import annotations

from ... import _device_flags
from ...crypto import bls
from ...domains import DomainType
from ...error import StateTransitionError, checked_add
from ..phase0.helpers import (  # noqa: F401 — fork-diff re-exports
    compute_activation_exit_epoch,
    compute_committee,
    compute_domain,
    compute_epoch_at_slot,
    compute_fork_data_root,
    compute_fork_digest,
    compute_proposer_index,
    compute_shuffled_index,
    shuffled_active_array,
    compute_start_slot_at_epoch,
    decrease_balance,
    get_active_validator_indices,
    get_attesting_indices,
    get_beacon_committee,
    get_beacon_proposer_index,
    get_block_root,
    get_block_root_at_slot,
    get_committee_count_at_slot,
    get_committee_count_per_slot,
    get_current_epoch,
    get_domain,
    get_indexed_attestation,
    get_previous_epoch,
    get_randao_mix,
    get_seed,
    get_total_active_balance,
    get_total_balance,
    get_validator_churn_limit,
    increase_balance,
    initiate_validator_exit,
    integer_squareroot,
    is_active_validator,
    is_eligible_for_activation,
    is_eligible_for_activation_queue,
    is_slashable_attestation_data,
    is_slashable_validator,
    is_valid_indexed_attestation,
    verify_block_signature,
    xor,
    _sha256,
)
from ..phase0.epoch_processing import (  # noqa: F401
    get_eligible_validator_indices,
    get_finality_delay,
    is_in_inactivity_leak,
)
from ...error import InvalidAttestation
from .constants import (
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
    WEIGHT_DENOMINATOR,
)

__all__ = [
    "add_flag",
    "has_flag",
    "get_next_sync_committee_indices",
    "get_next_sync_committee",
    "get_base_reward_per_increment",
    "get_base_reward",
    "get_unslashed_participating_indices",
    "get_attestation_participation_flag_indices",
    "get_flag_index_deltas",
    "get_inactivity_penalty_deltas",
    "slash_validator",
]


def add_flag(flags: int, flag_index: int) -> int:
    """(helpers.rs:27)"""
    return flags | (1 << flag_index)


def has_flag(flags: int, flag_index: int) -> bool:
    """(helpers.rs:33)"""
    flag = 1 << flag_index
    return flags & flag == flag


def get_next_sync_committee_indices(state, context) -> list[int]:
    """Effective-balance-weighted sampling, duplicates allowed
    (helpers.rs:39)."""
    epoch = get_current_epoch(state, context) + 1
    max_random_byte = 255
    active = get_active_validator_indices(state, epoch)
    if not active:
        raise StateTransitionError("no active validators for sync committee")
    count = len(active)
    seed = get_seed(state, epoch, DomainType.SYNC_COMMITTEE, context)
    indices: list[int] = []
    i = 0
    while len(indices) < context.SYNC_COMMITTEE_SIZE:
        shuffled = compute_shuffled_index(i % count, count, seed, context)
        candidate = active[shuffled]
        random_byte = _sha256(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        effective = state.validators[candidate].effective_balance
        if effective * max_random_byte >= context.MAX_EFFECTIVE_BALANCE * random_byte:
            indices.append(candidate)
        i += 1
    return indices


def get_next_sync_committee(state, context):
    """(helpers.rs:93)"""
    from .containers import build

    ns = build(context.preset)
    indices = get_next_sync_committee_indices(state, context)
    public_keys = [bytes(state.validators[i].public_key) for i in indices]
    aggregate = bls.eth_aggregate_public_keys(
        [bls.PublicKey.from_bytes(pk) for pk in public_keys]
    )
    return ns.SyncCommittee(
        public_keys=public_keys, aggregate_public_key=aggregate.to_bytes()
    )


def get_base_reward_per_increment(state, context) -> int:
    """(helpers.rs get_base_reward_per_increment)"""
    return (
        context.EFFECTIVE_BALANCE_INCREMENT
        * context.BASE_REWARD_FACTOR
        // integer_squareroot(get_total_active_balance(state, context))
    )


def get_base_reward(state, index: int, context) -> int:
    """altair base reward (epoch_processing.rs:22)."""
    increments = (
        state.validators[index].effective_balance
        // context.EFFECTIVE_BALANCE_INCREMENT
    )
    return increments * get_base_reward_per_increment(state, context)


def get_unslashed_participating_indices(
    state, flag_index: int, epoch: int, context
) -> set[int]:
    """(helpers.rs:153)"""
    previous_epoch = get_previous_epoch(state, context)
    current_epoch = get_current_epoch(state, context)
    if epoch == current_epoch:
        participation = state.current_epoch_participation
    elif epoch == previous_epoch:
        participation = state.previous_epoch_participation
    else:
        raise StateTransitionError(
            f"epoch {epoch} is neither previous ({previous_epoch}) nor "
            f"current ({current_epoch})"
        )
    return {
        i
        for i in get_active_validator_indices(state, epoch)
        if has_flag(participation[i], flag_index) and not state.validators[i].slashed
    }


def get_attestation_participation_flag_indices(
    state, data, inclusion_delay: int, context
) -> list[int]:
    """(helpers.rs:205)"""
    if data.target.epoch == get_current_epoch(state, context):
        justified_checkpoint = state.current_justified_checkpoint
    else:
        justified_checkpoint = state.previous_justified_checkpoint

    is_matching_source = data.source == justified_checkpoint
    if not is_matching_source:
        raise InvalidAttestation(
            f"attestation source {data.source} does not match justified "
            f"checkpoint {justified_checkpoint}"
        )
    is_matching_target = is_matching_source and (
        data.target.root == get_block_root(state, data.target.epoch, context)
    )
    is_matching_head = is_matching_target and (
        data.beacon_block_root == get_block_root_at_slot(state, data.slot)
    )

    flags = []
    if is_matching_source and inclusion_delay <= integer_squareroot(
        context.SLOTS_PER_EPOCH
    ):
        flags.append(TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target and inclusion_delay <= context.SLOTS_PER_EPOCH:
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == context.MIN_ATTESTATION_INCLUSION_DELAY:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


def get_flag_index_deltas(state, flag_index: int, context):
    """(helpers.rs:265) — whole-registry sweep; routed to the CUDA kernel
    (ops/sweeps.py flag_deltas_device, bit-identical) above the installed
    threshold."""
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
        rewards, penalties = _sweeps.flag_deltas_device(
            packed,
            flag_index,
            get_total_active_balance(state, context),
            context,
            is_in_inactivity_leak(state, context),
            device=_device_flags.DEVICE,
        )
        return [int(r) for r in rewards], [int(p) for p in penalties]
    rewards = [0] * n
    penalties = [0] * n
    previous_epoch = get_previous_epoch(state, context)
    unslashed = get_unslashed_participating_indices(
        state, flag_index, previous_epoch, context
    )
    weight = PARTICIPATION_FLAG_WEIGHTS[flag_index]
    unslashed_balance = get_total_balance(state, unslashed, context)
    unslashed_increments = unslashed_balance // context.EFFECTIVE_BALANCE_INCREMENT
    active_increments = (
        get_total_active_balance(state, context)
        // context.EFFECTIVE_BALANCE_INCREMENT
    )
    not_leaking = not is_in_inactivity_leak(state, context)
    # hoist the O(n) total-active-balance out of the per-validator loop
    brpi = get_base_reward_per_increment(state, context)
    increment = context.EFFECTIVE_BALANCE_INCREMENT
    for index in get_eligible_validator_indices(state, context):
        base_reward = (
            state.validators[index].effective_balance // increment
        ) * brpi
        if index in unslashed:
            if not_leaking:
                reward_numerator = base_reward * weight * unslashed_increments
                rewards[index] += reward_numerator // (
                    active_increments * WEIGHT_DENOMINATOR
                )
        elif flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties[index] += base_reward * weight // WEIGHT_DENOMINATOR
    return rewards, penalties


def get_inactivity_penalty_deltas(state, context):
    """(helpers.rs get_inactivity_penalty_deltas, altair quotient) — the
    CUDA kernel above threshold (ops/sweeps.py inactivity_penalties_device)."""
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
            packed, context, context.INACTIVITY_PENALTY_QUOTIENT_ALTAIR,
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
                * context.INACTIVITY_PENALTY_QUOTIENT_ALTAIR
            )
            penalties[i] += penalty_numerator // penalty_denominator
    return rewards, penalties


def slash_validator(state, slashed_index: int, whistleblower_index, context) -> None:
    """altair slashing: halved min-slashing quotient, proposer gets the
    PROPOSER_WEIGHT share of the whistleblower reward (helpers.rs
    slash_validator; spec semantics — multiply before divide, unlike the
    reference's integer `PROPOSER_WEIGHT / WEIGHT_DENOMINATOR` which rounds
    the scaling factor to zero and is unobservable in spec vectors because
    whistleblower == proposer there)."""
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
        validator.effective_balance // context.MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR,
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
