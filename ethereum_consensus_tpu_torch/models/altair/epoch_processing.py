"""altair epoch processing.

Reference parity: ethereum-consensus/src/altair/epoch_processing.rs —
participation-flag justification (:51), process_inactivity_updates:104,
flag-delta rewards (:160), process_participation_flag_updates:201,
altair process_slashings (:240), process_sync_committee_updates:273,
altair process_epoch:305. Ported from
ethereum_consensus_tpu/models/altair/epoch_processing.py.

Three routes, as in the reference: at 2^12 validators and above the
columnar engine (models/epoch_vector.py) runs the whole pass over numpy
registry columns; with ``ops.install()`` routing the sweeps to the card it
stays columnar and runs inactivity and rewards as one launch of the fused
epoch kernel (``ops/epoch.py``); with the engine off
(``ECT_EPOCH_VECTOR=off``) this literal stage list runs, and with the
sweeps installed its inactivity update, flag deltas and inactivity
penalties go through the CUDA kernels of ``ops/sweeps.py``.
"""

from __future__ import annotations

from ... import _device_flags
from ...primitives import GENESIS_EPOCH
from ..phase0.epoch_processing import (  # noqa: F401 — fork-diff re-exports
    process_effective_balance_updates,
    process_eth1_data_reset,
    process_historical_roots_update,
    process_randao_mixes_reset,
    process_registry_updates,
    process_slashings_reset,
    weigh_justification_and_finalization,
)

# phase0's epoch_processing exported these too; altair relocated them to
# helpers (get_base_reward with the altair formula, the rest fork-neutral
# pass-throughs). Re-exported so the module surface chains without a hole
# (speclint forkdiff/missing-reexport).
from .helpers import (  # noqa: F401 — fork-diff re-exports
    get_base_reward,
    get_eligible_validator_indices,
    get_finality_delay,
    is_in_inactivity_leak,
)
from . import helpers as h
from .constants import PARTICIPATION_FLAG_WEIGHTS, TIMELY_TARGET_FLAG_INDEX

__all__ = [
    "process_justification_and_finalization",
    "process_inactivity_updates",
    "process_rewards_and_penalties",
    "process_participation_flag_updates",
    "process_slashings",
    "process_sync_committee_updates",
    "process_epoch",
]


# below this registry size the numpy column extraction costs more than
# the Python loops it replaces (mirrors phase0's threshold)
_VECTORIZED_DELTAS_MIN_N = 1 << 12


def _host_deltas_vectorized(state, context, hm, inactivity_quotient_name):
    """numpy host twin of the altair-family delta sweeps (flag deltas x3 +
    inactivity penalties) over validator columns — identical integer
    semantics to the literal helpers (which stay the oracle, the
    small-registry path, and the spec-test rewards surface). Products
    stay inside uint64: base_reward < 2^26, unslashed increments < 2^23,
    weights <= 64 (an effective_balance x inactivity_score product that
    could reach 2^63 falls back per-index)."""
    import numpy as np

    from ..ops_vector import pack_registry_cached
    from .constants import TIMELY_HEAD_FLAG_INDEX, WEIGHT_DENOMINATOR

    n = len(state.validators)
    prev = hm.get_previous_epoch(state, context)
    cur = hm.get_current_epoch(state, context)
    # delta-refreshed registry-column cache (models/ops_vector.py); the
    # literal fromiter packing is its internal fallback
    packed = pack_registry_cached(
        state, prev, use_current_participation=(prev == cur)
    )
    eff = packed["effective_balance"]
    eligible = packed["eligible"]

    increment = int(context.EFFECTIVE_BALANCE_INCREMENT)
    brpi = np.uint64(hm.get_base_reward_per_increment(state, context))
    base_reward = (eff // np.uint64(increment)) * brpi
    active_increments = (
        int(hm.get_total_active_balance(state, context)) // increment
    )
    leaking = hm.is_in_inactivity_leak(state, context)
    denom_w = np.uint64(WEIGHT_DENOMINATOR)

    from ...ops.registry_columns import unslashed_flag_mask

    out = []
    target_unslashed = None
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        unslashed = unslashed_flag_mask(packed, flag_index)
        if flag_index == TIMELY_TARGET_FLAG_INDEX:
            target_unslashed = unslashed
        rewards = np.zeros(n, dtype=np.uint64)
        penalties = np.zeros(n, dtype=np.uint64)
        attesting = eligible & unslashed
        if not leaking:
            # get_total_balance floors at one increment
            unslashed_increments = (
                max(increment, int(eff[unslashed].sum())) // increment
            )
            rewards[attesting] = (
                base_reward[attesting]
                * np.uint64(weight)
                * np.uint64(unslashed_increments)
            ) // np.uint64(active_increments * WEIGHT_DENOMINATOR)
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            absent = eligible & ~unslashed
            penalties[absent] = (
                base_reward[absent] * np.uint64(weight) // denom_w
            )
        out.append((rewards, penalties))

    scores = packed["inactivity_scores"]
    missed = eligible & ~target_unslashed
    denominator = int(context.inactivity_score_bias) * int(
        getattr(context, inactivity_quotient_name)
    )
    penalties = np.zeros(n, dtype=np.uint64)
    if n == 0 or int(eff.max()) * int(scores.max()) < 2**64:
        penalties[missed] = (
            eff[missed] * scores[missed] // np.uint64(denominator)
        )
    else:  # pathological scores: exact per-index Python ints, clamped to
        # the u64 lane — a penalty at the clamp already saturates any
        # real balance to zero, so the applied result is unchanged
        u64_max = 2**64 - 1
        for i in np.nonzero(missed)[0]:
            penalties[i] = min(
                int(eff[i]) * int(scores[i]) // denominator, u64_max
            )
    out.append((np.zeros(n, dtype=np.uint64), penalties))
    return out


def _apply_deltas_vectorized(state, deltas) -> bool:
    """Apply each (rewards, penalties) PAIR in sequence over numpy columns,
    saturating at zero between pairs — summing first and clamping once
    diverges for a low-balance validator whose early-pair penalty
    saturates before a later-pair reward lands (spec order, and the
    literal loop). Returns False, with the state untouched, when an add
    would wrap u64. The reference applies the device route's deltas with
    the literal loop; the resulting state is the same."""
    import numpy as np

    from ...ssz.core import bulk_store

    n = len(state.balances)
    balances = np.fromiter(state.balances, dtype=np.uint64, count=n)
    orig_balances = balances
    for rewards, penalties in deltas:
        rewards = np.asarray(rewards, dtype=np.uint64)
        penalties = np.asarray(penalties, dtype=np.uint64)
        raised = balances + rewards
        if bool((raised < balances).any()):
            return False
        balances = np.where(raised >= penalties, raised - penalties, 0)
    # dirty-range bulk write (one C-speed splice instead of 8n
    # __setitem__ calls): only the groups whose balances changed
    # re-merkleize on the next state root
    bulk_store(
        state.balances,
        balances.tolist(),
        np.nonzero(balances != orig_balances)[0],
    )
    return True


def process_justification_and_finalization(state, context) -> None:
    """(epoch_processing.rs:51) — target balances from participation flags."""
    current_epoch = h.get_current_epoch(state, context)
    if current_epoch <= GENESIS_EPOCH + 1:
        return
    previous_indices = h.get_unslashed_participating_indices(
        state, TIMELY_TARGET_FLAG_INDEX, h.get_previous_epoch(state, context), context
    )
    current_indices = h.get_unslashed_participating_indices(
        state, TIMELY_TARGET_FLAG_INDEX, current_epoch, context
    )
    total_active = h.get_total_active_balance(state, context)
    previous_target = h.get_total_balance(state, previous_indices, context)
    current_target = h.get_total_balance(state, current_indices, context)
    weigh_justification_and_finalization(
        state, total_active, previous_target, current_target, context
    )


def process_inactivity_updates(state, context) -> None:
    """(epoch_processing.rs:104) — whole-registry sweep; the CUDA kernel
    above threshold (ops/sweeps.py inactivity_updates_device)."""
    current_epoch = h.get_current_epoch(state, context)
    if current_epoch == GENESIS_EPOCH:
        return
    if _device_flags.sweeps_enabled(len(state.validators)):
        import numpy as np

        from ...ops import sweeps as _sweeps

        prev_epoch = h.get_previous_epoch(state, context)
        packed = _sweeps.pack_registry(
            state, prev_epoch,
            use_current_participation=(prev_epoch == current_epoch),
        )
        scores = _sweeps.inactivity_updates_device(
            packed, context, h.is_in_inactivity_leak(state, context),
            device=_device_flags.DEVICE,
        )
        from ...ssz.core import bulk_store

        # the reference stores every score; only the changed ones differ
        # from the list, so the bytes are the same
        bulk_store(
            state.inactivity_scores,
            scores.tolist(),
            np.nonzero(scores != packed["inactivity_scores"])[0],
        )
        return
    n = len(state.validators)
    prev_epoch = h.get_previous_epoch(state, context)
    if n >= _VECTORIZED_DELTAS_MIN_N:
        import numpy as np

        from ..ops_vector import pack_registry_cached

        # cached columns make the full pack ~free warm, so the scores
        # read rides the same pack (the overflow guard below still
        # routes pathological states to the literal loop)
        packed = pack_registry_cached(
            state, prev_epoch,
            use_current_participation=(prev_epoch == current_epoch),
        )
        scores = packed["inactivity_scores"]
        bias = int(context.inactivity_score_bias)
        if int(scores.max()) < 2**64 - bias:
            from ...ops.registry_columns import unslashed_flag_mask

            participating = unslashed_flag_mask(
                packed, TIMELY_TARGET_FLAG_INDEX
            )
            eligible = packed["eligible"]
            new = scores.copy()
            hit = eligible & participating
            new[hit] -= np.minimum(np.uint64(1), new[hit])
            miss = eligible & ~participating
            new[miss] += np.uint64(bias)
            if not h.is_in_inactivity_leak(state, context):
                new[eligible] -= np.minimum(
                    np.uint64(int(context.inactivity_score_recovery_rate)),
                    new[eligible],
                )
            from ...ssz.core import bulk_store

            # dirty-range bulk write (one C-speed splice instead of up to
            # 2n setitems): only the groups whose scores changed
            # re-merkleize on the next state root
            bulk_store(
                state.inactivity_scores,
                new.tolist(),
                np.nonzero(new != scores)[0],
            )
            return
        # pathological near-2^64 scores: exact literal loop below
    eligible = h.get_eligible_validator_indices(state, context)
    unslashed_participating = h.get_unslashed_participating_indices(
        state, TIMELY_TARGET_FLAG_INDEX, prev_epoch, context
    )
    not_leaking = not h.is_in_inactivity_leak(state, context)
    for index in eligible:
        if index in unslashed_participating:
            state.inactivity_scores[index] -= min(1, state.inactivity_scores[index])
        else:
            state.inactivity_scores[index] += context.inactivity_score_bias
        if not_leaking:
            state.inactivity_scores[index] -= min(
                context.inactivity_score_recovery_rate,
                state.inactivity_scores[index],
            )


def process_rewards_and_penalties(
    state,
    context,
    helpers=None,
    inactivity_quotient_name="INACTIVITY_PENALTY_QUOTIENT_ALTAIR",
) -> None:
    """(epoch_processing.rs:160) — flag deltas + inactivity penalties.

    Device path packs the registry ONCE and reuses it for all four delta
    sweeps (the registry fields the sweeps read don't change until the
    deltas are applied below). ``helpers`` / ``inactivity_quotient_name``
    let later forks reuse this body with their helpers module and quotient
    (bellatrix+)."""
    hm = helpers or h
    current_epoch = hm.get_current_epoch(state, context)
    if current_epoch == GENESIS_EPOCH:
        return
    n = len(state.validators)
    if _device_flags.sweeps_enabled(n):
        from ...ops import sweeps as _sweeps

        prev_epoch = hm.get_previous_epoch(state, context)
        packed = _sweeps.pack_registry(
            state, prev_epoch,
            use_current_participation=(prev_epoch == current_epoch),
        )
        total_active = hm.get_total_active_balance(state, context)
        is_leaking = hm.is_in_inactivity_leak(state, context)
        device = _device_flags.DEVICE
        deltas = [
            _sweeps.flag_deltas_device(
                packed, flag_index, total_active, context, is_leaking,
                device=device,
            )
            for flag_index in range(len(PARTICIPATION_FLAG_WEIGHTS))
        ]
        deltas.append(
            ([0] * n, _sweeps.inactivity_penalties_device(
                packed, context, getattr(context, inactivity_quotient_name),
                device=device,
            ))
        )
    elif n >= _VECTORIZED_DELTAS_MIN_N:
        deltas = _host_deltas_vectorized(
            state, context, hm, inactivity_quotient_name
        )
    else:
        deltas = [
            hm.get_flag_index_deltas(state, flag_index, context)
            for flag_index in range(len(PARTICIPATION_FLAG_WEIGHTS))
        ]
        deltas.append(hm.get_inactivity_penalty_deltas(state, context))
    if n >= _VECTORIZED_DELTAS_MIN_N and _apply_deltas_vectorized(state, deltas):
        return
    # the literal application; after a u64 overflow of the vectorized one
    # (unreachable for real balances) it raises the structured checked_add
    # error at the exact index
    for rewards, penalties in deltas:
        for index in range(n):
            hm.increase_balance(state, index, int(rewards[index]))
            hm.decrease_balance(state, index, int(penalties[index]))


def process_participation_flag_updates(state, context) -> None:
    """(epoch_processing.rs:201)"""
    state.previous_epoch_participation = state.current_epoch_participation
    state.current_epoch_participation = [0] * len(state.validators)


def process_slashings(state, context) -> None:
    """(epoch_processing.rs:240) — altair proportional multiplier."""
    epoch = h.get_current_epoch(state, context)
    total_balance = h.get_total_active_balance(state, context)
    adjusted_total_slashing_balance = min(
        sum(state.slashings) * context.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR,
        total_balance,
    )
    increment = context.EFFECTIVE_BALANCE_INCREMENT
    for index, validator in enumerate(state.validators):
        if (
            validator.slashed
            and epoch + context.EPOCHS_PER_SLASHINGS_VECTOR // 2
            == validator.withdrawable_epoch
        ):
            penalty_numerator = (
                validator.effective_balance // increment * adjusted_total_slashing_balance
            )
            penalty = penalty_numerator // total_balance * increment
            h.decrease_balance(state, index, penalty)


def process_sync_committee_updates(state, context) -> None:
    """(epoch_processing.rs:273)"""
    next_epoch = h.get_current_epoch(state, context) + 1
    if next_epoch % context.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
        next_sync_committee = h.get_next_sync_committee(state, context)
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = next_sync_committee


def process_epoch(state, context) -> None:
    """(epoch_processing.rs:305) — columnar-primary pass above the
    engine threshold (models/epoch_vector.py); the literal stage list
    below is the fallback and the differential oracle."""
    from ..epoch_vector import process_epoch_columnar

    if process_epoch_columnar(state, context, "altair"):
        return
    process_justification_and_finalization(state, context)
    process_inactivity_updates(state, context)
    process_rewards_and_penalties(state, context)
    process_registry_updates(state, context)
    process_slashings(state, context)
    process_eth1_data_reset(state, context)
    process_effective_balance_updates(state, context)
    process_slashings_reset(state, context)
    process_randao_mixes_reset(state, context)
    process_historical_roots_update(state, context)
    process_participation_flag_updates(state, context)
    process_sync_committee_updates(state, context)
