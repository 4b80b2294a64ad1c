"""phase0 epoch processing.

Reference parity: ethereum-consensus/src/phase0/epoch_processing.rs (1,072
LoC): process_epoch:1039, justification/finalization :173, rewards &
penalties :217 (component deltas :762-995), registry updates :253,
slashings :321, final resets :366-525. Ported from
ethereum_consensus_tpu/models/phase0/epoch_processing.py.

Two routes, as in the reference: at 2^12 validators and above the
columnar engine (models/epoch_vector.py) runs the whole pass over numpy
registry columns; this literal stage list is its fallback and the
differential oracle. With ``ops.install()`` routing the sweeps to the
card, the engine declines (``device_sweeps``) and the literal stages run,
with the effective-balance hysteresis sweep on the CUDA kernel of
``ops/sweeps.py``.
"""

from __future__ import annotations

from ... import _device_flags
from ...error import StateTransitionError, saturating_sub
from ...primitives import GENESIS_EPOCH
from . import helpers as h
from .containers import Checkpoint

__all__ = [
    "process_epoch",
    "process_justification_and_finalization",
    "weigh_justification_and_finalization",
    "process_rewards_and_penalties",
    "process_registry_updates",
    "process_slashings",
    "process_eth1_data_reset",
    "process_effective_balance_updates",
    "process_slashings_reset",
    "process_randao_mixes_reset",
    "process_historical_roots_update",
    "process_participation_record_updates",
    "get_base_reward",
    "get_attestation_deltas",
    "get_matching_source_attestations",
    "get_matching_target_attestations",
    "get_matching_head_attestations",
    "get_unslashed_attesting_indices",
    "get_attesting_balance",
    "get_finality_delay",
    "is_in_inactivity_leak",
    "get_eligible_validator_indices",
]


# ---------------------------------------------------------------------------
# matching attestations
# ---------------------------------------------------------------------------


def get_matching_source_attestations(state, epoch: int, context):
    current = h.get_current_epoch(state, context)
    previous = h.get_previous_epoch(state, context)
    if epoch == current:
        return state.current_epoch_attestations
    if epoch == previous:
        return state.previous_epoch_attestations
    raise StateTransitionError(f"epoch {epoch} is not current or previous")


def get_matching_target_attestations(state, epoch: int, context):
    block_root = h.get_block_root(state, epoch, context)
    return [
        a
        for a in get_matching_source_attestations(state, epoch, context)
        if a.data.target.root == block_root
    ]


def get_matching_head_attestations(state, epoch: int, context):
    return [
        a
        for a in get_matching_target_attestations(state, epoch, context)
        if a.data.beacon_block_root == h.get_block_root_at_slot(state, a.data.slot)
    ]


def get_unslashed_attesting_indices(state, attestations, context) -> set[int]:
    out: set[int] = set()
    for a in attestations:
        out |= h.get_attesting_indices(state, a.data, a.aggregation_bits, context)
    return {i for i in out if not state.validators[i].slashed}


def get_attesting_balance(state, attestations, context) -> int:
    return h.get_total_balance(
        state, get_unslashed_attesting_indices(state, attestations, context), context
    )


# ---------------------------------------------------------------------------
# justification & finalization
# ---------------------------------------------------------------------------


def _masked_target_balances(state, context) -> "tuple[int, int] | None":
    """(previous, current) target attesting balances off the committee-
    mask kernel (models/committees.py) — one vectorized pass per epoch
    instead of a ``get_attesting_indices`` set walk per attestation.
    None = the kernel declined (counted); the caller runs
    the spec-helper walk, which stays the oracle."""
    from ..committees import pending_masks_for
    from ..ops_vector import pack_registry_cached

    previous_epoch = h.get_previous_epoch(state, context)
    current_epoch = h.get_current_epoch(state, context)
    prev_bundle = pending_masks_for(state, previous_epoch, context)
    if prev_bundle is None:
        return None
    cur_bundle = pending_masks_for(state, current_epoch, context)
    if cur_bundle is None:
        return None
    packed = pack_registry_cached(state, previous_epoch)
    eff = packed["effective_balance"]
    unslashed = ~packed["slashed"]
    increment = int(context.EFFECTIVE_BALANCE_INCREMENT)
    return (
        max(increment, int(eff[prev_bundle.target & unslashed].sum())),
        max(increment, int(eff[cur_bundle.target & unslashed].sum())),
    )


def process_justification_and_finalization(state, context) -> None:
    """(epoch_processing.rs:173)"""
    if h.get_current_epoch(state, context) <= GENESIS_EPOCH + 1:
        return
    total_active = h.get_total_active_balance(state, context)
    if len(state.validators) >= _VECTORIZED_REWARDS_MIN_N:
        balances = _masked_target_balances(state, context)
        if balances is not None:
            weigh_justification_and_finalization(
                state, total_active, balances[0], balances[1], context
            )
            return
    previous_epoch = h.get_previous_epoch(state, context)
    current_epoch = h.get_current_epoch(state, context)
    previous_attestations = get_matching_target_attestations(
        state, previous_epoch, context
    )
    current_attestations = get_matching_target_attestations(
        state, current_epoch, context
    )
    previous_target = get_attesting_balance(state, previous_attestations, context)
    current_target = get_attesting_balance(state, current_attestations, context)
    weigh_justification_and_finalization(
        state, total_active, previous_target, current_target, context
    )


def weigh_justification_and_finalization(
    state,
    total_active_balance: int,
    previous_epoch_target_balance: int,
    current_epoch_target_balance: int,
    context,
) -> None:
    previous_epoch = h.get_previous_epoch(state, context)
    current_epoch = h.get_current_epoch(state, context)
    old_previous_justified = state.previous_justified_checkpoint.copy()
    old_current_justified = state.current_justified_checkpoint.copy()

    # update justification
    state.previous_justified_checkpoint = state.current_justified_checkpoint.copy()
    bits = state.justification_bits
    state.justification_bits = [False] + bits[:-1]
    if previous_epoch_target_balance * 3 >= total_active_balance * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=previous_epoch,
            root=h.get_block_root(state, previous_epoch, context),
        )
        state.justification_bits[1] = True
    if current_epoch_target_balance * 3 >= total_active_balance * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=current_epoch,
            root=h.get_block_root(state, current_epoch, context),
        )
        state.justification_bits[0] = True

    # finalization (the four FFG rules)
    bits = state.justification_bits
    if all(bits[1:4]) and old_previous_justified.epoch + 3 == current_epoch:
        state.finalized_checkpoint = old_previous_justified.copy()
    if all(bits[1:3]) and old_previous_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_previous_justified.copy()
    if all(bits[0:3]) and old_current_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_current_justified.copy()
    if all(bits[0:2]) and old_current_justified.epoch + 1 == current_epoch:
        state.finalized_checkpoint = old_current_justified.copy()


# ---------------------------------------------------------------------------
# rewards & penalties
# ---------------------------------------------------------------------------


def get_base_reward(state, index: int, context) -> int:
    total_balance = h.get_total_active_balance(state, context)
    effective = state.validators[index].effective_balance
    return (
        effective
        * context.BASE_REWARD_FACTOR
        // h.integer_squareroot(total_balance)
        // BASE_REWARDS_PER_EPOCH
    )


def _base_reward_fn(state, context):
    """Per-index base-reward closure with the O(n) total-active-balance
    hoisted out — get_base_reward recomputes it per call, which turns the
    whole-registry delta loops O(n²)."""
    sqrt_total = h.integer_squareroot(h.get_total_active_balance(state, context))
    factor = context.BASE_REWARD_FACTOR

    def base_reward(index: int) -> int:
        return (
            state.validators[index].effective_balance
            * factor
            // sqrt_total
            // BASE_REWARDS_PER_EPOCH
        )

    return base_reward


BASE_REWARDS_PER_EPOCH = 4
PROPOSER_REWARD_QUOTIENT = 8


def get_proposer_reward(state, attesting_index: int, context) -> int:
    return get_base_reward(state, attesting_index, context) // context.PROPOSER_REWARD_QUOTIENT


def get_finality_delay(state, context) -> int:
    return h.get_previous_epoch(state, context) - state.finalized_checkpoint.epoch


def is_in_inactivity_leak(state, context) -> bool:
    return get_finality_delay(state, context) > context.MIN_EPOCHS_TO_INACTIVITY_PENALTY


def get_eligible_validator_indices(state, context) -> list[int]:
    previous_epoch = h.get_previous_epoch(state, context)
    return [
        i
        for i, v in enumerate(state.validators)
        if h.is_active_validator(v, previous_epoch)
        or (v.slashed and previous_epoch + 1 < v.withdrawable_epoch)
    ]


def get_attestation_component_deltas(state, attestations, context):
    """Rewards attesters in ``attestations``, penalizes eligible absentees
    (epoch_processing.rs component-delta pattern :762+)."""
    n = len(state.validators)
    rewards = [0] * n
    penalties = [0] * n
    total_balance = h.get_total_active_balance(state, context)
    unslashed = get_unslashed_attesting_indices(state, attestations, context)
    attesting_balance = h.get_total_balance(state, unslashed, context)
    increment = context.EFFECTIVE_BALANCE_INCREMENT
    base_reward = _base_reward_fn(state, context)
    leaking = is_in_inactivity_leak(state, context)
    for index in get_eligible_validator_indices(state, context):
        if index in unslashed:
            if leaking:
                rewards[index] += base_reward(index)
            else:
                reward_numerator = base_reward(index) * (
                    attesting_balance // increment
                )
                rewards[index] += reward_numerator // (total_balance // increment)
        else:
            penalties[index] += base_reward(index)
    return rewards, penalties


def get_source_deltas(state, context):
    previous_epoch = h.get_previous_epoch(state, context)
    return get_attestation_component_deltas(
        state,
        get_matching_source_attestations(state, previous_epoch, context),
        context,
    )


def get_target_deltas(state, context):
    previous_epoch = h.get_previous_epoch(state, context)
    return get_attestation_component_deltas(
        state,
        get_matching_target_attestations(state, previous_epoch, context),
        context,
    )


def get_head_deltas(state, context):
    previous_epoch = h.get_previous_epoch(state, context)
    return get_attestation_component_deltas(
        state,
        get_matching_head_attestations(state, previous_epoch, context),
        context,
    )


def get_inclusion_delay_deltas(state, context):
    n = len(state.validators)
    rewards = [0] * n
    penalties = [0] * n  # no inclusion-delay penalties
    previous_epoch = h.get_previous_epoch(state, context)
    source_attestations = get_matching_source_attestations(
        state, previous_epoch, context
    )
    base_reward = _base_reward_fn(state, context)
    # one pass over attestations in (inclusion_delay, original-order)
    # instead of re-scanning every attestation per validator: the stable
    # sort makes the first assignment per index exactly the
    # min(candidates, key=inclusion_delay) of the spec's O(n·a) loop
    best: dict[int, object] = {}
    for a in sorted(source_attestations, key=lambda a: a.inclusion_delay):
        for index in h.get_attesting_indices(
            state, a.data, a.aggregation_bits, context
        ):
            if index not in best:
                best[index] = a
    for index, attestation in best.items():
        if state.validators[index].slashed:
            continue  # get_unslashed_attesting_indices parity
        proposer_reward = base_reward(index) // context.PROPOSER_REWARD_QUOTIENT
        rewards[attestation.proposer_index] += proposer_reward
        max_attester_reward = base_reward(index) - proposer_reward
        rewards[index] += max_attester_reward // attestation.inclusion_delay
    return rewards, penalties


def get_inactivity_penalty_deltas(state, context):
    n = len(state.validators)
    rewards = [0] * n  # no inactivity rewards
    penalties = [0] * n
    if is_in_inactivity_leak(state, context):
        previous_epoch = h.get_previous_epoch(state, context)
        matching_target_attesting_indices = get_unslashed_attesting_indices(
            state,
            get_matching_target_attestations(state, previous_epoch, context),
            context,
        )
        base_reward = _base_reward_fn(state, context)
        for index in get_eligible_validator_indices(state, context):
            base_rewards = BASE_REWARDS_PER_EPOCH * base_reward(index)
            penalties[index] += saturating_sub(
                base_rewards, base_reward(index) // context.PROPOSER_REWARD_QUOTIENT
            )
            if index not in matching_target_attesting_indices:
                effective = state.validators[index].effective_balance
                penalties[index] += (
                    effective
                    * get_finality_delay(state, context)
                    // context.INACTIVITY_PENALTY_QUOTIENT
                )
    return rewards, penalties


def _get_attestation_deltas_literal(state, context):
    n = len(state.validators)
    rewards = [0] * n
    penalties = [0] * n
    for fn in (
        get_source_deltas,
        get_target_deltas,
        get_head_deltas,
        get_inclusion_delay_deltas,
        get_inactivity_penalty_deltas,
    ):
        r, p = fn(state, context)
        for i in range(n):
            rewards[i] += r[i]
            penalties[i] += p[i]
    return rewards, penalties


# below this registry size the numpy column extraction costs more than
# the Python loops it replaces
_VECTORIZED_REWARDS_MIN_N = 1 << 12


def _attestation_deltas_vectorized(state, context, packed=None):
    """numpy twin of the five delta components over validator columns —
    identical integer semantics to the literal path (the literal stays
    the oracle + small-registry path and the spec-test rewards runner's
    per-component surface). Every quotient mirrors the spec's two-step
    floor division; products stay far below 2^64 (base_reward < 2^41,
    attesting increments < 2^23). ``packed`` lets the columnar epoch
    pass hand in its already-derived column views (epoch_vector
    ``_rewards_phase0``) instead of re-deriving the activity masks."""
    import numpy as np

    n = len(state.validators)
    prev = h.get_previous_epoch(state, context)
    if packed is None:
        from ..ops_vector import pack_registry_cached

        # delta-refreshed registry-column cache (models/ops_vector.py);
        # the literal fromiter packing is its internal fallback
        packed = pack_registry_cached(state, prev)
    eff = packed["effective_balance"]
    slashed = packed["slashed"]
    active_prev = packed["active_previous"]
    eligible = packed["eligible"]

    # the committee-mask kernel (models/committees.py): source/target/
    # head masks + the min-inclusion-delay columns in one vectorized
    # pass; the per-attestation spec walk below stays the live fallback
    from ..committees import pending_masks_for

    bundle = pending_masks_for(state, prev, context)
    if bundle is not None:
        source_mask = bundle.source & ~slashed
        target_masked = bundle.target & ~slashed
        head_masked = bundle.head & ~slashed
        masks_iter = (source_mask, target_masked, head_masked)
        have = bundle.covered
        best_delay = bundle.inclusion_delay
        best_proposer = bundle.inclusion_proposer
    else:
        source_atts = get_matching_source_attestations(state, prev, context)
        target_root = h.get_block_root(state, prev, context)
        target_atts = [
            a for a in source_atts if a.data.target.root == target_root
        ]
        head_atts = [
            a
            for a in target_atts
            if a.data.beacon_block_root
            == h.get_block_root_at_slot(state, a.data.slot)
        ]

        def attesting_mask(atts):
            m = np.zeros(n, dtype=bool)
            for a in atts:
                idx = h.get_attesting_indices(
                    state, a.data, a.aggregation_bits, context
                )
                m[np.fromiter(idx, dtype=np.int64, count=len(idx))] = True
            return m & ~slashed

        masks_iter = tuple(
            attesting_mask(atts)
            for atts in (source_atts, target_atts, head_atts)
        )

    total_balance = h.get_total_active_balance(state, context)
    sqrt_total = h.integer_squareroot(total_balance)
    base_reward = (
        eff * np.uint64(context.BASE_REWARD_FACTOR) // np.uint64(sqrt_total)
    ) // np.uint64(BASE_REWARDS_PER_EPOCH)
    increment = int(context.EFFECTIVE_BALANCE_INCREMENT)
    total_incr = np.uint64(total_balance // increment)
    leaking = is_in_inactivity_leak(state, context)

    rewards = np.zeros(n, dtype=np.uint64)
    penalties = np.zeros(n, dtype=np.uint64)
    zero = np.uint64(0)
    tgt_mask = None
    for which, mask in enumerate(masks_iter):
        if which == 1:
            tgt_mask = mask
        # get_total_balance floors at one increment
        attesting_balance = max(increment, int(eff[mask].sum()))
        att_incr = np.uint64(attesting_balance // increment)
        attesting = eligible & mask
        # whole-array where-adds: ~3× cheaper than boolean-gather adds
        # at registry scale, same u64 values (products are guarded far
        # below 2^64 — base_reward < 2^41, att_incr < 2^23)
        if leaking:
            rewards += np.where(attesting, base_reward, zero)
        else:
            rewards += np.where(
                attesting, base_reward * att_incr // total_incr, zero
            )
        penalties += np.where(eligible & ~mask, base_reward, zero)

    if bundle is None:
        # inclusion delay: first assignment in stable inclusion_delay
        # order IS the spec's min(candidates); proposer scatter-adds
        have = np.zeros(n, dtype=bool)
        best_delay = np.ones(n, dtype=np.uint64)
        best_proposer = np.zeros(n, dtype=np.int64)
        for a in sorted(source_atts, key=lambda a: a.inclusion_delay):
            idx_set = h.get_attesting_indices(
                state, a.data, a.aggregation_bits, context
            )
            idx = np.fromiter(idx_set, dtype=np.int64, count=len(idx_set))
            newly = idx[~have[idx]]
            have[newly] = True
            best_delay[newly] = int(a.inclusion_delay)
            best_proposer[newly] = int(a.proposer_index)
    prq = np.uint64(context.PROPOSER_REWARD_QUOTIENT)
    covered = have & ~slashed
    proposer_reward = base_reward // prq
    # best_delay is 1 on uncovered lanes (never selected), so the whole-
    # array quotient is division-safe and the where gate discards it
    rewards += np.where(
        covered, (base_reward - proposer_reward) // best_delay, zero
    )
    np.add.at(rewards, best_proposer[covered], proposer_reward[covered])

    if leaking:
        # saturating by construction: 4*br >= br // PROPOSER_REWARD_QUOTIENT
        penalties[eligible] += (
            np.uint64(BASE_REWARDS_PER_EPOCH) * base_reward[eligible]
            - proposer_reward[eligible]
        )
        missed = eligible & ~tgt_mask
        penalties[missed] += (
            eff[missed]
            * np.uint64(get_finality_delay(state, context))
            // np.uint64(context.INACTIVITY_PENALTY_QUOTIENT)
        )
    return rewards, penalties


def get_attestation_deltas(state, context):
    n = len(state.validators)
    if n >= _VECTORIZED_REWARDS_MIN_N:
        rewards, penalties = _attestation_deltas_vectorized(state, context)
        return [int(r) for r in rewards], [int(p) for p in penalties]
    return _get_attestation_deltas_literal(state, context)


def process_rewards_and_penalties(state, context) -> None:
    """(epoch_processing.rs:217)"""
    if h.get_current_epoch(state, context) == GENESIS_EPOCH:
        return
    n = len(state.validators)
    if n >= _VECTORIZED_REWARDS_MIN_N:
        import numpy as np

        rewards, penalties = _attestation_deltas_vectorized(state, context)
        balances = np.fromiter(state.balances, dtype=np.uint64, count=n)
        raised = balances + rewards
        if bool((raised < balances).any()):
            # u64 overflow: re-run literally so checked_add raises the
            # structured error at the exact index
            rewards_l, penalties_l = _get_attestation_deltas_literal(
                state, context
            )
            for index in range(n):
                h.increase_balance(state, index, rewards_l[index])
                h.decrease_balance(state, index, penalties_l[index])
            return
        final = np.where(raised >= penalties, raised - penalties, 0)
        from ...ssz.core import bulk_store

        # dirty-range bulk write (one C-speed splice instead of 2n
        # __setitem__ calls): only the 4096-element groups whose balances
        # actually changed re-merkleize on the next state root; the
        # column goes in wire-width (bulk_store boxes it ONCE and
        # certifies uniformity from the dtype)
        bulk_store(
            state.balances, final, np.nonzero(final != balances)[0]
        )
        return
    rewards, penalties = _get_attestation_deltas_literal(state, context)
    for index in range(n):
        h.increase_balance(state, index, rewards[index])
        h.decrease_balance(state, index, penalties[index])


# ---------------------------------------------------------------------------
# registry / slashings / resets
# ---------------------------------------------------------------------------


def vectorized_registry_scan(
    state,
    context,
    queue_entry_ge_min_activation: bool,
    helpers,
) -> list:
    """Shared numpy registry sweep for every fork's registry updates:
    performs the queue-entry writes and ejections, and returns the
    ASCENDING indices of activation-eligible validators (callers apply
    their fork's activation rule — phase0..deneb sort and churn-cap,
    electra activates all). Fork knobs: the queue-entry balance rule
    (``queue_entry_ge_min_activation`` — EIP-7251's
    ``>= MIN_ACTIVATION_BALANCE`` vs phase0's
    ``== MAX_EFFECTIVE_BALANCE``) and ``helpers``, whose
    ``initiate_validator_exit`` performs the ejections — electra MUST
    pass its own (balance-weighted exit churn, EIP-7251). Both are
    REQUIRED — a helpers default of phase0 cost exactly that churn
    divergence in testing, so the footgun is now structurally
    impossible."""
    import numpy as np

    from ...primitives import FAR_FUTURE_EPOCH

    hm = helpers
    current_epoch = h.get_current_epoch(state, context)
    n = len(state.validators)
    vals = state.validators
    # delta-refreshed registry columns when available (the masks below
    # are derived arrays, and nothing re-syncs the cache mid-scan, so
    # the views stay frozen at extraction exactly like the fromiters)
    from ..ops_vector import columns_for

    cols = columns_for(state)
    vc = cols.validator_columns(state) if cols is not None else None
    if vc is not None:
        eligibility = vc["activation_eligibility_epoch"]
        activation = vc["activation_epoch"]
        exit_epoch = vc["exit_epoch"]
        eff = vc["effective_balance"]
    else:
        eligibility = np.fromiter(
            (v.activation_eligibility_epoch for v in vals),
            dtype=np.uint64,
            count=n,
        )
        activation = np.fromiter(
            (v.activation_epoch for v in vals), dtype=np.uint64, count=n
        )
        exit_epoch = np.fromiter(
            (v.exit_epoch for v in vals), dtype=np.uint64, count=n
        )
        eff = np.fromiter(
            (v.effective_balance for v in vals), dtype=np.uint64, count=n
        )
    far = np.uint64(FAR_FUTURE_EPOCH)
    if queue_entry_ge_min_activation:
        balance_rule = eff >= np.uint64(int(context.MIN_ACTIVATION_BALANCE))
    else:
        balance_rule = eff == np.uint64(int(context.MAX_EFFECTIVE_BALANCE))
    queue_entry = (eligibility == far) & balance_rule
    for index in np.nonzero(queue_entry)[0]:
        vals[index].activation_eligibility_epoch = current_epoch + 1
    ejection = (
        (activation <= current_epoch)
        & (current_epoch < exit_epoch)
        & (eff <= np.uint64(int(context.ejection_balance)))
    )
    for index in np.nonzero(ejection)[0]:
        hm.initiate_validator_exit(state, int(index), context)
    # re-read eligibility: the queue-entry writes above changed it
    activatable = (
        np.where(queue_entry, np.uint64(current_epoch + 1), eligibility)
        <= np.uint64(int(state.finalized_checkpoint.epoch))
    ) & (activation == far)
    return [int(i) for i in np.nonzero(activatable)[0]]


def registry_scan_and_queue(state, context) -> list:
    """The whole-registry scan behind phase0..deneb registry updates
    (queue entries, ejections, the sorted activation queue) — those
    forks differ only in the churn limit that caps activations.
    electra+ applies different predicates and its own activation rule
    through the shared ``vectorized_registry_scan``.

    Above the vectorized threshold the three whole-registry predicate
    scans run as numpy column masks and the per-validator Python work
    touches only the (few) hits — the literal loop remains the
    semantics and the small-registry path."""
    n = len(state.validators)
    if n >= _VECTORIZED_REWARDS_MIN_N:
        activation_queue = sorted(
            vectorized_registry_scan(
                state, context, queue_entry_ge_min_activation=False, helpers=h
            ),
            key=lambda index: (
                state.validators[index].activation_eligibility_epoch,
                index,
            ),
        )
    else:
        current_epoch = h.get_current_epoch(state, context)
        for index, validator in enumerate(state.validators):
            if h.is_eligible_for_activation_queue(validator, context):
                validator.activation_eligibility_epoch = current_epoch + 1
            if (
                h.is_active_validator(validator, current_epoch)
                and validator.effective_balance <= context.ejection_balance
            ):
                h.initiate_validator_exit(state, index, context)

        activation_queue = sorted(
            (
                index
                for index, v in enumerate(state.validators)
                if h.is_eligible_for_activation(state, v)
            ),
            key=lambda index: (
                state.validators[index].activation_eligibility_epoch,
                index,
            ),
        )
    return activation_queue


def process_registry_updates(state, context) -> None:
    """(epoch_processing.rs:253)"""
    current_epoch = h.get_current_epoch(state, context)
    activation_queue = registry_scan_and_queue(state, context)
    churn_limit = h.get_validator_churn_limit(state, context)
    activation_epoch = h.compute_activation_exit_epoch(current_epoch, context)
    for index in activation_queue[:churn_limit]:
        state.validators[index].activation_epoch = activation_epoch


def process_slashings(state, context) -> None:
    """(epoch_processing.rs:321)"""
    epoch = h.get_current_epoch(state, context)
    total_balance = h.get_total_active_balance(state, context)
    adjusted_total_slashing_balance = min(
        sum(state.slashings) * context.PROPORTIONAL_SLASHING_MULTIPLIER,
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
                validator.effective_balance
                // increment
                * adjusted_total_slashing_balance
            )
            penalty = penalty_numerator // total_balance * increment
            h.decrease_balance(state, index, penalty)


def process_eth1_data_reset(state, context) -> None:
    next_epoch = h.get_current_epoch(state, context) + 1
    if next_epoch % context.EPOCHS_PER_ETH1_VOTING_PERIOD == 0:
        state.eth1_data_votes = []


def process_effective_balance_updates(state, context) -> None:
    """Hysteresis sweep over the whole registry; the CUDA kernel above
    threshold (ops/sweeps.py effective_balance_updates_device), columnar
    host twin (models/ops_vector.py effective_balance_update_hits) above
    the vectorized threshold, literal loop as oracle/fallback."""
    # the ONLY spec site that mutates effective balances: drop the
    # total-active-balance memo (helpers.get_total_active_balance)
    state.__dict__.pop("_total_active_balance_cache", None)
    if _device_flags.sweeps_enabled(len(state.validators)):
        from ...ops import sweeps as _sweeps

        packed = _sweeps.pack_registry(state, h.get_current_epoch(state, context))
        updated = _sweeps.effective_balance_updates_device(
            packed, context, device=_device_flags.DEVICE
        )
        for index, validator in enumerate(state.validators):
            value = int(updated[index])
            # only real changes write: an unconditional store would pop
            # every validator's root cache (and the registry freshness)
            # for the hysteresis-typical no-op case
            if validator.effective_balance != value:
                validator.effective_balance = value
        return
    if len(state.validators) >= _VECTORIZED_REWARDS_MIN_N:
        from ..ops_vector import effective_balance_update_hits

        hits = effective_balance_update_hits(state, context)
        if hits is not None:
            validators = state.validators
            # changed-only writes through __setattr__ (the instrumented
            # channel): the literal loop only ever stores a different
            # value on a threshold crossing, so this is the same state
            for index, value in hits:
                validators[index].effective_balance = value
            return
    hysteresis_increment = (
        context.EFFECTIVE_BALANCE_INCREMENT // context.HYSTERESIS_QUOTIENT
    )
    downward_threshold = hysteresis_increment * context.HYSTERESIS_DOWNWARD_MULTIPLIER
    upward_threshold = hysteresis_increment * context.HYSTERESIS_UPWARD_MULTIPLIER
    for index, validator in enumerate(state.validators):
        balance = state.balances[index]
        if (
            balance + downward_threshold < validator.effective_balance
            or validator.effective_balance + upward_threshold < balance
        ):
            validator.effective_balance = min(
                balance - balance % context.EFFECTIVE_BALANCE_INCREMENT,
                context.MAX_EFFECTIVE_BALANCE,
            )


def process_slashings_reset(state, context) -> None:
    next_epoch = h.get_current_epoch(state, context) + 1
    state.slashings[next_epoch % context.EPOCHS_PER_SLASHINGS_VECTOR] = 0


def process_randao_mixes_reset(state, context) -> None:
    current_epoch = h.get_current_epoch(state, context)
    next_epoch = current_epoch + 1
    state.randao_mixes[next_epoch % context.EPOCHS_PER_HISTORICAL_VECTOR] = (
        h.get_randao_mix(state, current_epoch)
    )


def process_historical_roots_update(state, context) -> None:
    next_epoch = h.get_current_epoch(state, context) + 1
    epochs_per_period = (
        context.SLOTS_PER_HISTORICAL_ROOT // context.SLOTS_PER_EPOCH
    )
    if next_epoch % epochs_per_period == 0:
        from .containers import build

        ns = build(context.preset)
        historical_batch = ns.HistoricalBatch(
            block_roots=list(state.block_roots),
            state_roots=list(state.state_roots),
        )
        state.historical_roots.append(
            ns.HistoricalBatch.hash_tree_root(historical_batch)
        )


def process_participation_record_updates(state, context) -> None:
    from ..committees import drop_masks_memo

    # the pending lists swap: any mask bundle built this epoch is done
    drop_masks_memo(state)
    state.previous_epoch_attestations = state.current_epoch_attestations
    state.current_epoch_attestations = []


def process_epoch(state, context) -> None:
    """(epoch_processing.rs:1039) — columnar-primary pass above the
    engine threshold (models/epoch_vector.py, one vectorized pass over
    the authoritative registry columns); this literal stage list is the
    fallback and the differential oracle."""
    from ..epoch_vector import process_epoch_columnar

    if process_epoch_columnar(state, context, "phase0"):
        return
    process_justification_and_finalization(state, context)
    process_rewards_and_penalties(state, context)
    process_registry_updates(state, context)
    process_slashings(state, context)
    process_eth1_data_reset(state, context)
    process_effective_balance_updates(state, context)
    process_slashings_reset(state, context)
    process_randao_mixes_reset(state, context)
    process_historical_roots_update(state, context)
    process_participation_record_updates(state, context)
