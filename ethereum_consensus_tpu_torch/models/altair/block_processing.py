"""altair block processing.

Reference parity: ethereum-consensus/src/altair/block_processing.rs —
reworked process_attestation:31 (participation flags + proposer reward),
add_validator_to_registry (participation/inactivity appends),
process_sync_aggregate:192 (the eth_fast_aggregate_verify hot path),
altair process_block. Ported from
ethereum_consensus_tpu/models/altair/block_processing.py.
"""

from __future__ import annotations

from ...crypto import bls
from ...domains import DomainType
from ...error import (
    InvalidAttestation,
    InvalidDeposit,
    InvalidIndexedAttestation,
    InvalidOperation,
    InvalidSyncAggregate,
    checked_add,
)
from ...signing import compute_signing_root
from ...ssz import is_valid_merkle_branch
from .. import ops_vector
from ..signature_batch import verify_or_defer
from ..phase0.block_processing import (  # noqa: F401 — fork-diff re-exports
    get_validator_from_deposit,
    process_block_header,
    process_eth1_data,
    process_proposer_slashing,
    process_randao,
    process_voluntary_exit,
)
from ..phase0.containers import (
    DEPOSIT_CONTRACT_TREE_DEPTH,
    DepositData,
    DepositMessage,
)
from . import helpers as h
from .constants import (
    PARTICIPATION_FLAG_WEIGHTS,
    PROPOSER_WEIGHT,
    SYNC_REWARD_WEIGHT,
    WEIGHT_DENOMINATOR,
)

__all__ = [
    "process_attestation",
    "process_attester_slashing",
    "add_validator_to_registry",
    "apply_deposit",
    "process_deposit",
    "process_sync_aggregate",
    "process_operations",
    "process_block",
]


def _prepare_attestation(state, attestation, context):
    """Every check and resolution of altair process_attestation BEFORE the
    participation writes: validation, committee/flag resolution, signature
    verify (deferred under a batch). Returns ``(attesting_indices,
    participation_flag_indices, is_current)`` — shared verbatim by the
    scalar path below and the columnar block engine
    (models/ops_vector.py), so the two can't drift."""
    data = attestation.data
    current_epoch = h.get_current_epoch(state, context)
    previous_epoch = h.get_previous_epoch(state, context)
    is_current = data.target.epoch == current_epoch
    if data.target.epoch not in (previous_epoch, current_epoch):
        raise InvalidAttestation("target epoch not current or previous")
    if data.target.epoch != h.compute_epoch_at_slot(data.slot, context):
        raise InvalidAttestation("target epoch does not match slot")
    if not (
        data.slot + context.MIN_ATTESTATION_INCLUSION_DELAY
        <= state.slot
        <= data.slot + context.SLOTS_PER_EPOCH
    ):
        raise InvalidAttestation("attestation outside inclusion window")
    if data.index >= h.get_committee_count_per_slot(state, data.target.epoch, context):
        raise InvalidAttestation("committee index out of range")

    committee = h.get_beacon_committee(state, data.slot, data.index, context)
    if len(attestation.aggregation_bits) != len(committee):
        raise InvalidAttestation("aggregation bits != committee size")

    inclusion_delay = state.slot - data.slot
    participation_flag_indices = h.get_attestation_participation_flag_indices(
        state, data, inclusion_delay, context
    )

    indexed = h.get_indexed_attestation(state, attestation, context)
    try:
        h.is_valid_indexed_attestation(
            state, indexed, context,
            error=InvalidAttestation(
                f"attestation at slot {data.slot} committee {data.index}: "
                "aggregate signature does not verify"
            ),
        )
    except InvalidIndexedAttestation as exc:
        raise InvalidAttestation(str(exc)) from exc

    attesting_indices = h.get_attesting_indices(
        state, data, attestation.aggregation_bits, context
    )
    return attesting_indices, participation_flag_indices, is_current


def _apply_attestation_participation(
    state, attesting_indices, participation_flag_indices, is_current,
    context, helpers=None,
) -> None:
    """The participation-flag writes + proposer reward of altair+
    process_attestation — the scalar per-index loop, identical across
    altair..electra (only the validation above differs per fork). This is
    the fallback and the differential-test oracle for the columnar block
    engine's vectorized twin."""
    hm = helpers or h
    participation = (
        state.current_epoch_participation
        if is_current
        else state.previous_epoch_participation
    )
    proposer_reward_numerator = 0
    # hoist the O(n) total-active-balance out of the attester loop
    brpi = hm.get_base_reward_per_increment(state, context)
    increment = context.EFFECTIVE_BALANCE_INCREMENT
    for index in attesting_indices:
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            if flag_index in participation_flag_indices and not hm.has_flag(
                participation[index], flag_index
            ):
                participation[index] = hm.add_flag(participation[index], flag_index)
                proposer_reward_numerator += (
                    state.validators[index].effective_balance // increment
                ) * brpi * weight

    proposer_reward_denominator = (
        (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT) * WEIGHT_DENOMINATOR // PROPOSER_WEIGHT
    )
    proposer_reward = proposer_reward_numerator // proposer_reward_denominator
    hm.increase_balance(
        state, hm.get_beacon_proposer_index(state, context), proposer_reward
    )


def process_attestation(state, attestation, context) -> None:
    """(block_processing.rs:31)"""
    attesting_indices, participation_flag_indices, is_current = (
        _prepare_attestation(state, attestation, context)
    )
    _apply_attestation_participation(
        state, attesting_indices, participation_flag_indices, is_current,
        context,
    )


def process_attester_slashing(state, attester_slashing, context, slash_fn=None) -> None:
    """phase0 logic with altair slash_validator; ``slash_fn`` lets later
    forks swap in their slash_validator."""
    from ...error import InvalidAttesterSlashing

    if slash_fn is None:
        slash_fn = h.slash_validator

    attestation_1 = attester_slashing.attestation_1
    attestation_2 = attester_slashing.attestation_2
    if not h.is_slashable_attestation_data(attestation_1.data, attestation_2.data):
        raise InvalidAttesterSlashing("attestation data not slashable")
    try:
        h.is_valid_indexed_attestation(
            state, attestation_1, context,
            error=InvalidAttesterSlashing("attestation 1 signature invalid"),
        )
        h.is_valid_indexed_attestation(
            state, attestation_2, context,
            error=InvalidAttesterSlashing("attestation 2 signature invalid"),
        )
    except InvalidIndexedAttestation as exc:
        raise InvalidAttesterSlashing(str(exc)) from exc

    epoch = h.get_current_epoch(state, context)
    slashable = sorted(
        set(attestation_1.attesting_indices) & set(attestation_2.attesting_indices)
    )
    slashed_any = False
    for index in slashable:
        if h.is_slashable_validator(state.validators[index], epoch):
            slash_fn(state, index, None, context)
            slashed_any = True
    if not slashed_any:
        raise InvalidAttesterSlashing("no validator could be slashed")


def process_deposit(
    state, deposit, context, pubkey_index=None, signature_valid=None
) -> None:
    """(phase0 block_processing.rs:405 with altair apply_deposit)"""
    leaf = DepositData.hash_tree_root(deposit.data)
    if not is_valid_merkle_branch(
        leaf,
        list(deposit.proof),
        DEPOSIT_CONTRACT_TREE_DEPTH + 1,
        state.eth1_deposit_index,
        state.eth1_data.deposit_root,
    ):
        raise InvalidDeposit("invalid deposit inclusion proof")
    state.eth1_deposit_index = checked_add(state.eth1_deposit_index, 1)
    apply_deposit(
        state, deposit.data, context, pubkey_index=pubkey_index,
        signature_valid=signature_valid,
    )


def add_validator_to_registry(
    state, public_key: bytes, withdrawal_credentials: bytes, amount: int, context
) -> None:
    """(block_processing.rs add_validator_to_registry)"""
    deposit_data = DepositData(
        public_key=public_key,
        withdrawal_credentials=withdrawal_credentials,
        amount=amount,
    )
    state.validators.append(get_validator_from_deposit(deposit_data, context))
    state.balances.append(amount)
    state.previous_epoch_participation.append(0)
    state.current_epoch_participation.append(0)
    state.inactivity_scores.append(0)


def apply_deposit(
    state, deposit_data, context, pubkey_index=None, signature_valid=None
) -> None:
    """altair apply_deposit: new validators also get participation flags and
    inactivity-score entries. ``pubkey_index`` / ``signature_valid`` as in
    phase0 apply_deposit."""
    public_key = deposit_data.public_key
    if pubkey_index is not None:
        existing = pubkey_index.get(bytes(public_key))
    else:
        pubkeys = [v.public_key for v in state.validators]
        existing = pubkeys.index(public_key) if public_key in pubkeys else None
    if existing is None:
        if signature_valid is not None:
            valid = bool(signature_valid)
        else:
            deposit_message = DepositMessage(
                public_key=public_key,
                withdrawal_credentials=deposit_data.withdrawal_credentials,
                amount=deposit_data.amount,
            )
            domain = h.compute_domain(DomainType.DEPOSIT, None, None, context)
            signing_root = compute_signing_root(
                DepositMessage, deposit_message, domain
            )
            try:
                pk = bls.PublicKey.from_bytes(public_key)
                sig = bls.Signature.from_bytes(deposit_data.signature)
                valid = bls.verify_signature(pk, signing_root, sig)
            except Exception:
                valid = False
        if not valid:
            return  # invalid deposit signatures are skipped, not errors
        add_validator_to_registry(
            state,
            public_key,
            deposit_data.withdrawal_credentials,
            deposit_data.amount,
            context,
        )
        if pubkey_index is not None:
            pubkey_index[bytes(public_key)] = len(state.validators) - 1
    else:
        h.increase_balance(state, existing, deposit_data.amount)


def _registry_pubkey_index(state) -> dict:
    """pubkey -> registry index, cached on the state per registry length.

    Sound because the registry is append-only and a validator's public
    key is immutable once deposited; a deposit changes the length key and
    rebuilds. The sync aggregate resolves all 512 committee members'
    indices EVERY block, and the uncached full-registry dictcomp was the
    single biggest operations item of the warm 2^17 deneb block (~67 ms).
    REBOUND, never mutated in place — Container.copy() shares __dict__
    values (the _active_idx_cache rationale in phase0/helpers.py)."""
    cached = state.__dict__.get("_pubkey_index_cache")
    n = len(state.validators)
    if cached is not None and cached[0] == n:
        return cached[1]
    index_by_key = {
        bytes(v.public_key): i for i, v in enumerate(state.validators)
    }
    state.__dict__["_pubkey_index_cache"] = (n, index_by_key)
    return index_by_key


def process_sync_aggregate(state, sync_aggregate, context) -> None:
    """(block_processing.rs:192) — eth_fast_aggregate_verify over up to
    SYNC_COMMITTEE_SIZE keys; the #2 signature hot path."""
    committee_keys = state.current_sync_committee.public_keys
    bits = list(sync_aggregate.sync_committee_bits)
    participant_keys = [pk for pk, bit in zip(committee_keys, bits) if bit]
    previous_slot = max(state.slot, 1) - 1
    domain = h.get_domain(
        state,
        DomainType.SYNC_COMMITTEE,
        h.compute_epoch_at_slot(previous_slot, context),
        context,
    )
    root_at_slot = h.get_block_root_at_slot(state, previous_slot)
    from ...primitives import Root

    signing_root = compute_signing_root(Root, root_at_slot, domain)
    error = InvalidSyncAggregate("invalid sync committee aggregate signature")
    try:
        sig = bls.Signature.from_bytes(sync_aggregate.sync_committee_signature)
        # committee members are registry keys (valid by the deposit
        # rule): decompression defers to verification — the pipeline's
        # stage B — where uncached keys go eight-wide per sqrt chain
        keys = [
            bls.PublicKey.from_validated_bytes(bytes(pk))
            for pk in participant_keys
        ]
    except Exception as exc:
        raise InvalidSyncAggregate(str(exc)) from exc
    if not keys:
        # the "no participants" infinity rule (bls.rs eth_fast_aggregate_
        # verify:150) — a data-dependent special case, checked inline
        if not bls.eth_fast_aggregate_verify([], signing_root, sig):
            raise error
    else:
        verify_or_defer(keys, signing_root, sig, error)

    # participant + proposer rewards
    total_active_increments = (
        h.get_total_active_balance(state, context)
        // context.EFFECTIVE_BALANCE_INCREMENT
    )
    index_by_key = _registry_pubkey_index(state)
    total_base_rewards = (
        h.get_base_reward_per_increment(state, context) * total_active_increments
    )
    max_participant_rewards = (
        total_base_rewards
        * SYNC_REWARD_WEIGHT
        // WEIGHT_DENOMINATOR
        // context.SLOTS_PER_EPOCH
    )
    participant_reward = max_participant_rewards // context.SYNC_COMMITTEE_SIZE
    proposer_reward = (
        participant_reward * PROPOSER_WEIGHT // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
    )

    committee_indices = [index_by_key[bytes(pk)] for pk in committee_keys]
    for participant_index, bit in zip(committee_indices, bits):
        if bit:
            h.increase_balance(state, participant_index, participant_reward)
            h.increase_balance(
                state, h.get_beacon_proposer_index(state, context), proposer_reward
            )
        else:
            h.decrease_balance(state, participant_index, participant_reward)


def process_operations(
    state,
    body,
    context,
    *,
    slash_fn=None,
    attestation_fn=None,
    deposit_fn=None,
    voluntary_exit_fn=None,
) -> None:
    """(phase0 block_processing.rs:704 dispatching to altair ops). The
    keyword hooks are the fork-diff seams: later forks pass their
    slash_validator / process_attestation / process_deposit /
    process_voluntary_exit without re-spinning the loop."""
    if slash_fn is None:
        slash_fn = h.slash_validator
    if attestation_fn is None:
        attestation_fn = process_attestation
    if deposit_fn is None:
        deposit_fn = process_deposit
    if voluntary_exit_fn is None:
        voluntary_exit_fn = process_voluntary_exit
    expected_deposits = min(
        context.MAX_DEPOSITS,
        state.eth1_data.deposit_count - state.eth1_deposit_index,
    )
    if len(body.deposits) != expected_deposits:
        raise InvalidOperation(
            f"expected {expected_deposits} deposits, block has {len(body.deposits)}"
        )
    for op in body.proposer_slashings:
        process_proposer_slashing(state, op, context, slash_fn=slash_fn)
    for op in body.attester_slashings:
        process_attester_slashing(state, op, context, slash_fn=slash_fn)
    # block-scoped columnar fast path: all attestations validated through
    # the fork's own _prepare_attestation, flags committed with one
    # bulk_store per participation list; the scalar loop is the fallback
    # (small registry, custom attestation_fn, no numpy) and the oracle
    if not ops_vector.process_attestations_batch(
        state, body.attestations, context, attestation_fn
    ):
        for op in body.attestations:
            attestation_fn(state, op, context)
    if body.deposits:
        pubkey_index = {
            bytes(v.public_key): i for i, v in enumerate(state.validators)
        }
        for op in body.deposits:
            deposit_fn(state, op, context, pubkey_index=pubkey_index)
    for op in body.voluntary_exits:
        voluntary_exit_fn(state, op, context)


def process_block(state, block, context) -> None:
    """(block_processing.rs process_block, altair)"""
    process_block_header(state, block, context)
    process_randao(state, block.body, context)
    process_eth1_data(state, block.body, context)
    process_operations(state, block.body, context)
    process_sync_aggregate(state, block.body.sync_aggregate, context)


# bellatrix/capella re-export this module's process_attestation, so one
# registration covers the three forks that share the altair validation
ops_vector.register_attestation_preparer(
    process_attestation, _prepare_attestation, h
)
