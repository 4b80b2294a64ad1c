"""phase0 spec helpers: epochs/slots, committees/shuffling, proposers,
domains, balances, validator predicates, slashing.

Reference parity: ethereum-consensus/src/phase0/helpers.rs (1,172 LoC):
compute_shuffled_index:249, whole-list shuffle:287 (_shuffled_array_vectorized),
compute_proposer_index:400, get_beacon_committee:775,
get_beacon_proposer_index:808, get_domain:190,
is_valid_indexed_attestation:71, verify_block_signature:144,
balance ops :979-1035, slash_validator:1088.

All functions are (state, ..., context)-shaped; container classes come from
the preset-independent module scope or ``type(state)`` so the same code
serves every preset.
"""

from __future__ import annotations

import hashlib

from ... import _device_flags
from ...crypto import bls
from ...domains import DomainType
from ...error import (
    InvalidIndexedAttestation,
    OutOfBoundsError,
    StateTransitionError,
    checked_add,
    saturating_sub,
)
from ...primitives import FAR_FUTURE_EPOCH, GENESIS_EPOCH
from ...shuffling import shuffle_sources
from ...signing import compute_signing_root
from ..signature_batch import verify_or_defer
from .containers import Fork, ForkData

__all__ = [
    "integer_squareroot",
    "xor",
    "compute_epoch_at_slot",
    "compute_start_slot_at_epoch",
    "compute_activation_exit_epoch",
    "compute_shuffled_index",
    "shuffled_active_array",
    "compute_committee",
    "compute_proposer_index",
    "compute_fork_data_root",
    "compute_fork_digest",
    "compute_domain",
    "get_current_epoch",
    "get_previous_epoch",
    "get_block_root",
    "get_block_root_at_slot",
    "get_randao_mix",
    "get_active_validator_indices",
    "get_validator_churn_limit",
    "get_seed",
    "get_committee_count_per_slot",
    "get_beacon_committee",
    "get_beacon_proposer_index",
    "get_total_balance",
    "get_total_active_balance",
    "get_domain",
    "get_indexed_attestation",
    "get_attesting_indices",
    "increase_balance",
    "decrease_balance",
    "initiate_validator_exit",
    "slash_validator",
    "is_active_validator",
    "is_eligible_for_activation_queue",
    "is_eligible_for_activation",
    "is_slashable_validator",
    "is_slashable_attestation_data",
    "is_valid_indexed_attestation",
    "verify_block_signature",
    "get_committee_count_at_slot",
]


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


# ---------------------------------------------------------------------------
# math + time
# ---------------------------------------------------------------------------


def integer_squareroot(n: int) -> int:
    import math

    if n < 0:
        raise OutOfBoundsError("integer_squareroot of negative")
    return math.isqrt(n)


def xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def compute_epoch_at_slot(slot: int, context) -> int:
    return slot // context.SLOTS_PER_EPOCH


def compute_start_slot_at_epoch(epoch: int, context) -> int:
    return epoch * context.SLOTS_PER_EPOCH


def compute_activation_exit_epoch(epoch: int, context) -> int:
    return checked_add(epoch, 1 + context.MAX_SEED_LOOKAHEAD)


def get_current_epoch(state, context) -> int:
    return compute_epoch_at_slot(state.slot, context)


def get_previous_epoch(state, context) -> int:
    current = get_current_epoch(state, context)
    return GENESIS_EPOCH if current == GENESIS_EPOCH else current - 1


# ---------------------------------------------------------------------------
# roots / mixes
# ---------------------------------------------------------------------------


def get_block_root_at_slot(state, slot: int) -> bytes:
    limit = len(state.block_roots)
    if not (slot < state.slot <= slot + limit):
        raise OutOfBoundsError(f"slot {slot} outside block-root window at {state.slot}")
    return state.block_roots[slot % limit]


def get_block_root(state, epoch: int, context) -> bytes:
    return get_block_root_at_slot(state, compute_start_slot_at_epoch(epoch, context))


def get_randao_mix(state, epoch: int) -> bytes:
    return state.randao_mixes[epoch % len(state.randao_mixes)]


# ---------------------------------------------------------------------------
# shuffling + committees
# ---------------------------------------------------------------------------


def compute_shuffled_index(index: int, count: int, seed: bytes, context) -> int:
    """Single-index swap-or-not shuffle (helpers.rs:249)."""
    if index >= count or count == 0:
        raise OutOfBoundsError("shuffle index out of range")
    for round_ in range(context.SHUFFLE_ROUND_COUNT):
        round_byte = round_.to_bytes(1, "little")
        pivot = int.from_bytes(_sha256(seed + round_byte)[:8], "little") % count
        flip = (pivot + count - index) % count
        position = max(index, flip)
        source = _sha256(seed + round_byte + (position // 256).to_bytes(4, "little"))
        byte = source[(position % 256) // 8]
        if (byte >> (position % 8)) & 1:
            index = flip
    return index


# full shuffle-result cache (FIFO eviction) — committee lookups hit the
# same seed for every committee of an epoch, so one whole-list shuffle
# (device kernel or the vectorized host map below) serves them all.
# Keyed by (seed, round count, len); two active sets CAN alias a key, so
# each entry stores its index list and hits are equality-guarded — an
# alias costs a recompute, never a wrong committee. Entries are
# three-slot lists ``[stored_indices, shuffled_list, shuffled_array]``:
# the list serves the committee slicers, the int64 array serves array
# consumers — ONE permutation compute feeds both sides.
_SHUFFLE_CACHE: dict = {}
_SHUFFLE_CACHE_MAX = 4

# Host whole-list threshold: below this the per-index map is cheaper than
# building (and caching) the full permutation.
HOST_SHUFFLE_MIN_N = 256


def _shuffled_array_vectorized(indices, seed: bytes, context):
    """The per-index swap-or-not map for ALL indices at once as numpy
    column ops: result[i] == indices[compute_shuffled_index(i, n, seed)]
    bit-for-bit, with ~rounds·(1 + n/256) digests instead of rounds·n —
    the host twin of the device kernel (ops/shuffle.py), playing the
    role of the reference's `shuffling` optimized feature
    (helpers.rs:287). Returns an int64 array."""
    import numpy as _np

    n = len(indices)
    pivots, sources = shuffle_sources(n, seed, context.SHUFFLE_ROUND_COUNT)
    idx = _np.arange(n, dtype=_np.int64)
    for pivot, source in zip(pivots, sources):
        flip = (pivot + n - idx) % n
        pos = _np.maximum(idx, flip)
        bit = (source[pos >> 3] >> (pos & 7).astype(_np.uint8)) & 1
        idx = _np.where(bit.astype(bool), flip, idx)
    arr = _np.fromiter(indices, dtype=_np.int64, count=n)
    return arr[idx]


def _compute_shuffled_pair(indices, seed: bytes, context):
    """ONE whole-list shuffle compute → (list, int64 array). Every
    actual permutation compute in the process flows through here: the
    CUDA kernel (ops/shuffle.py) at or above ``SHUFFLE_MIN_N`` indices
    when installed, else the vectorized host map."""
    import numpy as _np

    if _device_flags.shuffle_enabled(len(indices)):
        from ...ops.shuffle import shuffled_indices

        mapping = shuffled_indices(
            len(indices), seed, context.SHUFFLE_ROUND_COUNT,
            device=_device_flags.DEVICE,
        ).cpu().numpy()
        arr = _np.fromiter(indices, dtype=_np.int64, count=len(indices))[
            mapping
        ]
    else:
        arr = _shuffled_array_vectorized(indices, seed, context)
    arr.flags.writeable = False
    return arr.tolist(), arr


def _shuffle_cache_entry(indices, seed: bytes, context) -> list:
    """The cached ``[stored_indices, shuffled_list, shuffled_array]``
    entry for this (seed, active set), computing at most once per key.

    Key on (seed, rounds, len) with a stored-list equality guard: a
    C-speed list compare replaces the old per-lookup SHA-256 digest of
    the whole index list, which cost more than the cached shuffle it
    guarded (tens of thousands of committee lookups per epoch)."""
    key = (seed, context.SHUFFLE_ROUND_COUNT, len(indices))
    hit = _SHUFFLE_CACHE.get(key)
    if hit is not None:
        if hit[0] is indices:
            # fires on every lookup within one state now that
            # get_active_validator_indices returns a stable tuple
            return hit
        if tuple(hit[0]) == tuple(indices):
            # same active set from a DIFFERENT state object (fresh
            # deserialize of the same chain position): rebind the entry
            # so the O(n) equality check is paid once, not per lookup.
            # Never store a caller's mutable list — an in-place edit
            # would make the identity fast path serve a stale shuffle.
            hit[0] = indices if isinstance(indices, tuple) else tuple(indices)
            return hit
    shuffled, arr = _compute_shuffled_pair(indices, seed, context)
    # overwrite in place on key aliasing; evict only for genuinely new keys
    if key not in _SHUFFLE_CACHE and len(_SHUFFLE_CACHE) >= _SHUFFLE_CACHE_MAX:
        _SHUFFLE_CACHE.pop(next(iter(_SHUFFLE_CACHE)))
    entry = [
        indices if isinstance(indices, tuple) else list(indices),
        shuffled,
        arr,
    ]
    _SHUFFLE_CACHE[key] = entry
    return entry


def _shuffled_active_set(indices: list[int], seed: bytes, context) -> list[int]:
    return _shuffle_cache_entry(indices, seed, context)[1]


def shuffled_active_array(indices, seed: bytes, context):
    """The whole shuffled active set as a READ-ONLY int64 numpy array.
    Shares the per-seed cache with the list-serving committee path, so
    one epoch costs ONE shuffle no matter which side asks first."""
    return _shuffle_cache_entry(indices, seed, context)[2]


def compute_committee(
    indices: list[int], seed: bytes, index: int, count: int, context
) -> list[int]:
    """Slice ``index``/``count`` of the shuffled active set (spec
    compute_committee). Above HOST_SHUFFLE_MIN_N the whole active set is
    shuffled once — on device when installed (ops/shuffle.py), else via
    the vectorized host map — and cached per seed, so every committee of
    the epoch reuses one permutation."""
    start = len(indices) * index // count
    end = len(indices) * (index + 1) // count
    if len(indices) >= HOST_SHUFFLE_MIN_N or _device_flags.shuffle_enabled(
        len(indices)
    ):
        return _shuffled_active_set(indices, seed, context)[start:end]
    return [
        indices[compute_shuffled_index(i, len(indices), seed, context)]
        for i in range(start, end)
    ]


def compute_proposer_index(state, indices: list[int], seed: bytes, context) -> int:
    """Effective-balance-weighted proposer sampling (helpers.rs:400)."""
    if not indices:
        raise StateTransitionError("no active validators for proposer selection")
    max_random_byte = 255
    i = 0
    total = len(indices)
    while True:
        candidate = indices[compute_shuffled_index(i % total, total, seed, context)]
        random_byte = _sha256(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        effective = state.validators[candidate].effective_balance
        if effective * max_random_byte >= context.MAX_EFFECTIVE_BALANCE * random_byte:
            return candidate
        i += 1


def get_active_validator_indices(state, epoch: int) -> tuple[int, ...]:
    """Active-validator index TUPLE, cached on the state per
    (epoch, registry length). Returning the same immutable object on
    every hit (rather than a defensive list copy) matters twice at
    mainnet scale: the 131k-element copy itself (~0.5ms x hundreds of
    committee lookups per block), and downstream identity-keyed caches —
    the shuffle cache's `hit[0] is indices` fast path only fires when
    the same object comes back each call.

    Soundness: every spec mutation of the activity schedule targets a
    FUTURE epoch — `compute_activation_exit_epoch` is ≥ epoch+1+lookahead
    for both activations (registry updates) and exits/ejections
    (`initiate_validator_exit`), and slashing leaves activity unchanged —
    so within one (epoch, registry-length) window the active set is
    constant. Deposits append validators with far-future activation,
    changing the length key. (helpers.rs has no such cache; the sweep is
    free in Rust and 8k-element Python loops are not.)

    Contract limit: entries reflect the state AT CACHE TIME and spec
    flows only query previous/current/next epochs — all below the
    exit/activation scheduling horizon (current+1+lookahead). Code that
    BOTH writes exit/activation epochs directly (bypassing
    initiate_validator_exit) AND queries an epoch it already cached past
    that horizon would read a stale set; no spec path does."""
    cache = state.__dict__.get("_active_idx_cache")
    key = (epoch, len(state.validators))
    if isinstance(cache, dict):
        hit = cache.get(key)
        if hit is not None:
            return hit
    else:
        cache = None  # legacy tuple form (pre-r5 pickles) or absent
    # cache-miss full-registry sweep — the per-block hot scan
    out = tuple(
        i for i, v in enumerate(state.validators) if is_active_validator(v, epoch)
    )
    # REBIND a fresh dict rather than mutating in place: Container.copy()
    # shares the state __dict__ values, so an in-place insert would leak
    # a diverged copy's active set into the original (and vice versa) —
    # wrong committees/proposers. Rebinding keeps each state's view
    # frozen at copy time; the ≤4-entry rebuild only happens on a miss.
    # Keeping a few epochs matters because boundary processing alternates
    # previous/current-epoch queries — a single slot thrashed and every
    # rebuild broke the shuffle cache's identity fast path downstream.
    items = list(cache.items()) if cache else []
    if len(items) >= 4:
        items = items[1:]
    state.__dict__["_active_idx_cache"] = dict(items + [(key, out)])
    return out


def get_validator_churn_limit(state, context) -> int:
    active = len(get_active_validator_indices(state, get_current_epoch(state, context)))
    return max(context.min_per_epoch_churn_limit, active // context.churn_limit_quotient)


def get_seed(state, epoch: int, domain_type: DomainType, context) -> bytes:
    mix = get_randao_mix(
        state,
        epoch + context.EPOCHS_PER_HISTORICAL_VECTOR - context.MIN_SEED_LOOKAHEAD - 1,
    )
    return _sha256(domain_type.as_bytes() + epoch.to_bytes(8, "little") + mix)


def get_committee_count_per_slot(state, epoch: int, context) -> int:
    active = len(get_active_validator_indices(state, epoch))
    return max(
        1,
        min(
            context.MAX_COMMITTEES_PER_SLOT,
            active // context.SLOTS_PER_EPOCH // context.TARGET_COMMITTEE_SIZE,
        ),
    )


# alias matching older spec naming used by some callers
def get_committee_count_at_slot(state, slot: int, context) -> int:
    return get_committee_count_per_slot(
        state, compute_epoch_at_slot(slot, context), context
    )


def get_beacon_committee(state, slot: int, index: int, context) -> list[int]:
    """(helpers.rs:775)"""
    epoch = compute_epoch_at_slot(slot, context)
    committees_per_slot = get_committee_count_per_slot(state, epoch, context)
    indices = get_active_validator_indices(state, epoch)
    seed = get_seed(state, epoch, DomainType.BEACON_ATTESTER, context)
    return compute_committee(
        indices,
        seed,
        (slot % context.SLOTS_PER_EPOCH) * committees_per_slot + index,
        committees_per_slot * context.SLOTS_PER_EPOCH,
        context,
    )


def get_beacon_proposer_index(state, context) -> int:
    """(helpers.rs:808) — cached on the state per (slot, registry
    length): every input is intra-slot constant (the seed reads a PAST
    epoch's randao mix, so process_randao's current-mix write can't
    change it; effective balances only move in epoch processing, after
    which the slot advances). The altair sync-aggregate reward loop
    calls this once per participant (512× mainnet,
    altair/block_processing.rs:192-243) — the cache makes that O(1)."""
    cached = state.__dict__.get("_proposer_cache")
    key = (int(state.slot), len(state.validators))
    if cached is not None and cached[0] == key:
        # the cache-hit path stays span-free: the altair sync-aggregate
        # reward loop takes it 512x per block and the hit is ~a dict get
        return cached[1]
    epoch = get_current_epoch(state, context)
    seed = _sha256(
        get_seed(state, epoch, DomainType.BEACON_PROPOSER, context)
        + int(state.slot).to_bytes(8, "little")
    )
    indices = get_active_validator_indices(state, epoch)
    out = compute_proposer_index(state, indices, seed, context)
    state.__dict__["_proposer_cache"] = (key, out)
    return out


# ---------------------------------------------------------------------------
# balances
# ---------------------------------------------------------------------------


def get_total_balance(state, indices, context) -> int:
    total = sum(state.validators[i].effective_balance for i in set(indices))
    return max(context.EFFECTIVE_BALANCE_INCREMENT, total)


def get_total_active_balance(state, context) -> int:
    """Cached on the state per (epoch, registry length) — altair+ block
    processing consults this per attestation via
    get_base_reward_per_increment, and an O(registry) sum per aggregate
    (64/block at mainnet shape) dominated block time.

    Soundness: within one (epoch, registry-length) window the active set
    is fixed (see get_active_validator_indices) and effective balances
    only move in process_effective_balance_updates — which drops this
    cache explicitly. Balance (non-effective) writes, exits scheduled for
    future epochs, and slashing penalties never touch the inputs;
    deposits change the registry length key."""
    epoch = get_current_epoch(state, context)
    key = (epoch, len(state.validators))
    cached = state.__dict__.get("_total_active_balance_cache")
    if cached is not None and cached[0] == key:
        return cached[1]
    # cache-miss O(active-set) balance sum — the second hot scan
    total = get_total_balance(
        state, get_active_validator_indices(state, epoch), context
    )
    state.__dict__["_total_active_balance_cache"] = (key, total)
    return total


def increase_balance(state, index: int, delta: int) -> None:
    state.balances[index] = checked_add(state.balances[index], delta)


def decrease_balance(state, index: int, delta: int) -> None:
    state.balances[index] = saturating_sub(state.balances[index], delta)


# ---------------------------------------------------------------------------
# domains / signing
# ---------------------------------------------------------------------------


def compute_fork_data_root(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return ForkData.hash_tree_root(
        ForkData(
            current_version=current_version,
            genesis_validators_root=genesis_validators_root,
        )
    )


def compute_fork_digest(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return compute_fork_data_root(current_version, genesis_validators_root)[:4]


def compute_domain(
    domain_type: DomainType,
    fork_version: bytes | None,
    genesis_validators_root: bytes | None,
    context,
) -> bytes:
    if fork_version is None:
        fork_version = context.genesis_fork_version
    if genesis_validators_root is None:
        genesis_validators_root = b"\x00" * 32
    fork_data_root = compute_fork_data_root(fork_version, genesis_validators_root)
    return domain_type.as_bytes() + fork_data_root[:28]


def get_domain(state, domain_type: DomainType, epoch: int | None, context) -> bytes:
    if epoch is None:
        epoch = get_current_epoch(state, context)
    fork_version = (
        state.fork.previous_version
        if epoch < state.fork.epoch
        else state.fork.current_version
    )
    return compute_domain(
        domain_type, fork_version, state.genesis_validators_root, context
    )


# ---------------------------------------------------------------------------
# validator predicates
# ---------------------------------------------------------------------------


def is_active_validator(validator, epoch: int) -> bool:
    return validator.activation_epoch <= epoch < validator.exit_epoch


def is_eligible_for_activation_queue(validator, context) -> bool:
    return (
        validator.activation_eligibility_epoch == FAR_FUTURE_EPOCH
        and validator.effective_balance == context.MAX_EFFECTIVE_BALANCE
    )


def is_eligible_for_activation(state, validator) -> bool:
    return (
        validator.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
        and validator.activation_epoch == FAR_FUTURE_EPOCH
    )


def is_slashable_validator(validator, epoch: int) -> bool:
    return (
        not validator.slashed
        and validator.activation_epoch <= epoch < validator.withdrawable_epoch
    )


def is_slashable_attestation_data(data_1, data_2) -> bool:
    # double vote or surround vote
    double = data_1 != data_2 and data_1.target.epoch == data_2.target.epoch
    surround = (
        data_1.source.epoch < data_2.source.epoch
        and data_2.target.epoch < data_1.target.epoch
    )
    return double or surround


# ---------------------------------------------------------------------------
# attestations + signatures
# ---------------------------------------------------------------------------


def get_attesting_indices(state, data, bits: list[bool], context) -> set[int]:
    committee = get_beacon_committee(state, data.slot, data.index, context)
    if len(bits) != len(committee):
        raise InvalidIndexedAttestation(
            f"aggregation bits length {len(bits)} != committee size {len(committee)}"
        )
    return {idx for i, idx in enumerate(committee) if bits[i]}


def get_indexed_attestation(state, attestation, context):
    from .containers import build

    ns = build(context.preset)
    indices = get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits, context
    )
    return ns.IndexedAttestation(
        attesting_indices=sorted(indices),
        data=attestation.data.copy(),
        signature=attestation.signature,
    )


def _registry_pubkey_objects(state) -> list:
    """Lazily-filled ``PublicKey`` object memo per registry index, keyed
    by registry length in the state ``__dict__``.

    Soundness: the registry is append-only and a validator's public key
    is immutable once deposited, so index ``i`` maps to one key forever
    at a given length — filling a slot in the SHARED list (state copies
    share ``__dict__`` values) can only install the identical immutable
    object either side would have parsed. A deposit changes the length
    key, which REBINDS a fresh list (the _active_idx_cache discipline:
    never mutate a shared memo's SHAPE, only fill identical content)."""
    cached = state.__dict__.get("_pubkey_obj_cache")
    n = len(state.validators)
    if cached is not None and cached[0] == n:
        return cached[1]
    slots = [None] * n
    state.__dict__["_pubkey_obj_cache"] = (n, slots)
    return slots


def is_valid_indexed_attestation(state, indexed_attestation, context, error=None) -> None:
    """Raises on failure (helpers.rs:71). The BLS fast_aggregate_verify here
    is the #1 signature hot path (SURVEY.md §3.1): inside a
    ``collect_signatures`` scope the verification is deferred into the
    block's batch. ``error`` overrides the structured error used for a
    signature failure so callers keep their attribution (e.g.
    InvalidAttestation for process_attestation)."""
    indices = list(indexed_attestation.attesting_indices)
    if not indices:
        raise InvalidIndexedAttestation("no attesting indices")
    if indices != sorted(set(indices)):
        raise InvalidIndexedAttestation("attesting indices not sorted/unique")
    if any(i >= len(state.validators) for i in indices):
        raise InvalidIndexedAttestation("attesting index out of range")
    # registry keys are valid by the deposit rule, so the native
    # decompression defers to VERIFICATION time (bls.warm_raw_keys runs
    # the eight-wide bulk path there). The PublicKey OBJECTS are memoized per
    # registry index (_registry_pubkey_objects): re-parsing ~8k registry
    # keys per warm block was a measurable operations term at 2^17.
    pk_objects = _registry_pubkey_objects(state)
    from_validated = bls.PublicKey.from_validated_bytes
    validators = state.validators
    public_keys = []
    for i in indices:
        pk = pk_objects[i]
        if pk is None:
            pk = from_validated(validators[i].public_key)
            pk_objects[i] = pk
        public_keys.append(pk)
    domain = get_domain(
        state,
        DomainType.BEACON_ATTESTER,
        indexed_attestation.data.target.epoch,
        context,
    )
    signing_root = compute_signing_root(
        type(indexed_attestation.data), indexed_attestation.data, domain
    )
    signature = bls.Signature.from_bytes(indexed_attestation.signature)
    if error is None:
        error = InvalidIndexedAttestation("aggregate signature does not verify")
    verify_or_defer(public_keys, signing_root, signature, error)


def verify_block_signature(state, signed_block, context) -> None:
    """(helpers.rs:144) — deferred into the block batch when collecting."""
    from ...error import InvalidBlock

    block = signed_block.message
    if block.proposer_index >= len(state.validators):
        raise InvalidBlock("proposer index out of range")
    proposer = state.validators[block.proposer_index]
    domain = get_domain(state, DomainType.BEACON_PROPOSER, None, context)
    signing_root = compute_signing_root(type(block), block, domain)
    pk = bls.PublicKey.from_bytes(proposer.public_key)
    sig = bls.Signature.from_bytes(signed_block.signature)
    verify_or_defer([pk], signing_root, sig, InvalidBlock("invalid block signature"))


# ---------------------------------------------------------------------------
# exits + slashing
# ---------------------------------------------------------------------------


def initiate_validator_exit(state, index: int, context) -> None:
    validator = state.validators[index]
    if validator.exit_epoch != FAR_FUTURE_EPOCH:
        return
    exit_epochs = [
        v.exit_epoch for v in state.validators if v.exit_epoch != FAR_FUTURE_EPOCH
    ]
    exit_queue_epoch = max(
        exit_epochs + [compute_activation_exit_epoch(get_current_epoch(state, context), context)]
    )
    exit_queue_churn = sum(
        1 for v in state.validators if v.exit_epoch == exit_queue_epoch
    )
    if exit_queue_churn >= get_validator_churn_limit(state, context):
        exit_queue_epoch = checked_add(exit_queue_epoch, 1)
    validator.exit_epoch = exit_queue_epoch
    validator.withdrawable_epoch = checked_add(
        exit_queue_epoch, context.min_validator_withdrawability_delay
    )


def slash_validator(state, slashed_index: int, whistleblower_index: int | None, context) -> None:
    """(helpers.rs:1088)"""
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
        validator.effective_balance // context.MIN_SLASHING_PENALTY_QUOTIENT,
    )

    proposer_index = get_beacon_proposer_index(state, context)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    whistleblower_reward = (
        validator.effective_balance // context.WHISTLEBLOWER_REWARD_QUOTIENT
    )
    proposer_reward = whistleblower_reward // context.PROPOSER_REWARD_QUOTIENT
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower_index, whistleblower_reward - proposer_reward)
