"""phase0 block processing.

Reference parity: ethereum-consensus/src/phase0/block_processing.rs (805
LoC): process_block:765, process_operations:704, process_block_header:522,
process_randao:608, process_eth1_data:659, process_proposer_slashing:34,
process_attester_slashing:109, process_attestation:172, process_deposit:405
/ apply_deposit:351, process_voluntary_exit:448.
"""

from __future__ import annotations

from ...crypto import bls
from ...domains import DomainType
from ...error import (
    InvalidAttestation,
    InvalidAttesterSlashing,
    InvalidBeaconBlockHeader,
    InvalidBlock,
    InvalidDeposit,
    InvalidIndexedAttestation,
    InvalidOperation,
    InvalidProposerSlashing,
    InvalidRandao,
    InvalidVoluntaryExit,
    checked_add,
)
from ...primitives import FAR_FUTURE_EPOCH
from ...signing import compute_signing_root
from ...ssz import is_valid_merkle_branch
from ..signature_batch import verify_or_defer
from . import helpers as h
from .containers import (
    BeaconBlockHeader,
    DepositData,
    DepositMessage,
    Validator,
    DEPOSIT_CONTRACT_TREE_DEPTH,
)

__all__ = [
    "process_block",
    "process_block_header",
    "process_randao",
    "process_eth1_data",
    "process_operations",
    "process_proposer_slashing",
    "process_attester_slashing",
    "process_attestation",
    "process_deposit",
    "apply_deposit",
    "get_validator_from_deposit",
    "process_voluntary_exit",
]


def process_block_header(state, block, context) -> None:
    """(block_processing.rs:522)"""
    if block.slot != state.slot:
        raise InvalidBeaconBlockHeader(
            f"block slot {block.slot} != state slot {state.slot}"
        )
    if block.slot <= state.latest_block_header.slot:
        raise InvalidBeaconBlockHeader("block slot not newer than latest header")
    proposer_index = h.get_beacon_proposer_index(state, context)
    if block.proposer_index != proposer_index:
        raise InvalidBeaconBlockHeader(
            f"proposer {block.proposer_index} != expected {proposer_index}"
        )
    expected_parent = BeaconBlockHeader.hash_tree_root(state.latest_block_header)
    if block.parent_root != expected_parent:
        raise InvalidBeaconBlockHeader("parent root mismatch")

    state.latest_block_header = BeaconBlockHeader(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=b"\x00" * 32,  # overwritten at the next process_slot
        body_root=type(block.body).hash_tree_root(block.body),
    )

    proposer = state.validators[block.proposer_index]
    if proposer.slashed:
        raise InvalidBeaconBlockHeader("proposer is slashed")


def process_randao(state, body, context) -> None:
    """(block_processing.rs:608)"""
    epoch = h.get_current_epoch(state, context)
    proposer = state.validators[h.get_beacon_proposer_index(state, context)]
    domain = h.get_domain(state, DomainType.RANDAO, None, context)
    from ...ssz import uint64 as u64

    signing_root = compute_signing_root(u64, epoch, domain)
    pk = bls.PublicKey.from_bytes(proposer.public_key)
    try:
        sig = bls.Signature.from_bytes(body.randao_reveal)
    except Exception as exc:
        raise InvalidRandao(str(exc)) from exc
    verify_or_defer([pk], signing_root, sig, InvalidRandao("invalid randao reveal"))
    mix = h.xor(
        h.get_randao_mix(state, epoch), bls.hash(bytes(body.randao_reveal))
    )
    state.randao_mixes[epoch % context.EPOCHS_PER_HISTORICAL_VECTOR] = mix


def process_eth1_data(state, body, context) -> None:
    """(block_processing.rs:659)"""
    state.eth1_data_votes.append(body.eth1_data.copy())
    period_slots = context.EPOCHS_PER_ETH1_VOTING_PERIOD * context.SLOTS_PER_EPOCH
    votes = sum(1 for v in state.eth1_data_votes if v == body.eth1_data)
    if votes * 2 > period_slots:
        state.eth1_data = body.eth1_data.copy()


def process_proposer_slashing(state, proposer_slashing, context, slash_fn=None) -> None:
    """(block_processing.rs:34) — ``slash_fn`` lets later forks swap in
    their slash_validator (the only fork-varying piece)."""
    if slash_fn is None:
        slash_fn = h.slash_validator
    header_1 = proposer_slashing.signed_header_1.message
    header_2 = proposer_slashing.signed_header_2.message
    if header_1.slot != header_2.slot:
        raise InvalidProposerSlashing("headers at different slots")
    if header_1.proposer_index != header_2.proposer_index:
        raise InvalidProposerSlashing("headers for different proposers")
    if header_1 == header_2:
        raise InvalidProposerSlashing("headers are identical")
    index = header_1.proposer_index
    if index >= len(state.validators):
        raise InvalidProposerSlashing("proposer index out of range")
    proposer = state.validators[index]
    epoch = h.get_current_epoch(state, context)
    if not h.is_slashable_validator(proposer, epoch):
        raise InvalidProposerSlashing("proposer not slashable")
    for signed_header in (
        proposer_slashing.signed_header_1,
        proposer_slashing.signed_header_2,
    ):
        domain = h.get_domain(
            state,
            DomainType.BEACON_PROPOSER,
            h.compute_epoch_at_slot(signed_header.message.slot, context),
            context,
        )
        signing_root = compute_signing_root(
            BeaconBlockHeader, signed_header.message, domain
        )
        pk = bls.PublicKey.from_bytes(proposer.public_key)
        sig = bls.Signature.from_bytes(signed_header.signature)
        verify_or_defer(
            [pk], signing_root, sig,
            InvalidProposerSlashing("invalid header signature"),
        )
    slash_fn(state, index, None, context)


def process_attester_slashing(state, attester_slashing, context) -> None:
    """(block_processing.rs:109)"""
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
            h.slash_validator(state, index, None, context)
            slashed_any = True
    if not slashed_any:
        raise InvalidAttesterSlashing("no validator could be slashed")


def process_attestation(state, attestation, context) -> None:
    """(block_processing.rs:172)"""
    data = attestation.data
    current_epoch = h.get_current_epoch(state, context)
    previous_epoch = h.get_previous_epoch(state, context)
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

    from .containers import build

    ns = build(context.preset)
    pending = ns.PendingAttestation(
        aggregation_bits=list(attestation.aggregation_bits),
        data=data.copy(),
        inclusion_delay=state.slot - data.slot,
        proposer_index=h.get_beacon_proposer_index(state, context),
    )
    if data.target.epoch == current_epoch:
        if data.source != state.current_justified_checkpoint:
            raise InvalidAttestation("source != current justified checkpoint")
        state.current_epoch_attestations.append(pending)
    else:
        if data.source != state.previous_justified_checkpoint:
            raise InvalidAttestation("source != previous justified checkpoint")
        state.previous_epoch_attestations.append(pending)

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


def get_validator_from_deposit(deposit_data, context):
    amount = deposit_data.amount
    effective_balance = min(
        amount - amount % context.EFFECTIVE_BALANCE_INCREMENT,
        context.MAX_EFFECTIVE_BALANCE,
    )
    return Validator(
        public_key=deposit_data.public_key,
        withdrawal_credentials=deposit_data.withdrawal_credentials,
        effective_balance=effective_balance,
        slashed=False,
        activation_eligibility_epoch=FAR_FUTURE_EPOCH,
        activation_epoch=FAR_FUTURE_EPOCH,
        exit_epoch=FAR_FUTURE_EPOCH,
        withdrawable_epoch=FAR_FUTURE_EPOCH,
    )


def apply_deposit(
    state, deposit_data, context, pubkey_index=None, signature_valid=None
) -> None:
    """(block_processing.rs:351)

    ``pubkey_index`` (pubkey bytes → validator index) lets batch callers
    avoid the O(n) registry scan per deposit; ``signature_valid`` lets
    them supply a precomputed verdict for the (state-independent)
    deposit-signature check — genesis batches every deposit into one RLC
    multi-pairing. Semantics are unchanged: top-ups never consult the
    verdict, exactly as the inline path never verifies them."""
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
        state.validators.append(get_validator_from_deposit(deposit_data, context))
        state.balances.append(deposit_data.amount)
        if pubkey_index is not None:
            pubkey_index[bytes(public_key)] = len(state.validators) - 1
    else:
        h.increase_balance(state, existing, deposit_data.amount)


def deposit_signature_verdicts(deposits, context) -> "list[bool]":
    """Batched deposit-signature verdicts: the signing root depends only
    on the deposit data (genesis-fork domain, no state), so every
    deposit verifies in ONE RLC multi-pairing with per-set blame
    (verify_signature_sets) instead of a pairing pair per deposit.
    Unparseable keys/signatures get verdict False, like the inline
    path's exception handling."""
    verdicts = [False] * len(deposits)
    sets, slots = [], []
    domain = h.compute_domain(DomainType.DEPOSIT, None, None, context)
    for i, deposit in enumerate(deposits):
        data = deposit.data
        message = DepositMessage(
            public_key=data.public_key,
            withdrawal_credentials=data.withdrawal_credentials,
            amount=data.amount,
        )
        signing_root = compute_signing_root(DepositMessage, message, domain)
        try:
            pk = bls.PublicKey.from_bytes(data.public_key)
            sig = bls.Signature.from_bytes(data.signature)
        except Exception:  # noqa: BLE001 — unparseable ⇒ skipped deposit
            continue
        sets.append(bls.SignatureSet([pk], signing_root, sig))
        slots.append(i)
    for i, ok in zip(slots, bls.verify_signature_sets(sets)):
        verdicts[i] = bool(ok)
    return verdicts


def process_deposit(
    state, deposit, context, pubkey_index=None, signature_valid=None
) -> None:
    """(block_processing.rs:405)"""
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


def process_voluntary_exit(state, signed_voluntary_exit, context) -> None:
    """(block_processing.rs:448)"""
    voluntary_exit = signed_voluntary_exit.message
    if voluntary_exit.validator_index >= len(state.validators):
        raise InvalidVoluntaryExit("validator index out of range")
    validator = state.validators[voluntary_exit.validator_index]
    current_epoch = h.get_current_epoch(state, context)
    if not h.is_active_validator(validator, current_epoch):
        raise InvalidVoluntaryExit("validator not active")
    if validator.exit_epoch != FAR_FUTURE_EPOCH:
        raise InvalidVoluntaryExit("exit already initiated")
    if current_epoch < voluntary_exit.epoch:
        raise InvalidVoluntaryExit("exit epoch in the future")
    if current_epoch < validator.activation_epoch + context.shard_committee_period:
        raise InvalidVoluntaryExit("validator too young to exit")
    domain = h.get_domain(
        state, DomainType.VOLUNTARY_EXIT, voluntary_exit.epoch, context
    )
    signing_root = compute_signing_root(
        type(voluntary_exit), voluntary_exit, domain
    )
    pk = bls.PublicKey.from_bytes(validator.public_key)
    sig = bls.Signature.from_bytes(signed_voluntary_exit.signature)
    verify_or_defer(
        [pk], signing_root, sig, InvalidVoluntaryExit("invalid exit signature")
    )
    h.initiate_validator_exit(state, voluntary_exit.validator_index, context)


def process_operations(state, body, context) -> None:
    """(block_processing.rs:704)"""
    expected_deposits = min(
        context.MAX_DEPOSITS,
        state.eth1_data.deposit_count - state.eth1_deposit_index,
    )
    if len(body.deposits) != expected_deposits:
        raise InvalidOperation(
            f"expected {expected_deposits} deposits, block has {len(body.deposits)}"
        )
    for op in body.proposer_slashings:
        process_proposer_slashing(state, op, context)
    for op in body.attester_slashings:
        process_attester_slashing(state, op, context)
    for op in body.attestations:
        process_attestation(state, op, context)
    if body.deposits:
        # one O(n) index instead of an O(n) scan per deposit
        pubkey_index = {
            bytes(v.public_key): i for i, v in enumerate(state.validators)
        }
        for op in body.deposits:
            process_deposit(state, op, context, pubkey_index=pubkey_index)
    for op in body.voluntary_exits:
        process_voluntary_exit(state, op, context)


def process_block(state, block, context) -> None:
    """(block_processing.rs:765)"""
    process_block_header(state, block, context)
    process_randao(state, block.body, context)
    process_eth1_data(state, block.body, context)
    process_operations(state, block.body, context)
