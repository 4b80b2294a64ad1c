"""electra block processing.

Reference parity: ethereum-consensus/src/electra/block_processing.rs —
get_expected_withdrawals:33 (pending partials first), process_withdrawals,
process_execution_payload (deposit-receipt/withdrawal-request roots),
process_operations (EIP-6110 deposit-count rule + new op loops),
process_attestation:483 (EIP-7549), apply_deposit (pending balance
deposits), process_voluntary_exit (pending-withdrawal guard),
process_execution_layer_withdrawal_request:860, process_deposit_receipt:962,
process_consolidation:1008, electra process_block.

Ported from ethereum_consensus_tpu/models/electra/block_processing.py.
"""

from __future__ import annotations

from ...crypto import bls
from ...domains import DomainType
from ...error import (
    CryptoError,
    InvalidAttestation,
    InvalidBlobData,
    InvalidConsolidation,
    InvalidDeposit,
    InvalidExecutionPayload,
    InvalidIndexedAttestation,
    InvalidOperation,
    InvalidSignatureError,
    InvalidVoluntaryExit,
    InvalidWithdrawals,
    checked_add,
)
from ...execution_engine import verify_and_notify_new_payload
from ...primitives import FAR_FUTURE_EPOCH, UNSET_DEPOSIT_RECEIPTS_START_INDEX
from ...signing import compute_signing_root, verify_signed_data
from ...ssz import is_valid_merkle_branch
from ...utils import trace
from .. import _diff
from ..signature_batch import verify_or_defer
from ..bellatrix.containers import execution_payload_to_header
from ..capella.block_processing import (
    WITHDRAWALS_VECTOR_MIN_VALIDATORS,
    process_bls_to_execution_change,
)
from ..capella.containers import Withdrawal
from ..deneb import block_processing as _deneb_bp
from ..deneb.block_processing import (
    process_block_header,
    process_eth1_data,
    process_randao,
    process_sync_aggregate,
)
from ..deneb.execution_engine import NewPayloadRequest
from .. import ops_vector as _ops_vector
from ..altair import block_processing as _altair_bp
from ..altair.block_processing import (
    process_attester_slashing as _altair_attester_slashing,
)
from ..phase0.block_processing import (
    process_proposer_slashing as _phase0_proposer_slashing,
)
from ..phase0.containers import (
    DEPOSIT_CONTRACT_TREE_DEPTH,
    DepositData,
    DepositMessage,
    Validator,
    VoluntaryExit,
)
from . import helpers as h
from .containers import Consolidation, PendingPartialWithdrawal

__all__ = [
    "FULL_EXIT_REQUEST_AMOUNT",
    "get_expected_withdrawals",
    "process_withdrawals",
    "process_execution_payload",
    "process_operations",
    "process_attestation",
    "process_attester_slashing",
    "is_valid_deposit_signature",
    "get_validator_from_deposit",
    "add_validator_to_registry",
    "apply_deposit",
    "process_deposit",
    "process_voluntary_exit",
    "process_execution_layer_withdrawal_request",
    "process_deposit_receipt",
    "process_consolidation",
    "process_block",
]

FULL_EXIT_REQUEST_AMOUNT = 0  # (constants.rs:4)


def get_expected_withdrawals(state, context) -> tuple[list, int]:
    """(block_processing.rs:33) → (withdrawals, partial_withdrawals_count).

    The pending partial withdrawals come first; the registry sweep then
    runs over ``ops_vector.withdrawal_columns`` from
    ``WITHDRAWALS_VECTOR_MIN_VALIDATORS`` validators, and as the literal
    loop below it (the oracle) or when the columns decline."""
    epoch = h.get_current_epoch(state, context)
    withdrawal_index = state.next_withdrawal_index
    validator_index = state.next_withdrawal_validator_index
    withdrawals: list = []

    # pending partial withdrawals first (EIP-7251) — spec-capped per
    # sweep, stays scalar
    for withdrawal in state.pending_partial_withdrawals:
        if withdrawal.withdrawable_epoch > epoch:
            break
        if len(withdrawals) == context.MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP:
            break
        validator = state.validators[withdrawal.index]
        balance = state.balances[withdrawal.index]
        has_sufficient_effective_balance = (
            validator.effective_balance > context.MIN_ACTIVATION_BALANCE
        )
        has_excess_balance = balance > context.MIN_ACTIVATION_BALANCE
        if (
            validator.exit_epoch == FAR_FUTURE_EPOCH
            and has_sufficient_effective_balance
            and has_excess_balance
        ):
            withdrawable_balance = min(
                balance - context.MIN_ACTIVATION_BALANCE, withdrawal.amount
            )
            withdrawals.append(
                Withdrawal(
                    index=withdrawal_index,
                    validator_index=withdrawal.index,
                    address=bytes(validator.withdrawal_credentials)[12:],
                    amount=withdrawable_balance,
                )
            )
            withdrawal_index += 1

    partial_withdrawals_count = len(withdrawals)

    n = len(state.validators)
    remaining = context.MAX_WITHDRAWALS_PER_PAYLOAD - len(withdrawals)
    if n >= WITHDRAWALS_VECTOR_MIN_VALIDATORS and remaining > 0:
        with trace.span("ops_vector.withdrawals", validators=n):
            hits = _sweep_hits_vectorized(state, context, remaining)
        if hits is not None:
            for vi, amount in hits:
                validator = state.validators[vi]
                withdrawals.append(
                    Withdrawal(
                        index=withdrawal_index,
                        validator_index=vi,
                        address=bytes(validator.withdrawal_credentials)[12:],
                        amount=amount,
                    )
                )
                withdrawal_index += 1
            return withdrawals, partial_withdrawals_count

    with trace.span("electra.withdrawals_sweep", validators=n):
        bound = min(n, context.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP)
        for _ in range(bound):
            validator = state.validators[validator_index]
            balance = state.balances[validator_index]
            if h.is_fully_withdrawable_validator(validator, balance, epoch):
                amount = balance
            elif h.is_partially_withdrawable_validator(validator, balance, context):
                amount = balance - h.get_validator_max_effective_balance(
                    validator, context
                )
            else:
                amount = None
            if amount is not None:
                withdrawals.append(
                    Withdrawal(
                        index=withdrawal_index,
                        validator_index=validator_index,
                        address=bytes(validator.withdrawal_credentials)[12:],
                        amount=amount,
                    )
                )
                withdrawal_index += 1
            if len(withdrawals) == context.MAX_WITHDRAWALS_PER_PAYLOAD:
                break
            validator_index = (validator_index + 1) % len(state.validators)

    return withdrawals, partial_withdrawals_count


def _sweep_hits_vectorized(state, context, cap: int):
    """(validator_index, amount) of the electra registry sweep's first
    hits in sweep order, capped at ``cap`` — exactly what the literal
    loop would emit (full withdrawals at ``balance``, partials at
    ``balance − per-validator max effective balance``, EIP-7251
    compounding-aware). None = scalar fallback (reason counted in
    ``ops_vector.fallback.*``)."""
    try:
        import numpy as np
    except Exception:  # noqa: BLE001 — environment without numpy
        _ops_vector.fallback("no_numpy")
        return None
    cols = _ops_vector.withdrawal_columns(state)
    if cols is None:
        return None
    prefix = cols["withdrawal_prefix"]
    weps = cols["withdrawable_epoch"]
    effs = cols["effective_balance"]
    bals = cols["balances"]
    n = bals.shape[0]
    epoch = np.uint64(int(h.get_current_epoch(state, context)))
    has_exec = (prefix == np.uint8(0x01)) | (prefix == np.uint8(0x02))
    maxeb = np.where(
        prefix == np.uint8(0x02),
        np.uint64(int(context.MAX_EFFECTIVE_BALANCE_ELECTRA)),
        np.uint64(int(context.MIN_ACTIVATION_BALANCE)),
    )
    full = has_exec & (weps <= epoch) & (bals > 0)
    part = has_exec & (effs == maxeb) & (bals > maxeb) & ~full
    hit = full | part
    bound = min(n, int(context.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP))
    cursor = int(state.next_withdrawal_validator_index)
    order = (np.arange(bound, dtype=np.int64) + cursor) % n
    sel = order[hit[order]][:cap]
    return [
        (vi, int(bals[vi]) if full[vi] else int(bals[vi] - maxeb[vi]))
        for vi in sel.tolist()
    ]


def process_withdrawals(state, execution_payload, context) -> None:
    """(block_processing.rs electra process_withdrawals)"""
    expected_withdrawals, partial_withdrawals_count = get_expected_withdrawals(
        state, context
    )
    if list(execution_payload.withdrawals) != expected_withdrawals:
        raise InvalidWithdrawals(
            f"payload withdrawals do not match the {len(expected_withdrawals)} "
            "expected withdrawals for this state"
        )

    for withdrawal in expected_withdrawals:
        h.decrease_balance(state, withdrawal.validator_index, withdrawal.amount)

    del state.pending_partial_withdrawals[:partial_withdrawals_count]

    if expected_withdrawals:
        state.next_withdrawal_index = expected_withdrawals[-1].index + 1

    if len(expected_withdrawals) == context.MAX_WITHDRAWALS_PER_PAYLOAD:
        state.next_withdrawal_validator_index = (
            expected_withdrawals[-1].validator_index + 1
        ) % len(state.validators)
    else:
        state.next_withdrawal_validator_index = (
            state.next_withdrawal_validator_index
            + context.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP
        ) % len(state.validators)


def process_execution_payload(state, body, context) -> None:
    """(block_processing.rs electra process_execution_payload)"""
    payload = body.execution_payload

    expected = state.latest_execution_payload_header.block_hash
    if payload.parent_hash != expected:
        raise InvalidExecutionPayload(
            f"payload parent hash {bytes(payload.parent_hash).hex()} != "
            f"latest payload block hash {bytes(expected).hex()}"
        )

    current_epoch = h.get_current_epoch(state, context)
    if payload.prev_randao != h.get_randao_mix(state, current_epoch):
        raise InvalidExecutionPayload("payload prev_randao != randao mix")

    timestamp = h.compute_timestamp_at_slot(state, state.slot, context)
    if payload.timestamp != timestamp:
        raise InvalidExecutionPayload(
            f"payload timestamp {payload.timestamp} != slot timestamp {timestamp}"
        )

    if len(body.blob_kzg_commitments) > context.MAX_BLOBS_PER_BLOCK:
        raise InvalidBlobData(
            f"{len(body.blob_kzg_commitments)} blob commitments exceed the "
            f"per-block limit {context.MAX_BLOBS_PER_BLOCK}"
        )

    versioned_hashes = [
        h.kzg_commitment_to_versioned_hash(c) for c in body.blob_kzg_commitments
    ]
    request = NewPayloadRequest(
        execution_payload=payload,
        versioned_hashes=versioned_hashes,
        parent_beacon_block_root=bytes(state.latest_block_header.parent_root),
    )
    verify_and_notify_new_payload(context.execution_engine, request)

    state.latest_execution_payload_header = execution_payload_to_header(
        payload, type(state).__ssz_fields__["latest_execution_payload_header"]
    )


def _prepare_attestation(state, attestation, context):
    """electra validation half of process_attestation (EIP-7549 committee
    bits). Returns ``(attesting_indices, participation_flag_indices,
    is_current)`` for the shared scalar apply and the columnar block
    engine."""
    data = attestation.data
    current_epoch = h.get_current_epoch(state, context)
    previous_epoch = h.get_previous_epoch(state, context)
    is_current = data.target.epoch == current_epoch
    if data.target.epoch not in (previous_epoch, current_epoch):
        raise InvalidAttestation("target epoch not current or previous")
    if data.target.epoch != h.compute_epoch_at_slot(data.slot, context):
        raise InvalidAttestation("target epoch does not match slot")
    if not data.slot + context.MIN_ATTESTATION_INCLUSION_DELAY <= state.slot:
        raise InvalidAttestation("attestation included too early")
    if data.index != 0:
        raise InvalidAttestation("attestation data index must be 0 in electra")

    committee_indices = h.get_committee_indices(attestation.committee_bits)
    committee_count = h.get_committee_count_per_slot(
        state, data.target.epoch, context
    )
    participants_count = 0
    for index in committee_indices:
        if index >= committee_count:
            raise InvalidAttestation("committee index out of range")
        participants_count += len(
            h.get_beacon_committee(state, data.slot, index, context)
        )
    if len(attestation.aggregation_bits) != participants_count:
        raise InvalidAttestation("aggregation bits != summed committee sizes")

    inclusion_delay = state.slot - data.slot
    participation_flag_indices = h.get_attestation_participation_flag_indices(
        state, data, inclusion_delay, context
    )

    indexed = h.get_indexed_attestation(state, attestation, context)
    try:
        h.is_valid_indexed_attestation(
            state, indexed, context,
            error=InvalidAttestation(
                f"attestation at slot {data.slot}: aggregate signature does "
                "not verify"
            ),
        )
    except InvalidIndexedAttestation as exc:
        raise InvalidAttestation(str(exc)) from exc

    attesting_indices = h.get_attesting_indices(state, attestation, context)
    return attesting_indices, participation_flag_indices, is_current


def process_attestation(state, attestation, context) -> None:
    """(block_processing.rs:483) — EIP-7549 committee bits."""
    attesting_indices, participation_flag_indices, is_current = (
        _prepare_attestation(state, attestation, context)
    )
    _altair_bp._apply_attestation_participation(
        state, attesting_indices, participation_flag_indices, is_current,
        context, helpers=h,
    )


def process_attester_slashing(state, attester_slashing, context) -> None:
    """phase0 shape over electra IndexedAttestation + electra slashing."""
    _altair_attester_slashing(
        state, attester_slashing, context, slash_fn=h.slash_validator
    )


def is_valid_deposit_signature(
    public_key: bytes, withdrawal_credentials: bytes, amount: int, signature: bytes,
    context,
) -> bool:
    deposit_message = DepositMessage(
        public_key=public_key,
        withdrawal_credentials=withdrawal_credentials,
        amount=amount,
    )
    domain = h.compute_domain(DomainType.DEPOSIT, None, None, context)
    try:
        verify_signed_data(
            DepositMessage, deposit_message, bytes(signature), bytes(public_key), domain
        )
        return True
    except (InvalidSignatureError, Exception):
        return False


def get_validator_from_deposit(public_key: bytes, withdrawal_credentials: bytes):
    """(block_processing.rs get_validator_from_deposit) — zero effective
    balance; topped up by the pending-balance-deposit queue."""
    return Validator(
        public_key=public_key,
        withdrawal_credentials=withdrawal_credentials,
        effective_balance=0,
        slashed=False,
        activation_eligibility_epoch=FAR_FUTURE_EPOCH,
        activation_epoch=FAR_FUTURE_EPOCH,
        exit_epoch=FAR_FUTURE_EPOCH,
        withdrawable_epoch=FAR_FUTURE_EPOCH,
    )


def _validator_index(state, public_key: bytes):
    """The FIRST registry index holding ``public_key``, or None — the
    spec's ``pubkeys.index`` scan. Served from the state's cached
    pubkey index (``altair.block_processing._registry_pubkey_index``,
    which the sync aggregate builds every block) when the registry has
    no repeated key, so the index of each key is unique; a registry with
    a repeated key takes the literal scan."""
    by_key = _altair_bp._registry_pubkey_index(state)
    if len(by_key) == len(state.validators):
        return by_key.get(public_key)
    for i, v in enumerate(state.validators):
        if bytes(v.public_key) == public_key:
            return i
    return None


def add_validator_to_registry(
    state, public_key: bytes, withdrawal_credentials: bytes, amount: int
) -> None:
    from .containers import PendingBalanceDeposit

    index = len(state.validators)
    state.validators.append(
        get_validator_from_deposit(public_key, withdrawal_credentials)
    )
    state.balances.append(0)
    state.previous_epoch_participation.append(0)
    state.current_epoch_participation.append(0)
    state.inactivity_scores.append(0)
    state.pending_balance_deposits.append(
        PendingBalanceDeposit(index=index, amount=amount)
    )


def apply_deposit(
    state, public_key: bytes, withdrawal_credentials: bytes, amount: int,
    signature: bytes, context, signature_valid=None,
) -> None:
    """(block_processing.rs electra apply_deposit) — EIP-7251 semantics:
    top-ups queue pending balance deposits; a valid-signature compounding
    top-up upgrades eth1 credentials. ``signature_valid`` supplies a
    precomputed verdict (genesis batches every deposit signature into one
    RLC multi-pairing; the deposit signing root is state-independent)."""
    from .containers import PendingBalanceDeposit

    def _sig_ok() -> bool:
        if signature_valid is not None:
            return bool(signature_valid)
        return is_valid_deposit_signature(
            public_key, withdrawal_credentials, amount, signature, context
        )

    public_key = bytes(public_key)
    index = _validator_index(state, public_key)
    if index is not None:
        state.pending_balance_deposits.append(
            PendingBalanceDeposit(index=index, amount=amount)
        )
        if _sig_ok():
            if h.is_compounding_withdrawal_credential(
                withdrawal_credentials
            ) and h.has_eth1_withdrawal_credential(state.validators[index]):
                h.switch_to_compounding_validator(state, index, context)
        return

    if not _sig_ok():
        return  # invalid deposit signatures are skipped, not errors
    add_validator_to_registry(state, public_key, withdrawal_credentials, amount)


def process_deposit(state, deposit, context, signature_valid=None) -> None:
    """phase0 merkle proof + electra apply_deposit."""
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
        state,
        deposit.data.public_key,
        deposit.data.withdrawal_credentials,
        deposit.data.amount,
        deposit.data.signature,
        context,
        signature_valid=signature_valid,
    )


def process_voluntary_exit(state, signed_voluntary_exit, context) -> None:
    """(block_processing.rs electra process_voluntary_exit) — deneb
    semantics + zero-pending-withdrawal guard."""
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
    if h.get_pending_balance_to_withdraw(state, voluntary_exit.validator_index) != 0:
        raise InvalidVoluntaryExit("pending partial withdrawals must clear first")
    domain = h.compute_domain(
        DomainType.VOLUNTARY_EXIT,
        context.capella_fork_version,
        bytes(state.genesis_validators_root),
        context,
    )
    signing_root = compute_signing_root(VoluntaryExit, voluntary_exit, domain)
    try:
        pk = bls.PublicKey.from_bytes(bytes(validator.public_key))
        sig = bls.Signature.from_bytes(bytes(signed_voluntary_exit.signature))
    except CryptoError as exc:
        raise InvalidVoluntaryExit(str(exc)) from exc
    verify_or_defer(
        [pk], signing_root, sig, InvalidVoluntaryExit("invalid exit signature")
    )
    h.initiate_validator_exit(state, voluntary_exit.validator_index, context)


def process_execution_layer_withdrawal_request(state, request, context) -> None:
    """(block_processing.rs:860) — EIP-7002; invalid requests no-op."""
    amount = request.amount
    is_full_exit_request = amount == FULL_EXIT_REQUEST_AMOUNT

    if (
        len(state.pending_partial_withdrawals)
        == context.PENDING_PARTIAL_WITHDRAWALS_LIMIT
        and not is_full_exit_request
    ):
        return

    index = _validator_index(state, bytes(request.validator_public_key))
    if index is None:
        return
    validator = state.validators[index]

    has_correct_credential = h.has_execution_withdrawal_credential(validator)
    is_correct_source_address = (
        bytes(validator.withdrawal_credentials)[12:] == bytes(request.source_address)
    )
    if not (has_correct_credential and is_correct_source_address):
        return

    current_epoch = h.get_current_epoch(state, context)
    if not h.is_active_validator(validator, current_epoch):
        return
    if validator.exit_epoch != FAR_FUTURE_EPOCH:
        return
    if current_epoch < validator.activation_epoch + context.shard_committee_period:
        return

    pending_balance_to_withdraw = h.get_pending_balance_to_withdraw(state, index)

    if is_full_exit_request:
        if pending_balance_to_withdraw == 0:
            h.initiate_validator_exit(state, index, context)
        return

    has_sufficient_effective_balance = (
        validator.effective_balance >= context.MIN_ACTIVATION_BALANCE
    )
    has_excess_balance = (
        state.balances[index]
        > context.MIN_ACTIVATION_BALANCE + pending_balance_to_withdraw
    )
    if (
        h.has_compounding_withdrawal_credential(validator)
        and has_sufficient_effective_balance
        and has_excess_balance
    ):
        to_withdraw = min(
            state.balances[index]
            - context.MIN_ACTIVATION_BALANCE
            - pending_balance_to_withdraw,
            amount,
        )
        exit_queue_epoch = h.compute_exit_epoch_and_update_churn(
            state, to_withdraw, context
        )
        withdrawable_epoch = (
            exit_queue_epoch + context.min_validator_withdrawability_delay
        )
        state.pending_partial_withdrawals.append(
            PendingPartialWithdrawal(
                index=index,
                amount=to_withdraw,
                withdrawable_epoch=withdrawable_epoch,
            )
        )


def process_deposit_receipt(state, deposit_receipt, context) -> None:
    """(block_processing.rs:962) — EIP-6110."""
    if state.deposit_receipts_start_index == UNSET_DEPOSIT_RECEIPTS_START_INDEX:
        state.deposit_receipts_start_index = deposit_receipt.index
    apply_deposit(
        state,
        deposit_receipt.public_key,
        deposit_receipt.withdrawal_credentials,
        deposit_receipt.amount,
        deposit_receipt.signature,
        context,
    )


def process_consolidation(state, signed_consolidation, context) -> None:
    """(block_processing.rs:1008) — EIP-7251."""
    from .containers import PendingConsolidation

    if len(state.pending_consolidations) >= context.PENDING_CONSOLIDATIONS_LIMIT:
        raise InvalidConsolidation("pending consolidations queue is full")
    if (
        h.get_consolidation_churn_limit(state, context)
        <= context.MIN_ACTIVATION_BALANCE
    ):
        raise InvalidConsolidation("insufficient consolidation churn limit")

    consolidation = signed_consolidation.message
    if consolidation.source_index == consolidation.target_index:
        raise InvalidConsolidation("source and target are the same validator")
    if consolidation.source_index >= len(state.validators):
        raise InvalidConsolidation("source index out of range")
    if consolidation.target_index >= len(state.validators):
        raise InvalidConsolidation("target index out of range")
    source_validator = state.validators[consolidation.source_index]
    target_validator = state.validators[consolidation.target_index]

    current_epoch = h.get_current_epoch(state, context)
    if not h.is_active_validator(source_validator, current_epoch):
        raise InvalidConsolidation("source validator not active")
    if not h.is_active_validator(target_validator, current_epoch):
        raise InvalidConsolidation("target validator not active")
    if source_validator.exit_epoch != FAR_FUTURE_EPOCH:
        raise InvalidConsolidation("source exit already initiated")
    if target_validator.exit_epoch != FAR_FUTURE_EPOCH:
        raise InvalidConsolidation("target exit already initiated")
    if current_epoch < consolidation.epoch:
        raise InvalidConsolidation("consolidation epoch in the future")

    if not h.has_execution_withdrawal_credential(source_validator):
        raise InvalidConsolidation("source lacks execution withdrawal credential")
    if not h.has_execution_withdrawal_credential(target_validator):
        raise InvalidConsolidation("target lacks execution withdrawal credential")
    if (
        bytes(source_validator.withdrawal_credentials)[12:]
        != bytes(target_validator.withdrawal_credentials)[12:]
    ):
        raise InvalidConsolidation("source/target withdrawal addresses differ")

    domain = h.compute_domain(
        DomainType.CONSOLIDATION,
        None,
        bytes(state.genesis_validators_root),
        context,
    )
    signing_root = compute_signing_root(Consolidation, consolidation, domain)
    try:
        pks = [
            bls.PublicKey.from_bytes(bytes(source_validator.public_key)),
            bls.PublicKey.from_bytes(bytes(target_validator.public_key)),
        ]
        sig = bls.Signature.from_bytes(bytes(signed_consolidation.signature))
    except CryptoError as exc:
        raise InvalidConsolidation(str(exc)) from exc
    verify_or_defer(
        pks, signing_root, sig,
        InvalidConsolidation("invalid consolidation signature"),
    )

    source_validator.exit_epoch = h.compute_consolidation_epoch_and_update_churn(
        state, source_validator.effective_balance, context
    )
    source_validator.withdrawable_epoch = (
        source_validator.exit_epoch + context.min_validator_withdrawability_delay
    )
    state.pending_consolidations.append(
        PendingConsolidation(
            source_index=consolidation.source_index,
            target_index=consolidation.target_index,
        )
    )


def process_operations(state, body, context) -> None:
    """(block_processing.rs electra process_operations) — EIP-6110 caps
    eth1-bridge deposits at deposit_receipts_start_index."""
    eth1_deposit_index_limit = min(
        state.eth1_data.deposit_count, state.deposit_receipts_start_index
    )
    if state.eth1_deposit_index < eth1_deposit_index_limit:
        expected = min(
            context.MAX_DEPOSITS,
            eth1_deposit_index_limit - state.eth1_deposit_index,
        )
        if len(body.deposits) != expected:
            raise InvalidOperation(
                f"expected {expected} deposits, block has {len(body.deposits)}"
            )
    elif len(body.deposits) != 0:
        raise InvalidOperation("expected 0 deposits after EIP-6110 transition")

    for op in body.proposer_slashings:
        _phase0_proposer_slashing(state, op, context, slash_fn=h.slash_validator)
    for op in body.attester_slashings:
        process_attester_slashing(state, op, context)
    # block-scoped columnar fast path (models/ops_vector.py): validation
    # through _prepare_attestation, one bulk_store per participation list;
    # the scalar loop is the fallback and the differential-test oracle
    if not _ops_vector.process_attestations_batch(
        state, body.attestations, context, process_attestation
    ):
        for op in body.attestations:
            process_attestation(state, op, context)
    for op in body.deposits:
        process_deposit(state, op, context)
    for op in body.voluntary_exits:
        process_voluntary_exit(state, op, context)
    for op in body.bls_to_execution_changes:
        process_bls_to_execution_change(state, op, context)
    for op in body.execution_payload.withdrawal_requests:
        process_execution_layer_withdrawal_request(state, op, context)
    for op in body.execution_payload.deposit_receipts:
        process_deposit_receipt(state, op, context)
    for op in body.consolidations:
        process_consolidation(state, op, context)


def process_block(state, block, context) -> None:
    """(block_processing.rs electra process_block)"""
    process_block_header(state, block, context)
    process_withdrawals(state, block.body.execution_payload, context)
    process_execution_payload(state, block.body, context)
    process_randao(state, block.body, context)
    process_eth1_data(state, block.body, context)
    process_operations(state, block.body, context)
    process_sync_aggregate(state, block.body.sync_aggregate, context)


_diff.inherit(globals(), _deneb_bp)

_ops_vector.register_attestation_preparer(
    process_attestation, _prepare_attestation, h
)
