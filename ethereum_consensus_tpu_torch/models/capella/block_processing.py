"""capella block processing.

Reference parity: ethereum-consensus/src/capella/block_processing.rs —
process_bls_to_execution_change:23, process_operations:89 (adds the change
ops), process_execution_payload:166 (withdrawals root; unconditional parent
hash check), process_withdrawals:277, get_expected_withdrawals:348, capella
process_block. Ported from ethereum_consensus_tpu/models/capella/block_processing.py;
the trace spans around the withdrawals sweep wait for the telemetry slice.
"""

from __future__ import annotations

from ...crypto import bls
from ...domains import DomainType
from ...error import (
    CryptoError,
    InvalidBlsToExecutionChange,
    InvalidExecutionPayload,
    InvalidWithdrawals,
)
from ...execution_engine import verify_and_notify_new_payload
from ...primitives import BLS_WITHDRAWAL_PREFIX, ETH1_ADDRESS_WITHDRAWAL_PREFIX
from ...signing import compute_signing_root
from ..signature_batch import verify_or_defer
from .. import _diff
from .. import ops_vector as _ops_vector
from ..altair import block_processing as _altair_bp
from ..bellatrix import block_processing as _bellatrix_bp
from ..bellatrix.block_processing import (
    process_block_header,
    process_eth1_data,
    process_randao,
    process_sync_aggregate,
)
from ..bellatrix.containers import execution_payload_to_header
from . import helpers as h
from .containers import BlsToExecutionChange, Withdrawal

__all__ = [
    "process_bls_to_execution_change",
    "process_operations",
    "process_execution_payload",
    "process_withdrawals",
    "get_expected_withdrawals",
    "process_block",
]


def process_bls_to_execution_change(state, signed_address_change, context) -> None:
    """(block_processing.rs:23)"""
    address_change = signed_address_change.message
    if address_change.validator_index >= len(state.validators):
        raise InvalidBlsToExecutionChange("validator index out of bounds")
    validator = state.validators[address_change.validator_index]
    credentials = bytes(validator.withdrawal_credentials)
    if credentials[:1] != BLS_WITHDRAWAL_PREFIX:
        raise InvalidBlsToExecutionChange(
            f"credentials prefix {credentials[:1].hex()} is not the BLS prefix"
        )
    public_key = bytes(address_change.from_bls_public_key)
    if credentials[1:] != bls.hash(public_key)[1:]:
        raise InvalidBlsToExecutionChange(
            "from_bls_public_key does not match withdrawal credentials"
        )
    domain = h.compute_domain(
        DomainType.BLS_TO_EXECUTION_CHANGE,
        None,
        bytes(state.genesis_validators_root),
        context,
    )
    signing_root = compute_signing_root(BlsToExecutionChange, address_change, domain)
    try:
        pk = bls.PublicKey.from_bytes(public_key)
        sig = bls.Signature.from_bytes(bytes(signed_address_change.signature))
    except CryptoError as exc:
        raise InvalidBlsToExecutionChange(str(exc)) from exc
    verify_or_defer(
        [pk], signing_root, sig,
        InvalidBlsToExecutionChange("invalid address-change signature"),
    )

    validator.withdrawal_credentials = (
        ETH1_ADDRESS_WITHDRAWAL_PREFIX
        + b"\x00" * 11
        + bytes(address_change.to_execution_address)
    )


def process_operations(state, body, context) -> None:
    """(block_processing.rs:89)"""
    _altair_bp.process_operations(state, body, context, slash_fn=h.slash_validator)
    for op in body.bls_to_execution_changes:
        process_bls_to_execution_change(state, op, context)


def process_execution_payload(state, body, context) -> None:
    """(block_processing.rs:166) — parent-hash check is unconditional from
    capella on (every capella state is post-merge)."""
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

    verify_and_notify_new_payload(context.execution_engine, payload)

    state.latest_execution_payload_header = execution_payload_to_header(
        payload, type(state).__ssz_fields__["latest_execution_payload_header"]
    )


# below this registry size the literal loop costs less than the columns
WITHDRAWALS_VECTOR_MIN_VALIDATORS = 256


def get_expected_withdrawals(state, context) -> list:
    """(block_processing.rs:348) — columnar sweep (registry-column cache,
    models/ops_vector.py) when the registry is big enough to matter, with
    the literal per-index loop as the fallback (and the cross-checked
    oracle in tests)."""
    if len(state.validators) >= WITHDRAWALS_VECTOR_MIN_VALIDATORS:
        hits = _sweep_hits_vectorized(state, context)
        if hits is not None:
            withdrawal_index = state.next_withdrawal_index
            withdrawals = []
            for validator_index, full in hits:
                validator = state.validators[validator_index]
                balance = state.balances[validator_index]
                withdrawals.append(
                    Withdrawal(
                        index=withdrawal_index,
                        validator_index=validator_index,
                        address=bytes(validator.withdrawal_credentials)[12:],
                        amount=balance if full
                        else balance - context.MAX_EFFECTIVE_BALANCE,
                    )
                )
                withdrawal_index += 1
            return withdrawals
    return _get_expected_withdrawals_loop(state, context)


def _get_expected_withdrawals_loop(state, context) -> list:
    """The literal spec sweep (block_processing.rs:348)."""
    epoch = h.get_current_epoch(state, context)
    withdrawal_index = state.next_withdrawal_index
    validator_index = state.next_withdrawal_validator_index
    withdrawals = []
    bound = min(len(state.validators), context.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP)
    for _ in range(bound):
        validator = state.validators[validator_index]
        balance = state.balances[validator_index]
        if h.is_fully_withdrawable_validator(validator, balance, epoch):
            withdrawals.append(
                Withdrawal(
                    index=withdrawal_index,
                    validator_index=validator_index,
                    address=bytes(validator.withdrawal_credentials)[12:],
                    amount=balance,
                )
            )
            withdrawal_index += 1
        elif h.is_partially_withdrawable_validator(validator, balance, context):
            withdrawals.append(
                Withdrawal(
                    index=withdrawal_index,
                    validator_index=validator_index,
                    address=bytes(validator.withdrawal_credentials)[12:],
                    amount=balance - context.MAX_EFFECTIVE_BALANCE,
                )
            )
            withdrawal_index += 1
        if len(withdrawals) == context.MAX_WITHDRAWALS_PER_PAYLOAD:
            break
        validator_index = (validator_index + 1) % len(state.validators)
    return withdrawals


def _sweep_hits_vectorized(state, context) -> "list[tuple[int, bool]] | None":
    """(validator_index, is_full) of the sweep's first hits, in sweep
    order, capped at MAX_WITHDRAWALS_PER_PAYLOAD — exactly the indices
    the literal loop would emit. Columns come from the delta-refreshed
    registry-column cache (models/ops_vector.py) instead of per-block
    fromiter walks. None = fall back, with the reason counted in
    ``ops_vector.fallback.*`` so a degraded host is visible in bench
    ``metrics`` blocks instead of just slow."""
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
    epoch = h.get_current_epoch(state, context)
    prefix_ok = prefix == np.uint8(ETH1_ADDRESS_WITHDRAWAL_PREFIX[0])
    maxeb = np.uint64(int(context.MAX_EFFECTIVE_BALANCE))
    full = prefix_ok & (weps <= np.uint64(int(epoch))) & (bals > 0)
    part = prefix_ok & (effs == maxeb) & (bals > maxeb) & ~full
    hit = full | part
    bound = min(n, int(context.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP))
    cursor = int(state.next_withdrawal_validator_index)
    order = (np.arange(bound, dtype=np.int64) + cursor) % n
    sel = order[hit[order]][: int(context.MAX_WITHDRAWALS_PER_PAYLOAD)]
    return [(int(vi), bool(full[vi])) for vi in sel.tolist()]


def process_withdrawals(state, execution_payload, context) -> None:
    """(block_processing.rs:277)"""
    expected_withdrawals = get_expected_withdrawals(state, context)
    if list(execution_payload.withdrawals) != expected_withdrawals:
        raise InvalidWithdrawals(
            f"payload withdrawals do not match the {len(expected_withdrawals)} "
            "expected withdrawals for this state"
        )

    for withdrawal in expected_withdrawals:
        h.decrease_balance(state, withdrawal.validator_index, withdrawal.amount)

    if expected_withdrawals:
        state.next_withdrawal_index = expected_withdrawals[-1].index + 1

    if len(expected_withdrawals) == context.MAX_WITHDRAWALS_PER_PAYLOAD:
        # next sweep starts after the latest withdrawal's validator index
        state.next_withdrawal_validator_index = (
            expected_withdrawals[-1].validator_index + 1
        ) % len(state.validators)
    else:
        # advance the sweep by its max length when not saturated
        state.next_withdrawal_validator_index = (
            state.next_withdrawal_validator_index
            + context.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP
        ) % len(state.validators)


def process_block(state, block, context) -> None:
    """(block_processing.rs process_block, capella)"""
    process_block_header(state, block, context)
    process_withdrawals(state, block.body.execution_payload, context)
    process_execution_payload(state, block.body, context)
    process_randao(state, block.body, context)
    process_eth1_data(state, block.body, context)
    process_operations(state, block.body, context)
    process_sync_aggregate(state, block.body.sync_aggregate, context)


_diff.inherit(globals(), _bellatrix_bp)
