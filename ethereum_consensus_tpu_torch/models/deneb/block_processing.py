"""deneb block processing.

Reference parity: ethereum-consensus/src/deneb/block_processing.rs — deneb
process_attestation (EIP-7045: no upper inclusion bound),
process_execution_payload:138 (blob-commitment count + versioned hashes via
NewPayloadRequest), deneb process_voluntary_exit:271 (capella-domain
signing), deneb process_block. Ported from
ethereum_consensus_tpu/models/deneb/block_processing.py.
"""

from __future__ import annotations

from ...domains import DomainType
from ...error import (
    CryptoError,
    InvalidAttestation,
    InvalidBlobData,
    InvalidExecutionPayload,
    InvalidIndexedAttestation,
    InvalidVoluntaryExit,
)
from ...execution_engine import verify_and_notify_new_payload
from ...primitives import FAR_FUTURE_EPOCH
from ...crypto import bls
from ...signing import compute_signing_root
from ..signature_batch import verify_or_defer
from .. import _diff
from .. import ops_vector as _ops_vector
from ..altair import block_processing as _altair_bp
from ..bellatrix.containers import execution_payload_to_header
from ..capella import block_processing as _capella_bp
from ..capella.block_processing import (
    process_bls_to_execution_change,
    process_block_header,
    process_eth1_data,
    process_randao,
    process_sync_aggregate,
    process_withdrawals,
)
from ..phase0.containers import VoluntaryExit
from . import helpers as h
from .execution_engine import NewPayloadRequest

__all__ = [
    "process_attestation",
    "process_execution_payload",
    "process_voluntary_exit",
    "process_operations",
    "process_block",
]


def _prepare_attestation(state, attestation, context):
    """deneb validation half of process_attestation (EIP-7045: no upper
    inclusion bound). Returns ``(attesting_indices,
    participation_flag_indices, is_current)`` for the shared scalar apply
    and the columnar block engine."""
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


def process_attestation(state, attestation, context) -> None:
    """(block_processing.rs:26) — EIP-7045 removes the one-epoch upper
    inclusion bound; participation flags come from deneb helpers."""
    attesting_indices, participation_flag_indices, is_current = (
        _prepare_attestation(state, attestation, context)
    )
    _altair_bp._apply_attestation_participation(
        state, attesting_indices, participation_flag_indices, is_current,
        context, helpers=h,
    )


def process_execution_payload(state, body, context) -> None:
    """(block_processing.rs:138)"""
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


def process_voluntary_exit(state, signed_voluntary_exit, context) -> None:
    """(block_processing.rs:271) — the exit domain is pinned to the capella
    fork version from deneb onwards (EIP-7044)."""
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


def process_operations(state, body, context) -> None:
    """capella operations with the deneb attestation + voluntary-exit
    semantics."""
    _altair_bp.process_operations(
        state,
        body,
        context,
        slash_fn=h.slash_validator,
        attestation_fn=process_attestation,
        voluntary_exit_fn=process_voluntary_exit,
    )
    for op in body.bls_to_execution_changes:
        process_bls_to_execution_change(state, op, context)


def process_block(state, block, context) -> None:
    """(block_processing.rs process_block, deneb)"""
    process_block_header(state, block, context)
    process_withdrawals(state, block.body.execution_payload, context)
    process_execution_payload(state, block.body, context)
    process_randao(state, block.body, context)
    process_eth1_data(state, block.body, context)
    process_operations(state, block.body, context)
    process_sync_aggregate(state, block.body.sync_aggregate, context)


_diff.inherit(globals(), _capella_bp)

_ops_vector.register_attestation_preparer(
    process_attestation, _prepare_attestation, h
)
