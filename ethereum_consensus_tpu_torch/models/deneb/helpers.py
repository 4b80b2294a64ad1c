"""deneb spec helpers.

Reference parity: ethereum-consensus/src/deneb/helpers.rs —
kzg_commitment_to_versioned_hash:16, deneb
get_attestation_participation_flag_indices:23 (EIP-7045: target flag has no
inclusion-delay bound), get_validator_activation_churn_limit:86. Ported
from ethereum_consensus_tpu/models/deneb/helpers.py.
"""

from __future__ import annotations

from ...crypto.bls import hash as sha256
from ...error import InvalidAttestation
from .. import _diff
from ..altair.constants import (
    TIMELY_HEAD_FLAG_INDEX,
    TIMELY_SOURCE_FLAG_INDEX,
    TIMELY_TARGET_FLAG_INDEX,
)
from ..capella import helpers as _capella_helpers
from ..capella.helpers import (
    get_block_root,
    get_block_root_at_slot,
    get_current_epoch,
    get_validator_churn_limit,
    integer_squareroot,
)

__all__ = [
    "VERSIONED_HASH_VERSION_KZG",
    "kzg_commitment_to_versioned_hash",
    "get_attestation_participation_flag_indices",
    "get_validator_activation_churn_limit",
]

VERSIONED_HASH_VERSION_KZG = b"\x01"


def kzg_commitment_to_versioned_hash(kzg_commitment: bytes) -> bytes:
    """(helpers.rs:16)"""
    return VERSIONED_HASH_VERSION_KZG + sha256(bytes(kzg_commitment))[1:]


def get_attestation_participation_flag_indices(
    state, data, inclusion_delay: int, context
) -> list[int]:
    """(helpers.rs:23) — EIP-7045 drops the target-flag delay bound."""
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
    if is_matching_target:
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == context.MIN_ATTESTATION_INCLUSION_DELAY:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


def get_validator_activation_churn_limit(state, context) -> int:
    """(helpers.rs:86)"""
    return min(
        context.max_per_epoch_activation_churn_limit,
        get_validator_churn_limit(state, context),
    )


_diff.inherit(globals(), _capella_helpers)
