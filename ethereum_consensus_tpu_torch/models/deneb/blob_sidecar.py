"""Blob sidecar verification.

Reference parity: ethereum-consensus/src/deneb/blob_sidecar.rs:47 —
verify_blob_sidecar_inclusion_proof checks the commitment's merkle branch
against the signed block header's body root. Ported from
ethereum_consensus_tpu/models/deneb/blob_sidecar.py.
"""

from __future__ import annotations

from ...primitives import KzgCommitmentBytes
from ...ssz import get_generalized_index, is_valid_merkle_branch

__all__ = ["verify_blob_sidecar_inclusion_proof", "get_subtree_index"]


def get_subtree_index(generalized_index: int) -> int:
    """gindex → index within its depth level."""
    return generalized_index - (1 << (generalized_index.bit_length() - 1))


def verify_blob_sidecar_inclusion_proof(blob_sidecar, body_cls, context) -> bool:
    """(blob_sidecar.rs:47) — ``body_cls`` is the fork's BeaconBlockBody."""
    g_index = get_generalized_index(
        body_cls, "blob_kzg_commitments", int(blob_sidecar.index)
    )
    leaf = KzgCommitmentBytes.hash_tree_root(blob_sidecar.kzg_commitment)
    return is_valid_merkle_branch(
        leaf,
        [bytes(b) for b in blob_sidecar.kzg_commitment_inclusion_proof],
        context.KZG_COMMITMENT_INCLUSION_PROOF_DEPTH,
        get_subtree_index(g_index),
        bytes(blob_sidecar.signed_block_header.message.body_root),
    )
