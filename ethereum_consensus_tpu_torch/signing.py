"""Signing-root computation.

Reference parity: ethereum-consensus/src/signing.rs:7-30 (SigningData,
compute_signing_root). The BLS-backed ``sign_with_domain`` and
``verify_signed_data`` come with the port's BLS stack.
"""

from __future__ import annotations

from .ssz import ByteVector, Container

__all__ = [
    "SigningData",
    "compute_signing_root",
]


class SigningData(Container):
    """(signing.rs:7) — also re-exported via models.phase0.containers."""

    object_root: ByteVector[32]
    domain: ByteVector[32]


def compute_signing_root(ssz_type, value, domain: bytes) -> bytes:
    """hash_tree_root(SigningData(object_root, domain)).

    ``ssz_type`` is the SSZ descriptor/container class for ``value``; pass
    a Container instance alone by giving its class as the type."""
    object_root = ssz_type.hash_tree_root(value)
    return SigningData.hash_tree_root(
        SigningData(object_root=object_root, domain=domain)
    )
