"""Signing-root computation and domain-signed operations.

Reference parity: ethereum-consensus/src/signing.rs:7-30 (SigningData,
compute_signing_root, sign_with_domain, verify_signed_data).
"""

from __future__ import annotations

from .crypto import bls
from .error import InvalidSignatureError
from .ssz import ByteVector, Container

__all__ = [
    "SigningData",
    "compute_signing_root",
    "sign_with_domain",
    "verify_signed_data",
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


def sign_with_domain(ssz_type, value, secret_key: bls.SecretKey, domain: bytes) -> bytes:
    root = compute_signing_root(ssz_type, value, domain)
    return secret_key.sign(root).to_bytes()


def verify_signed_data(
    ssz_type, value, signature: bytes, public_key: bytes, domain: bytes
) -> None:
    """Raises InvalidSignatureError unless ``signature`` over the signing
    root verifies (signing.rs verify_signed_data)."""
    root = compute_signing_root(ssz_type, value, domain)
    pk = bls.PublicKey.from_bytes(public_key)
    sig = bls.Signature.from_bytes(signature)
    if not bls.verify_signature(pk, root, sig):
        raise InvalidSignatureError("signed data does not verify")
