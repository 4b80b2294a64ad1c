"""Cryptography subsystem: BLS12-381 signatures, and KZG commitments for
EIP-4844 blobs (``crypto/kzg.py``, on the host).

Replaces the reference's blst dependency (ethereum-consensus/src/crypto/
{mod,bls}.rs) with a from-scratch field/curve/pairing stack and the native
C++ backend; the batched G1 pubkey aggregation runs on the card through
ops/g1.py when installed.
"""

from . import bls, curves, fields, hash_to_curve, pairing  # noqa: F401
from .bls import (  # noqa: F401
    PublicKey,
    SecretKey,
    Signature,
    aggregate,
    aggregate_verify,
    eth_aggregate_public_keys,
    eth_fast_aggregate_verify,
    fast_aggregate_verify,
    hash,
    verify_signature,
)
