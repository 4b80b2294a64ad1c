"""Scalar primitive types, genesis constants and withdrawal prefixes.

Reference parity: ethereum-consensus/src/primitives.rs:8-49.

In Python the scalar aliases are SSZ type descriptors (all u64-backed unless
noted); values are plain ints/bytes. The decimal-string JSON convention is
carried by the descriptors themselves (see ssz/core.py).
"""

from __future__ import annotations

from .ssz.core import ByteVector, uint8, uint64, uint256

# -- aliases (primitives.rs:8-33) -------------------------------------------
Root = ByteVector[32]
Hash32 = ByteVector[32]
Bytes32 = ByteVector[32]
Slot = uint64
Epoch = uint64
CommitteeIndex = uint64
ValidatorIndex = uint64
Gwei = uint64
WithdrawalIndex = uint64
BlobIndex = uint64
Version = ByteVector[4]
ForkDigest = ByteVector[4]
Domain = ByteVector[32]
DomainTypeBytes = ByteVector[4]
ExecutionAddress = ByteVector[20]
ParticipationFlags = uint8
U256 = uint256

BlsPublicKey = ByteVector[48]
BlsSignature = ByteVector[96]
KzgCommitmentBytes = ByteVector[48]
KzgProofBytes = ByteVector[48]
VersionedHash = Bytes32

# -- constants (primitives.rs:35-49) ----------------------------------------
GENESIS_SLOT: int = 0
GENESIS_EPOCH: int = 0
FAR_FUTURE_EPOCH: int = 2**64 - 1
UNSET_DEPOSIT_RECEIPTS_START_INDEX: int = 2**64 - 1

BLS_WITHDRAWAL_PREFIX = b"\x00"
ETH1_ADDRESS_WITHDRAWAL_PREFIX = b"\x01"
COMPOUNDING_WITHDRAWAL_PREFIX = b"\x02"

# u64 bounds used for explicit-overflow arithmetic (error.rs:41-44 analogue)
U64_MAX = 2**64 - 1
