"""Signing domain types.

Reference parity: ethereum-consensus/src/domains.rs:1-30. Each domain type
encodes to 4 bytes; the spec domains use the first byte as index
(e.g. DOMAIN_BEACON_ATTESTER = 0x01000000 big-endian notation = bytes
[1,0,0,0]), application domains use the last byte (mask 0x00000001 = bytes
[0,0,0,1]).
"""

from __future__ import annotations

from enum import IntEnum


class DomainType(IntEnum):
    """Values are the little-endian u32 reading of the 4-byte encoding."""

    BEACON_PROPOSER = 0
    BEACON_ATTESTER = 1
    RANDAO = 2
    DEPOSIT = 3
    VOLUNTARY_EXIT = 4
    SELECTION_PROOF = 5
    AGGREGATE_AND_PROOF = 6
    SYNC_COMMITTEE = 7
    SYNC_COMMITTEE_SELECTION_PROOF = 8
    CONTRIBUTION_AND_PROOF = 9
    BLS_TO_EXECUTION_CHANGE = 10
    CONSOLIDATION = 11
    APPLICATION_MASK = 0x01000000  # bytes [0,0,0,1]
    # DOMAIN_APPLICATION_BUILDER shares the application-mask encoding
    APPLICATION_BUILDER = 0x01000000

    def as_bytes(self) -> bytes:
        """4-byte little-endian encoding of the domain."""
        return int(self).to_bytes(4, "little")
