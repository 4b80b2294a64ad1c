"""deneb execution-engine request.

Reference parity: ethereum-consensus/src/deneb/execution_engine.rs:7 —
NewPayloadRequest bundles the payload with blob versioned hashes and the
parent beacon block root (EIP-4788). Ported from
ethereum_consensus_tpu/models/deneb/execution_engine.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["NewPayloadRequest"]


@dataclass
class NewPayloadRequest:
    execution_payload: object
    versioned_hashes: list = field(default_factory=list)
    parent_beacon_block_root: bytes = b"\x00" * 32
