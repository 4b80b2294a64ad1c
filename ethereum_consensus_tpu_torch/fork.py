"""Fork tag used throughout the polymorphic layers.

Reference parity: ethereum-consensus/src/fork.rs:6-13.
"""

from __future__ import annotations

from enum import IntEnum


class Fork(IntEnum):
    PHASE0 = 0
    ALTAIR = 1
    BELLATRIX = 2
    CAPELLA = 3
    DENEB = 4
    ELECTRA = 5

    def __str__(self) -> str:
        return self.name.lower()

    @classmethod
    def from_str(cls, name: str) -> "Fork":
        return cls[name.upper()]

    @property
    def previous(self) -> "Fork | None":
        return None if self is Fork.PHASE0 else Fork(self.value - 1)
