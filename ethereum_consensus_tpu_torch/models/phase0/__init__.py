"""phase0 — the base beacon-chain spec: containers and slot processing.

Reference parity: ethereum-consensus/src/phase0/.
"""

from . import containers, slot_processing  # noqa: F401
from .containers import build  # noqa: F401
