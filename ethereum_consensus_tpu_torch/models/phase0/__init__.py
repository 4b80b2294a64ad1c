"""phase0 — the base beacon-chain spec: containers, helpers, slot and block
processing, and the state transition.

Reference parity: ethereum-consensus/src/phase0/. Epoch processing is not
ported yet (slot_processing.process_epoch raises).
"""

from . import (  # noqa: F401
    block_processing,
    containers,
    helpers,
    slot_processing,
    state_transition,
)
from .containers import build  # noqa: F401
