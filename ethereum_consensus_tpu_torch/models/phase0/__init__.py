"""phase0 — the base beacon-chain spec: containers, helpers, slot, block
and epoch processing, and the state transition.

Reference parity: ethereum-consensus/src/phase0/.
"""

from . import (  # noqa: F401
    block_processing,
    containers,
    epoch_processing,
    helpers,
    slot_processing,
    state_transition,
)
from .containers import build  # noqa: F401
