"""phase0 — the base beacon-chain spec: containers, helpers, slot, block
and epoch processing, the state transition, and genesis from eth1
deposits.

Reference parity: ethereum-consensus/src/phase0/.
"""

from . import (  # noqa: F401
    block_processing,
    containers,
    epoch_processing,
    genesis,
    helpers,
    slot_processing,
    state_transition,
)
from .containers import build  # noqa: F401
