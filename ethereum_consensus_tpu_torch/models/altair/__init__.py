"""altair — sync committees, participation flags, the flag-reward epoch
pass, and the phase0 → altair upgrade.

Reference parity: ethereum-consensus/src/altair/. Fork-diff modules
compose over phase0 (re-imports for unchanged logic). Ported from
ethereum_consensus_tpu/models/altair/.
"""

from . import (  # noqa: F401
    block_processing,
    constants,
    containers,
    epoch_processing,
    fork,
    genesis,
    helpers,
    slot_processing,
    state_transition,
)
from .containers import build  # noqa: F401
from .fork import upgrade_to_altair  # noqa: F401
