"""bellatrix — the merge: execution payloads, blinded blocks, the bellatrix
slashing and inactivity quotients, and the altair → bellatrix upgrade.

Reference parity: ethereum-consensus/src/bellatrix/. Fork-diff modules
compose over altair (``models/_diff.py``). Ported from
ethereum_consensus_tpu/models/bellatrix/; ``genesis`` is not ported yet.
"""

from . import (  # noqa: F401
    block_processing,
    containers,
    epoch_processing,
    fork,
    helpers,
    slot_processing,
    state_transition,
)
from .containers import build  # noqa: F401
from .fork import upgrade_to_bellatrix  # noqa: F401
