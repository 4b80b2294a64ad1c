"""capella — withdrawals, BLS → execution changes, historical summaries,
and the bellatrix → capella upgrade.

Reference parity: ethereum-consensus/src/capella/. Fork-diff modules
compose over bellatrix (``models/_diff.py``). Ported from
ethereum_consensus_tpu/models/capella/.
"""

from . import (  # noqa: F401
    block_processing,
    containers,
    epoch_processing,
    fork,
    genesis,
    helpers,
    slot_processing,
    state_transition,
)
from .containers import build  # noqa: F401
from .fork import upgrade_to_capella  # noqa: F401
