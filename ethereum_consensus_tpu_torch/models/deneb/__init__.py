"""deneb — blobs / EIP-4844, 7044, 7045, 7514, and the capella → deneb
upgrade.

Reference parity: ethereum-consensus/src/deneb/. Fork-diff modules compose
over capella (``models/_diff.py``). Ported from
ethereum_consensus_tpu/models/deneb/; ``genesis`` is not ported yet.
"""

from . import (  # noqa: F401
    blob_sidecar,
    block_processing,
    containers,
    epoch_processing,
    execution_engine,
    fork,
    helpers,
    slot_processing,
    state_transition,
)
from .containers import build  # noqa: F401
from .fork import upgrade_to_deneb  # noqa: F401
