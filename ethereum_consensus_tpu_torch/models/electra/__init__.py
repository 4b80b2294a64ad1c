"""electra — EIP-7251 (maximum effective balance, consolidations), EIP-6110
(deposit receipts), EIP-7002 (execution-layer withdrawal requests),
EIP-7549 (committee-spanning attestations), and the deneb → electra
upgrade.

Reference parity: ethereum-consensus/src/electra/. Fork-diff modules
compose over deneb (``models/_diff.py``). Ported from
ethereum_consensus_tpu/models/electra/.
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
from .fork import upgrade_to_electra  # noqa: F401
