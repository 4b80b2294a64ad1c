"""Configuration subsystem: compile-time presets, runtime network configs,
and the flattened Context.

Reference parity: ethereum-consensus/src/configs/, src/state_transition/
context.rs, src/networks.rs.
"""

from .config import Config  # noqa: F401
from .context import Context  # noqa: F401
from .presets import MAINNET, MINIMAL, PRESETS, Preset  # noqa: F401
