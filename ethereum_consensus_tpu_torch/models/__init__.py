"""Per-fork spec modules. Only phase0 is ported so far: slot and block
processing, without epoch processing."""

from . import phase0  # noqa: F401
