"""Per-fork spec modules. Only phase0 slot processing is ported so far."""

from . import phase0  # noqa: F401
