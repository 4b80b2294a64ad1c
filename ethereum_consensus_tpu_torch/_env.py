"""Central reader for the package's ``ECT_*`` environment flags.

Every environ read of a repo flag goes through this module, so the parse
idiom ("off"/"0"/"false" disables) lives in one place. It imports nothing
but the standard library: a flag check never drags torch in.

The flags the port reads:
  ECT_OPS_VECTOR=off       disables every columnar path (scalar oracle mode)
  ECT_EPOCH_VECTOR=off     disables just the columnar-primary epoch engine
  ECT_COMMITTEE_MASKS=off  disables just the phase0 committee-mask kernel
  ECT_PAIRING_MIN_SETS=<n> the batch size (signature sets) that ops.install()
                           routes to the device pairing by default;
                           off/none/host pins the host multi-pairing;
                           anything else raises
  EC_PAIRING_MULT=<kind>   the product of the pairing and set-sum path:
                           u64 (CIOS, the default) or mxu (the int8
                           digit product of ops/fq8.py), in any case;
                           anything else raises

Reference parity: ethereum_consensus_tpu/_env.py (the subset the ported
modules read).
"""

from __future__ import annotations

import os

__all__ = ["MULTIPLIERS", "flag_off", "min_count", "multiplier"]

MULTIPLIERS = ("u64", "mxu")


def flag_off(key: str) -> bool:
    """True when the flag explicitly disables its feature (off/0/false,
    case-insensitive). Unset is NOT off: features default on."""
    return os.environ.get(key, "").strip().lower() in ("off", "0", "false")


def min_count(key: str, default: int) -> "int | None":
    """A size threshold: ``default`` when the key is unset, None (the host
    path) for off/none/host, an empty value or a count below 1, else the
    count. Any other value raises ValueError."""
    raw = os.environ.get(key)
    if raw is None:
        return default
    value = raw.strip().lower()
    if value in ("", "off", "none", "host"):
        return None
    try:
        n = int(value)
    except ValueError:
        raise ValueError(f"{key}={raw!r}: expected a count or off/none/host") from None
    return n if n > 0 else None


def multiplier(key: str = "EC_PAIRING_MULT") -> str:
    """The pairing multiplier: "u64" when the key is unset, "u64" or "mxu"
    in any case. Any other value raises ValueError (the reference takes
    the CIOS path there)."""
    raw = os.environ.get(key)
    if raw is None:
        return "u64"
    value = raw.strip().lower()
    if value not in MULTIPLIERS:
        raise ValueError(f"{key}={raw!r}: expected one of {', '.join(MULTIPLIERS)}")
    return value
