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
  ECT_MESH=<n>|auto|off    the mesh runtime (parallel/runtime.py): a mesh
                           over the first n devices, every device when
                           there are at least two, or none (unset, off, 0,
                           none, host); any other value raises when the
                           mesh is first consulted
  ECT_MESH_EPOCH_MIN_N=<n>        the registry size from which the epoch
                                  sweeps take the mesh
  ECT_MESH_MERKLE_MIN_CHUNKS=<n>  the chunk count from which a flat
                                  merkle rebuild takes the mesh

Reference parity: ethereum_consensus_tpu/_env.py (the subset the ported
modules read).
"""

from __future__ import annotations

import os

__all__ = ["MULTIPLIERS", "flag_off", "mesh_requested", "min_count", "mode", "multiplier",
           "threshold"]

MULTIPLIERS = ("u64", "mxu")


def flag_off(key: str) -> bool:
    """True when the flag explicitly disables its feature (off/0/false,
    case-insensitive). Unset is NOT off: features default on."""
    return os.environ.get(key, "").strip().lower() in ("off", "0", "false")


def mode(key: str, default: str = "") -> str:
    """Stripped, lowercased environ value — the mode-string idiom
    (``ECT_MESH=Auto`` reads as ``"auto"``)."""
    return os.environ.get(key, default).strip().lower()


def mesh_requested(key: str = "ECT_MESH") -> bool:
    """Is a mesh explicitly requested? The gate host layers consult BEFORE
    importing the parallel package: unset/off/0/none/host all mean "no
    mesh"."""
    return mode(key) not in ("", "off", "0", "none", "host")


def threshold(key: str, default: int) -> int:
    """A size threshold of at least 1: ``default`` when the key is unset or
    empty, else the count (a count below 1 reads as 1). Any other value
    raises ValueError (the reference takes the default there)."""
    raw = os.environ.get(key, "").strip()
    if not raw:
        return default
    try:
        return max(1, int(raw))
    except ValueError:
        raise ValueError(f"{key}={raw!r}: expected a count") from None


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
