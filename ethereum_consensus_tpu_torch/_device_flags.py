"""Runtime switches for device acceleration of spec-path functions.

Deliberately free of any torch import: the host layers (models/, crypto/)
consult these flags on every call and only import the ops package when a
flag is on, so a host-only process never pays for torch. The flags are set
by ``ops.install()`` (and unset by ``ops.uninstall()``).

Thresholds are minimum element counts: device sweeps, shuffles and
aggregations win only above a size where the launch and the host<->device
packing amortize; below the threshold the spec functions keep their host
path. ``PAIRING_MIN_SETS`` counts the signature sets of one batched
verification.
"""

from __future__ import annotations

SWEEPS_MIN_N: int | None = None
SHUFFLE_MIN_N: int | None = None
BLS_AGG_MIN_N: int | None = None
PAIRING_MIN_SETS: int | None = None

# The device that the routed kernels run on ("cuda", or "cpu" for their
# plain versions); set by ops.install().
DEVICE: str = "cuda"


def sweeps_enabled(n: int) -> bool:
    """Route the registry sweeps (effective-balance hysteresis; altair:
    flag deltas, inactivity, the fused epoch kernel) to the device for an
    ``n``-validator registry?"""
    return SWEEPS_MIN_N is not None and n >= SWEEPS_MIN_N


def shuffle_enabled(n: int) -> bool:
    """Route committee shuffling to the device whole-list kernel for an
    ``n``-element index list?"""
    return SHUFFLE_MIN_N is not None and n >= SHUFFLE_MIN_N


def bls_agg_enabled(n: int) -> bool:
    """Route G1 pubkey aggregation to the device kernel for an ``n``-point
    batch? (Below the threshold the native C++ adds win.)"""
    return BLS_AGG_MIN_N is not None and n >= BLS_AGG_MIN_N


def pairing_enabled(n_sets: int) -> bool:
    """Route the RLC batch verification of ``n_sets`` signature sets
    (blinder multiplications, Miller loops, the Fq12 product) to the
    device pairing kernels? The native multi-pairing keeps smaller
    batches."""
    return PAIRING_MIN_SETS is not None and n_sets >= PAIRING_MIN_SETS
