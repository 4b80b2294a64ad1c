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

These predicates are also the routing journal's primary source
(telemetry/device.py): every consult is a device-vs-host decision, so
while the device observatory is active each one is journaled with its
threshold inputs — the gates pre-guard on the observatory's ``active``
bool, keeping the off path at one extra read.
"""

from __future__ import annotations

from .telemetry import device as _device_obs

SWEEPS_MIN_N: int | None = None
SHUFFLE_MIN_N: int | None = None
BLS_AGG_MIN_N: int | None = None
PAIRING_MIN_SETS: int | None = None

# The device that the routed kernels run on ("cuda", or "cpu" for their
# plain versions); set by ops.install().
DEVICE: str = "cuda"


def _journal(kind: str, routed: bool, n: int, threshold: "int | None") -> None:
    _device_obs.route(
        kind,
        "device" if routed else "host",
        reason=(
            "routed"
            if routed
            else ("not_installed" if threshold is None else "below_threshold")
        ),
        n=n,
        threshold=threshold,
    )


def sweeps_enabled(n: int) -> bool:
    """Route the registry sweeps (effective-balance hysteresis; altair:
    flag deltas, inactivity, the fused epoch kernel) to the device for an
    ``n``-validator registry?"""
    routed = SWEEPS_MIN_N is not None and n >= SWEEPS_MIN_N
    if _device_obs.OBSERVATORY.active:
        _journal("sweeps", routed, n, SWEEPS_MIN_N)
    return routed


def shuffle_enabled(n: int) -> bool:
    """Route committee shuffling to the device whole-list kernel for an
    ``n``-element index list?"""
    routed = SHUFFLE_MIN_N is not None and n >= SHUFFLE_MIN_N
    if _device_obs.OBSERVATORY.active:
        _journal("shuffle", routed, n, SHUFFLE_MIN_N)
    return routed


def bls_agg_enabled(n: int) -> bool:
    """Route G1 pubkey aggregation to the device kernel for an ``n``-point
    batch? (Below the threshold the native C++ adds win.)"""
    routed = BLS_AGG_MIN_N is not None and n >= BLS_AGG_MIN_N
    if _device_obs.OBSERVATORY.active:
        _journal("bls_agg", routed, n, BLS_AGG_MIN_N)
    return routed


def pairing_enabled(n_sets: int) -> bool:
    """Route the RLC batch verification of ``n_sets`` signature sets
    (blinder multiplications, Miller loops, the Fq12 product) to the
    device pairing kernels? The native multi-pairing keeps smaller
    batches.

    The definitive pairing-route journal entry is written by
    ``crypto/bls.py`` at the verdict site; this gate journals only the
    batches it declines, so the two do not double-count routed batches."""
    routed = PAIRING_MIN_SETS is not None and n_sets >= PAIRING_MIN_SETS
    if not routed and _device_obs.OBSERVATORY.active:
        _journal("pairing_gate", routed, n_sets, PAIRING_MIN_SETS)
    return routed
