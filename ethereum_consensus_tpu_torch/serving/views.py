"""Columnar resolution for the Beacon-API read plane.

Every batched registry read an endpoint serves reduces to the same
shape: resolve the request's validator indices, perform ONE vectorized
gather over the snapshot's frozen column bundle (``ops_vector.
gather_rows`` — numpy fancy-index, no per-validator Python), apply any
status filter as a vectorized mask, and only then assemble the JSON
rows for the (already narrowed) result set. The scalar twin of every
computation lives in ``serving/oracle.py`` and is both the fallback
(no numpy / exotic values) and the differential oracle (the tests assert
bit-identical documents).

Status taxonomy: the standard Beacon-API validator status machine,
computed once per snapshot as a uint8 code column over the whole
registry — after that, a request's status is one gathered byte.

Reference parity: ethereum_consensus_tpu/serving/views.py.
"""

from __future__ import annotations

import time

from ..models import ops_vector
from ..primitives import FAR_FUTURE_EPOCH
from ..telemetry import metrics as _metrics
from ..utils import trace

__all__ = [
    "STATUS_NAMES",
    "STATUS_AGGREGATES",
    "status_code_column",
    "snapshot_bundle",
    "parse_statuses",
    "gather",
    "resolve_validators",
    "rewards_summary_columnar",
]

# index-aligned with the code column below; the order encodes the
# precedence of the standard status machine (oracle.validator_status is
# the scalar twin — keep them in lockstep)
STATUS_NAMES = (
    "pending_initialized",   # 0
    "pending_queued",        # 1
    "active_ongoing",        # 2
    "active_exiting",        # 3
    "active_slashed",        # 4
    "exited_unslashed",      # 5
    "exited_slashed",        # 6
    "withdrawal_possible",   # 7
    "withdrawal_done",       # 8
)

# the aggregate filter classes the ?status= parameter also accepts
STATUS_AGGREGATES = {
    "pending": (0, 1),
    "active": (2, 3, 4),
    "exited": (5, 6),
    "withdrawal": (7, 8),
}


def _np():
    return ops_vector._np()


def status_code_column(bundle: dict, epoch: int):
    """uint8 status codes over the whole registry, vectorized — the
    scalar twin is ``oracle.validator_status`` (differentially tested)."""
    np = _np()
    far = np.uint64(FAR_FUTURE_EPOCH)
    e = np.uint64(epoch)
    act = bundle["activation_epoch"]
    ex = bundle["exit_epoch"]
    wd = bundle["withdrawable_epoch"]
    elig = bundle["activation_eligibility_epoch"]
    slashed = bundle["slashed"]
    bal = bundle["balances"]
    codes = np.zeros(act.shape[0], dtype=np.uint8)
    pending = e < act
    active = (act <= e) & (e < ex)
    exited = (ex <= e) & (e < wd)
    withdrawable = wd <= e
    codes[pending] = np.where(
        elig[pending] == far, np.uint8(0), np.uint8(1)
    )
    codes[active] = np.where(
        slashed[active],
        np.uint8(4),
        np.where(ex[active] != far, np.uint8(3), np.uint8(2)),
    )
    codes[exited] = np.where(slashed[exited], np.uint8(6), np.uint8(5))
    codes[withdrawable] = np.where(
        bal[withdrawable] != 0, np.uint8(7), np.uint8(8)
    )
    return codes


def snapshot_bundle(snapshot) -> "dict | None":
    """The snapshot's frozen column bundle extended (once, memoized on
    the snapshot) with the status-code column at the snapshot's current
    epoch. None → scalar fallback."""
    base = snapshot.bundle()
    if base is None:
        return None

    def build():
        epoch = int(snapshot.raw.slot) // int(
            snapshot.context.SLOTS_PER_EPOCH
        )
        out = dict(base)
        out["status_codes"] = status_code_column(base, epoch)
        out["epoch"] = epoch
        return out

    return snapshot.memo(("bundle+status",), build)


def parse_statuses(raw_statuses) -> "set[int] | None":
    """?status= values → allowed status-code set (None = no filter).
    Raises ValueError on an unknown status name (the handler's 400)."""
    if not raw_statuses:
        return None
    allowed: set = set()
    for name in raw_statuses:
        if name in STATUS_AGGREGATES:
            allowed.update(STATUS_AGGREGATES[name])
        elif name in STATUS_NAMES:
            allowed.add(STATUS_NAMES.index(name))
        else:
            raise ValueError(f"unknown validator status {name!r}")
    return allowed


def gather(bundle: dict, indices, fields):
    """The data plane's one-columnar-gather-per-batch unit: a single
    ``ops_vector.gather_rows`` pass over the requested fields, counted
    (``serving.gathers``) and timed (``serving.gather_s``), so a test can
    assert exactly one per batched read. Under tracing the gather runs in
    its own span and the observation carries its trace_id (the tail
    request's exemplar)."""
    t0 = time.perf_counter()
    with trace.span("serving.gather", rows=len(indices)):
        out = ops_vector.gather_rows(bundle, indices, fields)
        ctx = trace.context()
    _metrics.counter("serving.gathers").inc()
    _metrics.histogram("serving.gather_s").observe(
        time.perf_counter() - t0,
        trace_id=ctx.trace_id if ctx is not None else None,
    )
    return out


def resolve_validators(bundle: dict, indices, allowed_codes=None):
    """(kept_indices, balances, codes) for the requested registry rows:
    one gather + one vectorized status mask. ``indices`` None means the
    whole registry (no fancy-index needed — still one logical gather).
    The returned arrays are position-aligned and owned by the caller."""
    np = _np()
    if indices is None:
        idx = np.arange(bundle["balances"].shape[0], dtype=np.int64)
        balances = bundle["balances"]
        codes = bundle["status_codes"]
        _metrics.counter("serving.gathers").inc()
    else:
        idx = np.asarray(indices, dtype=np.int64)
        rows = gather(bundle, idx, ("balances", "status_codes"))
        balances = rows["balances"]
        codes = rows["status_codes"]
    if allowed_codes is not None:
        mask = np.isin(codes, np.asarray(sorted(allowed_codes), np.uint8))
        idx, balances, codes = idx[mask], balances[mask], codes[mask]
    return idx, balances, codes


def rewards_summary_columnar(snapshot) -> "dict | None":
    """The epoch-rewards summary from one ``pack_registry_cached`` pass:
    previous-epoch participation flag balances as vectorized mask sums.
    None → scalar fallback (phase0 or columns unavailable); the scalar
    twin is ``oracle.rewards_summary_data``."""
    np = _np()
    state = snapshot.raw
    context = snapshot.context
    if np is None or ops_vector._disabled():
        return None
    if getattr(state, "previous_epoch_participation", None) is None:
        return None  # phase0: no participation flags to summarize
    current_epoch = int(state.slot) // int(context.SLOTS_PER_EPOCH)
    previous_epoch = max(0, current_epoch - 1)
    packed = ops_vector.pack_registry_cached(state, previous_epoch)
    eff = packed["effective_balance"]
    if not isinstance(eff, np.ndarray):
        return None  # the cached pack degraded to a scalar shape
    increment = int(context.EFFECTIVE_BALANCE_INCREMENT)
    active = packed["active_previous"]
    unslashed = active & ~packed["slashed"]
    participation = packed["previous_participation"]

    def total(mask) -> int:
        # u64 sum is exact while total stake < 2^64 gwei (mainnet is
        # ~2^55); the scalar oracle computes the same python int
        return max(increment, int(eff[mask].sum(dtype=np.uint64)))

    from ..models.altair.constants import (
        TIMELY_HEAD_FLAG_INDEX,
        TIMELY_SOURCE_FLAG_INDEX,
        TIMELY_TARGET_FLAG_INDEX,
    )
    from ..models.altair.helpers import get_base_reward_per_increment

    flags = {}
    for name, flag_index in (
        ("timely_source", TIMELY_SOURCE_FLAG_INDEX),
        ("timely_target", TIMELY_TARGET_FLAG_INDEX),
        ("timely_head", TIMELY_HEAD_FLAG_INDEX),
    ):
        has = (participation & np.uint8(1 << flag_index)) != 0
        flags[name] = str(total(unslashed & has))
    return {
        "epoch": str(previous_epoch),
        "active_validators": str(int(active.sum())),
        "eligible_validators": str(int(packed["eligible"].sum())),
        "total_active_balance": str(total(active)),
        "base_reward_per_increment": str(
            int(get_base_reward_per_increment(state, context))
        ),
        "participation": flags,
    }
