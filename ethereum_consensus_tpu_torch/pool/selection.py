"""Vectorized best-aggregate selection.

Block production wants the most-profitable set of at most
``MAX_ATTESTATIONS`` aggregates: profit = attesters newly covered. The
canonical algorithm is a GLOBAL GREEDY over the pool's groups:

1. every group keeps a running ``covered`` union of its already-picked
   rows;
2. each step computes, per group, the best marginal gain any unpicked
   row offers over that union — ``popcount(row & ~covered)``, one
   vectorized pass over the group's packed uint64 matrix;
3. the globally best (gain, group-order, row-order) candidate is picked,
   its bits fold into the group's union, and the step repeats until the
   cap is reached or no row adds a single new attester.

Ties break deterministically — larger gain first, then the canonical
group sort order (``store._group_sort_key``), then lowest row index —
so the scalar twin (`python ints as bitmasks`, same loop) produces the
IDENTICAL pick sequence: the pool's tests diff them under randomized
traffic.

Subset rows (admission already rejects them) would never be picked —
their marginal gain over the superset's union is zero — so selection is
naturally "non-overlapping": every pick strictly grows coverage.

Reference parity: ethereum_consensus_tpu/pool/selection.py.
"""

from __future__ import annotations

import time

from ..telemetry import metrics as _metrics
from ..utils import trace
from .store import _np

__all__ = ["select_aggregates", "popcount_rows"]


def popcount_rows(matrix) -> "object":
    """Per-row popcount of a packed uint64 matrix (numpy). Uses the
    vectorized ``bitwise_count`` when this numpy has it (>=2.0), else an
    unpackbits pass over the byte view."""
    np = _np()
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(matrix).sum(axis=1, dtype=np.int64)
    as_bytes = matrix.view(np.uint8)
    return np.unpackbits(as_bytes, axis=1).sum(axis=1, dtype=np.int64)


def _best_row_vectorized(group, covered_row, picked) -> "tuple[int, int]":
    """(gain, row index) of the best unpicked row against the group's
    covered union — one vectorized pass."""
    np = _np()
    held = group.bits[: group.n]
    gains = popcount_rows(held & ~covered_row)
    if picked:
        gains[np.fromiter(picked, dtype=np.int64, count=len(picked))] = -1
    row = int(np.argmax(gains))  # argmax takes the FIRST max: lowest row
    return int(gains[row]), row


def _best_row_scalar(group, covered_mask: int, picked) -> "tuple[int, int]":
    best_gain, best_row = -1, -1
    for row in range(group.n):
        if row in picked:
            continue
        gain = bin(group.masks[row] & ~covered_mask).count("1")
        if gain > best_gain:
            best_gain, best_row = gain, row
    return best_gain, best_row


def select_aggregates(groups, max_count: int, scalar: bool = False) -> list:
    """Greedy-pack up to ``max_count`` aggregates from ``groups`` (the
    pool's canonical group order); returns ``[(group, row_index), ...]``
    in pick order. ``scalar=True`` runs the brute-force twin."""
    t0 = time.perf_counter()
    np = _np()
    vectorized = not scalar and np is not None
    state = []  # per group: (covered union, picked row set)
    for group in groups:
        if vectorized and group.bits is None:
            vectorized = False  # a numpy-less insert degraded this pool
    for group in groups:
        if vectorized:
            state.append([np.zeros(group.bits.shape[1], dtype=np.uint64),
                          set()])
        else:
            state.append([0, set()])
    picks: list = []
    with trace.span("pool.select", groups=len(groups), cap=max_count):
        while len(picks) < max_count:
            best = None  # (gain, group order, row)
            for gi, group in enumerate(groups):
                if group.n == len(state[gi][1]):
                    continue
                if vectorized:
                    gain, row = _best_row_vectorized(
                        group, state[gi][0], state[gi][1]
                    )
                else:
                    gain, row = _best_row_scalar(
                        group, state[gi][0], state[gi][1]
                    )
                if gain > 0 and (best is None or gain > best[0]):
                    best = (gain, gi, row)
            if best is None:
                break
            _, gi, row = best
            group = groups[gi]
            if vectorized:
                state[gi][0] |= group.bits[row]
            else:
                state[gi][0] |= group.masks[row]
            state[gi][1].add(row)
            picks.append((group, row))
    _metrics.counter("pool.selections").inc()
    _metrics.histogram("pool.selection_s").observe(time.perf_counter() - t0)
    return picks
