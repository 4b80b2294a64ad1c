"""Vectorized phase0 committee machinery — the per-epoch attesting-mask
kernel.

phase0's epoch boundary is pending-attestation bound: justification and
the five reward components each walk every ``PendingAttestation``
through ``get_attesting_indices`` — a Python set build over the
committee slice per attestation, ~2k attestations × ~512 members × ~5
walks at 2^20 validators. This module computes the SAME information as
one vectorized numpy pass:

* the epoch's committee assignment is derived ONCE as a shuffled-index
  table (``phase0.helpers.shuffled_active_array`` — the identical
  permutation the committee slicers serve, one shuffle per epoch per
  process, the CUDA kernel of ``ops/shuffle.py`` when installed);
* every attestation's ``(slot, index)`` becomes a slice ``[start, end)``
  of that table (the ``compute_committee`` geometry, exactly);
* aggregation bits pack into a byte matrix (little-endian bit order, rows
  served from the Bitlist root cache's ``bitpack`` entry once the bits
  were hashed) and unpack against the slice index in one broadcast,
  scattering source/target/head participation masks plus the
  per-validator min-inclusion-delay and proposer columns — zero
  per-committee-member Python work.

The spec helpers (``get_attesting_indices`` and the component walks in
``phase0/epoch_processing.py``) stay the live fallback AND the
differential oracle. Every decline is a counter
(``committees.fallback.{reason}``).

Memo contract: one bundle per (state, epoch), keyed
``(epoch, n, len(atts), atts._mut_gen)`` and dropped at the
participation-record rotation. The memo dict is a shared ``__dict__``
value, so it TRAVELS across state copies; a copy's hit additionally
requires either the same list object or the copied list's
nested-container freshness flag (``_parents_registered`` +
``_elems_fresh``, ssz/core.py) — any element, field, or list mutation
clears it.

Reference parity: ethereum_consensus_tpu/models/committees.py. Cut with
the telemetry slice: the routing journal, trace spans and events, and the
memory observatory's bundle census.
"""

from __future__ import annotations

from .. import _env
from ..domains import DomainType
from ..telemetry import metrics

__all__ = [
    "PendingMasks",
    "pending_masks_for",
    "drop_masks_memo",
    "MASKS_MIN_VALIDATORS",
]

# Below this registry size the spec walks win (table + bitfield setup
# costs more than a handful of tiny committees); the differential tests
# lower it to 0 to force the kernel on toy states.
MASKS_MIN_VALIDATORS = 1 << 12

_DISABLE_ENV = "ECT_COMMITTEE_MASKS"  # =off disables just this kernel
_MEMO_ATTR = "_pending_masks_memo"


def _np():
    try:
        import numpy

        return numpy
    except Exception:  # noqa: BLE001 — environment without numpy
        return None


def fallback(reason: str) -> None:
    """Count a decline to the spec-helper walk."""
    metrics.counter(f"committees.fallback.{reason}").inc()


def _disabled() -> bool:
    if _env.flag_off(_DISABLE_ENV):
        return True
    from . import ops_vector

    return _env.flag_off(ops_vector._DISABLE_ENV)


class PendingMasks:
    """One epoch's pending-attestation participation, columnized.

    All arrays are length-``n`` (the registry) and READ-ONLY — consumers
    combine them (``mask & ~slashed``) into fresh arrays, never write
    through them. ``source``/``target``/``head`` are the union
    attesting masks of the matching-source/target/head attestation sets
    (slashed NOT yet filtered — exactly ``get_attesting_indices``
    unions). ``covered`` marks validators appearing in at least one
    source attestation; for those, ``inclusion_delay`` and
    ``inclusion_proposer`` describe the attestation the spec's
    ``min(candidates, key=inclusion_delay)`` selects (stable order —
    first in list order among equal delays)."""

    __slots__ = (
        "epoch",
        "n",
        "att_count",
        "source",
        "target",
        "head",
        "covered",
        "inclusion_delay",
        "inclusion_proposer",
    )


def _freeze(arr):
    arr.flags.writeable = False
    return arr


def _empty_bundle(np, epoch: int, n: int) -> PendingMasks:
    pm = PendingMasks()
    pm.epoch = epoch
    pm.n = n
    pm.att_count = 0
    pm.source = _freeze(np.zeros(n, dtype=bool))
    pm.target = pm.source
    pm.head = pm.source
    pm.covered = pm.source
    pm.inclusion_delay = _freeze(np.ones(n, dtype=np.uint64))
    pm.inclusion_proposer = _freeze(np.zeros(n, dtype=np.int64))
    return pm


def _build(state, epoch: int, atts, context, np) -> "PendingMasks | None":
    from .phase0 import helpers as h

    n = len(state.validators)
    m = len(atts)
    if m == 0:
        return _empty_bundle(np, epoch, n)

    indices = h.get_active_validator_indices(state, epoch)
    active_count = len(indices)
    if active_count == 0:
        fallback("no_active")
        return None
    per_slot = h.get_committee_count_per_slot(state, epoch, context)
    spe = int(context.SLOTS_PER_EPOCH)
    total = per_slot * spe
    start_slot = epoch * spe

    # ONE pass of per-attestation container reads (O(m), no committee
    # walks): geometry columns + the packed uint64 bitfield matrix (the
    # pool/store.py idiom — little-endian bit order, 64 members/lane)
    slots = np.empty(m, dtype=np.int64)
    cidx = np.empty(m, dtype=np.int64)
    delays = np.empty(m, dtype=np.uint64)
    proposers = np.empty(m, dtype=np.int64)
    bit_lens = np.empty(m, dtype=np.int64)
    tgt_match = np.empty(m, dtype=bool)
    target_root = h.get_block_root(state, epoch, context)
    rows = []
    for r, a in enumerate(atts):
        data = a.data
        slot = int(data.slot)
        index = int(data.index)
        if not (start_slot <= slot < start_slot + spe) or not (
            0 <= index < per_slot
        ):
            # outside the epoch's committee geometry: the spec walk owns
            # whatever structured error (or exotic slice) results
            fallback("geometry")
            return None
        slots[r] = slot
        cidx[r] = index
        delays[r] = int(a.inclusion_delay)
        proposers[r] = int(a.proposer_index)
        bits = a.aggregation_bits
        bit_lens[r] = len(bits)
        # the packed little-endian row straight off the Bitlist root
        # cache when the bits were already hashed (every pre-boundary
        # state root did) — else box the bools once here
        raw = getattr(bits, "_root_cache", None)
        raw = raw.get("bitpack") if raw is not None else None
        if raw is None:
            try:
                raw = np.packbits(
                    np.asarray(bits, dtype=bool), bitorder="little"
                ).tobytes()
            except Exception:  # noqa: BLE001 — exotic bit values
                fallback("bits_values")
                return None
        rows.append(raw)
        tgt_match[r] = bytes(data.target.root) == target_root

    # committee slices of the shuffled table (compute_committee geometry)
    cg = (slots - start_slot) * per_slot + cidx
    starts = active_count * cg // total
    ends = active_count * (cg + 1) // total
    lens = ends - starts
    if bool((bit_lens != lens).any()):
        # a bits/committee length mismatch is the spec walk's structured
        # InvalidIndexedAttestation — decline so it raises at its site
        fallback("bits_shape")
        return None
    max_len = int(lens.max())
    words = (max_len + 63) // 64
    packed = np.zeros((m, words * 8), dtype=np.uint8)
    for r, raw in enumerate(rows):
        packed[r, : len(raw)] = np.frombuffer(raw, dtype=np.uint8)

    seed = h.get_seed(state, epoch, DomainType.BEACON_ATTESTER, context)
    table = h.shuffled_active_array(indices, seed, context)

    # unpack against the slice geometry in one broadcast: (m, max_len),
    # byte lanes (8× less memory traffic than u64 lanes at this shape)
    col = np.arange(max_len, dtype=np.int64)
    valid = (
        (packed[:, col >> 3] >> (col & 7).astype(np.uint8)) & np.uint8(1)
    ).astype(bool)
    # no ragged-tail mask needed: every row was packed from EXACTLY its
    # committee's bit count (pad bits and columns past a shorter row are
    # structurally zero), so a hit can never land outside its slice

    flat_r, flat_c = np.nonzero(valid)
    gpos = starts[flat_r] + flat_c  # positions in the shuffled table
    attesters = table[gpos]  # ONE gather: global validator indices

    def validator_mask(sel_rows) -> "np.ndarray":
        mask = np.zeros(n, dtype=bool)
        if sel_rows is None:
            mask[attesters] = True
        else:
            mask[attesters[sel_rows[flat_r]]] = True
        return mask

    # head matching only over target-matching rows — the spec filter
    # order (get_matching_head_attestations walks target attestations),
    # so a non-target attestation can never raise the block-root lookup
    head_match = np.zeros(m, dtype=bool)
    for r in np.nonzero(tgt_match)[0].tolist():
        head_match[r] = bytes(atts[r].data.beacon_block_root) == (
            h.get_block_root_at_slot(state, int(slots[r]))
        )

    # min-inclusion-delay selection as a min-rank scatter: rank rows by
    # STABLE delay order, keep the minimum rank per table position —
    # exactly the spec's min(candidates, key=inclusion_delay) with its
    # list-order tie-break, zero per-attestation Python work
    order = np.argsort(delays, kind="stable")
    rank = np.empty(m, dtype=np.int64)
    rank[order] = np.arange(m, dtype=np.int64)
    best_rank = np.full(active_count, m, dtype=np.int64)
    np.minimum.at(best_rank, gpos, rank[flat_r])

    pm = PendingMasks()
    pm.epoch = epoch
    pm.n = n
    pm.att_count = m
    pm.source = _freeze(validator_mask(None))
    pm.target = _freeze(validator_mask(tgt_match))
    pm.head = _freeze(validator_mask(head_match))
    covered = np.zeros(n, dtype=bool)
    inclusion_delay = np.ones(n, dtype=np.uint64)
    inclusion_proposer = np.zeros(n, dtype=np.int64)
    pos_hits = np.nonzero(best_rank < m)[0]
    best_att = order[best_rank[pos_hits]]
    vals = table[pos_hits]
    covered[vals] = True
    inclusion_delay[vals] = delays[best_att]
    inclusion_proposer[vals] = proposers[best_att]
    pm.covered = _freeze(covered)
    pm.inclusion_delay = _freeze(inclusion_delay)
    pm.inclusion_proposer = _freeze(inclusion_proposer)
    return pm


def _pendings_for_epoch(state, epoch: int, context):
    """The matching-source pending list for ``epoch`` (phase0's
    previous/current window), or None when out of window / not a phase0
    state."""
    from .phase0 import helpers as h

    current = h.get_current_epoch(state, context)
    previous = h.get_previous_epoch(state, context)
    if epoch == current:
        return getattr(state, "current_epoch_attestations", None)
    if epoch == previous:
        return getattr(state, "previous_epoch_attestations", None)
    return None


def pending_masks_for(state, epoch: int, context) -> "PendingMasks | None":
    """The memoized mask bundle for ``epoch``'s pending attestations, or
    None (decline counted — callers run the spec walk)."""
    np = _np()
    if np is None:
        fallback("no_numpy")
        return None
    n = len(state.validators)
    if n < MASKS_MIN_VALIDATORS:
        fallback("below_threshold")
        return None
    if _disabled():
        fallback("disabled")
        return None
    atts = _pendings_for_epoch(state, epoch, context)
    if atts is None:
        fallback("no_pendings")
        return None
    key = (epoch, n, len(atts), getattr(atts, "_mut_gen", None))
    memo = state.__dict__.get(_MEMO_ATTR)
    if isinstance(memo, dict):
        hit = memo.get(epoch)
        if hit is not None and hit[0] == key:
            # the bundle travels across state copies (the memo dict is a
            # shared __dict__ value): accept it for the SAME list object,
            # or for a copied list whose full-walk freshness flag proves
            # its content unchanged since the walk that followed the copy
            # (ssz/core.py nested-container freshness — any element or
            # list mutation clears it; list-level mutation also bumps
            # _mut_gen out of the key)
            if hit[1] is atts or (
                getattr(atts, "_parents_registered", False)
                and getattr(atts, "_elems_fresh", False)
            ):
                metrics.counter("committees.masks.hits").inc()
                return hit[2]
    bundle = _build(state, epoch, atts, context, np)
    if bundle is None:
        return None
    metrics.counter("committees.masks.builds").inc()
    # REBIND a fresh dict (the _active_idx_cache discipline): state
    # copies share __dict__ values, so in-place inserts would leak a
    # diverged copy's masks into the original
    items = (
        [(e, v) for e, v in memo.items() if e != epoch]
        if isinstance(memo, dict)
        else []
    )
    if len(items) >= 2:
        items = items[1:]
    state.__dict__[_MEMO_ATTR] = dict(
        items + [(epoch, (key, atts, bundle))]
    )
    return bundle


def drop_masks_memo(state) -> None:
    """Drop the per-state bundle memo — called at the participation
    record rotation (the pending lists just swapped) so a stale bundle
    can never survive its epoch."""
    state.__dict__.pop(_MEMO_ATTR, None)
