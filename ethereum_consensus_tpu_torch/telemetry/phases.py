"""Transition phase attribution from recorded spans.

The per-block cost split — signature batch / state HTR / committees /
operations — derives from the named spans the transition itself emits
(``models/transition.py`` + ``models/phase0/helpers.py``), so any entry
point that records a run attributes the same way.

Span name contract:

* ``transition.slot_advance`` — one per ``process_slots`` call;
* ``transition.block``        — one per block-in-slot application;
* ``transition.sig_batch``    — the batched signature verification
  (≈ 0 under ``defer_flushes``: the sets drain to the caller's sink);
* ``transition.state_htr``    — every full-state hash_tree_root (the
  per-slot root memo and the state-root check);
* ``transition.committees``   — committee/proposer machinery
  (``get_beacon_committee`` bodies, proposer-index cache misses).

``operations`` is everything else inside the transition:
``slot_advance + block − sig_batch − state_htr − committees``.

Reference parity: ethereum_consensus_tpu/telemetry/phases.py, whole.
"""

from __future__ import annotations

__all__ = ["PHASE_SPANS", "HOT_SWEEP_SPANS", "attribution", "hot_sweep_report"]

PHASE_SPANS = {
    "slot_advance": "transition.slot_advance",
    "block": "transition.block",
    "sig_batch": "transition.sig_batch",
    "state_htr": "transition.state_htr",
    "committees": "transition.committees",
}

# The named hot scans. With the epoch caches and the columnar
# withdrawals path (models/ops_vector.py) engaged, NONE of these may
# appear on a warm per-block path — the columnar twin runs under
# ``ops_vector.withdrawals`` instead. Epoch-boundary occurrences (inside
# ``transition.process_epoch``) are legitimate once-per-epoch work.
HOT_SWEEP_SPANS = (
    "helpers.active_indices_sweep",
    "helpers.total_balance_sweep",
    "capella.withdrawals_sweep",
    "electra.withdrawals_sweep",
)


def _total(records, name: str) -> float:
    return sum(r.duration_s for r in records if r.name == name)


def attribution(records) -> dict:
    """Phase seconds from a list of ``SpanRecord``s (one or more recorded
    transitions). Returns the ``phases`` dict shape."""
    by_id = {r.span_id: r for r in records}

    def has_ancestor(rec, name: str) -> bool:
        seen = 0
        parent = by_id.get(rec.parent_id)
        while parent is not None and seen < 64:
            if parent.name == name:
                return True
            parent = by_id.get(parent.parent_id)
            seen += 1
        return False

    slots_s = _total(records, PHASE_SPANS["slot_advance"])
    block_s = _total(records, PHASE_SPANS["block"])
    sig_s = _total(records, PHASE_SPANS["sig_batch"])
    htr_s = _total(records, PHASE_SPANS["state_htr"])
    committee_s = _total(records, PHASE_SPANS["committees"])
    htr_in_slots = sum(
        r.duration_s
        for r in records
        if r.name == PHASE_SPANS["state_htr"]
        and has_ancestor(r, PHASE_SPANS["slot_advance"])
    )
    ops_s = (slots_s + block_s) - (sig_s + htr_s + committee_s)
    return {
        "slot_advance_s": round(slots_s, 4),
        "block_apply_s": round(block_s, 4),
        "sig_batch_s": round(sig_s, 4),
        "state_htr_s": round(htr_s, 4),
        "state_htr_in_slot_advance_s": round(htr_in_slots, 4),
        "committee_s": round(committee_s, 4),
        "operations_s": round(max(0.0, ops_s), 4),
    }


def hot_sweep_report(records) -> dict:
    """Occurrences of the named hot-scan spans over a recorded
    run, split into ``boundary`` (inside ``transition.process_epoch`` —
    legitimate once-per-epoch recomputation) and ``per_block`` (must be
    ABSENT on a warm path: the epoch caches and the columnar withdrawals
    sweep take them off it). ``per_block_absent`` is the assertion
    bit."""
    by_id = {r.span_id: r for r in records}

    def inside_epoch_processing(rec) -> bool:
        seen = 0
        parent = by_id.get(rec.parent_id)
        while parent is not None and seen < 64:
            if parent.name == "transition.process_epoch":
                return True
            parent = by_id.get(parent.parent_id)
            seen += 1
        return False

    per_block: dict = {}
    boundary: dict = {}
    for r in records:
        if r.name in HOT_SWEEP_SPANS:
            bucket = boundary if inside_epoch_processing(r) else per_block
            bucket[r.name] = bucket.get(r.name, 0) + 1
    return {
        "per_block": per_block,
        "boundary": boundary,
        "per_block_absent": not per_block,
    }
