"""Host-side registry column extraction (numpy only).

The packed columns feed the device sweeps (``ops/sweeps.py``) and the
numpy epoch twins; keeping the eligibility formula in ONE place stops the
consumers drifting.

Reference parity: ethereum_consensus_tpu/ops/registry_columns.py (a copy:
the port imports nothing of the reference package).
"""

from __future__ import annotations

import numpy as np

__all__ = ["pack_registry", "unslashed_flag_mask", "activity_masks"]


def activity_masks(activation, exit_epoch, withdrawable, slashed, previous_epoch):
    """(active_previous, eligible) boolean columns from the epoch columns —
    THE eligibility formula (altair helpers.rs:265), shared by the
    fromiter packing below and the cached-column packing in
    models/ops_vector.py so the two can't drift."""
    prev = np.uint64(int(previous_epoch))
    active_previous = (activation <= prev) & (prev < exit_epoch)
    eligible = active_previous | (
        slashed & (prev + np.uint64(1) < withdrawable)
    )
    return active_previous, eligible


def pack_registry(state, previous_epoch: int, use_current_participation: bool = False) -> dict:
    """Host→device packing of the registry fields the sweeps touch.
    Activity/eligibility are evaluated at ``previous_epoch`` (the epoch the
    deltas reward/penalize, altair helpers.rs:265).

    ``use_current_participation`` covers the genesis corner where
    previous_epoch == current_epoch and the spec's
    get_unslashed_participating_indices reads the CURRENT epoch's flags."""
    n = len(state.validators)
    # phase0 states have no participation flags or inactivity scores — the
    # sweeps that need them are altair+; zero-fill so phase0-only sweeps
    # (effective-balance hysteresis) can share the same pack
    participation_list = getattr(
        state,
        "current_epoch_participation"
        if use_current_participation
        else "previous_epoch_participation",
        None,
    )
    if participation_list is None:
        participation_list = [0] * n
    inactivity_scores = getattr(state, "inactivity_scores", None)
    if inactivity_scores is None:
        inactivity_scores = [0] * n
    out = {
        "effective_balance": np.fromiter(
            (v.effective_balance for v in state.validators), np.uint64, n
        ),
        "slashed": np.fromiter(
            (bool(v.slashed) for v in state.validators), np.bool_, n
        ),
        "previous_participation": np.fromiter(
            (int(f) for f in participation_list), np.uint8, n
        ),
        "inactivity_scores": np.fromiter(
            (int(s) for s in inactivity_scores), np.uint64, n
        ),
        "balances": np.fromiter((int(b) for b in state.balances), np.uint64, n),
    }
    out["active_previous"], out["eligible"] = activity_masks(
        np.fromiter(
            (v.activation_epoch for v in state.validators), np.uint64, n
        ),
        np.fromiter((v.exit_epoch for v in state.validators), np.uint64, n),
        np.fromiter(
            (v.withdrawable_epoch for v in state.validators), np.uint64, n
        ),
        out["slashed"],
        previous_epoch,
    )
    return out


def unslashed_flag_mask(packed: dict, flag_index: int):
    """Boolean column: active-in-previous-epoch, unslashed, and holding
    participation ``flag_index`` — get_unslashed_participating_indices as
    a mask. Shared by the rewards and inactivity numpy twins so the flag
    semantics live in one place."""
    return (
        packed["active_previous"]
        & ~packed["slashed"]
        & (
            (packed["previous_participation"] >> np.uint8(flag_index))
            & np.uint8(1)
        ).astype(bool)
    )
