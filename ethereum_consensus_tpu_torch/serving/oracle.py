"""Scalar oracle for the Beacon-API read plane.

Pure per-validator Python over the SSZ containers — no numpy, no column
caches. Every function here produces the EXACT document its columnar
twin in ``serving/views.py``/``serving/handlers.py`` serves; the
differential tests diff the two byte-for-byte. It is also the live
fallback when the columnar engine is unavailable (``serving.fallback``
counts).

Committees, duties, and sync committees have no columnar twin — the
spec helpers (cached shuffles, proposer sampling) ARE the single
implementation — so this module is their one source of truth too; the
handlers call straight in here for those documents.

Reference parity: ethereum_consensus_tpu/serving/oracle.py.
"""

from __future__ import annotations

from hashlib import sha256

from ..domains import DomainType
from ..models.altair.block_processing import _registry_pubkey_index
from ..models.phase0 import helpers as h
from ..primitives import FAR_FUTURE_EPOCH

__all__ = [
    "validator_status",
    "validator_row",
    "validators_data",
    "balances_data",
    "committees_data",
    "sync_committees_data",
    "attester_duty_map",
    "attester_duties_data",
    "proposer_duties_data",
    "rewards_summary_data",
    "resolve_validator_ids",
]

# spec constant (not in the preset tables): sync committee subnets
SYNC_COMMITTEE_SUBNET_COUNT = 4


class BadRequest(ValueError):
    """Maps to HTTP 400 in the handler layer."""


def validator_status(validator, balance: int, epoch: int) -> str:
    """The standard Beacon-API status machine — the scalar twin of
    ``views.status_code_column`` (kept in lockstep, differentially
    tested)."""
    activation = int(validator.activation_epoch)
    exit_epoch = int(validator.exit_epoch)
    if epoch < activation:
        if int(validator.activation_eligibility_epoch) == FAR_FUTURE_EPOCH:
            return "pending_initialized"
        return "pending_queued"
    if epoch < exit_epoch:
        if bool(validator.slashed):
            return "active_slashed"
        if exit_epoch != FAR_FUTURE_EPOCH:
            return "active_exiting"
        return "active_ongoing"
    if epoch < int(validator.withdrawable_epoch):
        return "exited_slashed" if bool(validator.slashed) else "exited_unslashed"
    return "withdrawal_possible" if int(balance) != 0 else "withdrawal_done"


def validator_row(state, index: int, epoch: int, status=None) -> dict:
    """One wire row of the validators endpoint. The ``validator`` object
    is the container's own JSON codec — both paths emit it, so the row
    is identical columnar or scalar by construction except for
    balance/status, which the tests diff."""
    validator = state.validators[index]
    balance = int(state.balances[index])
    return {
        "index": str(index),
        "balance": str(balance),
        "status": (
            status
            if status is not None
            else validator_status(validator, balance, epoch)
        ),
        "validator": type(validator).to_json(validator),
    }


def current_epoch(state, context) -> int:
    return int(state.slot) // int(context.SLOTS_PER_EPOCH)


def resolve_validator_ids(state, ids) -> "list[int]":
    """``?id=`` values (decimal indices and/or 0x-pubkeys) → registry
    indices. Unknown pubkeys and out-of-range indices are dropped (the
    standard list-endpoint behavior); a malformed value raises
    ``BadRequest``. Order and duplicates are preserved — the response
    mirrors the request."""
    n = len(state.validators)
    out: list = []
    pubkey_index = None
    for value in ids:
        value = value.strip()
        if value.startswith("0x"):
            try:
                key = bytes.fromhex(value[2:])
            except ValueError:
                raise BadRequest(f"malformed validator id {value!r}") from None
            if len(key) != 48:
                raise BadRequest(f"validator pubkey must be 48 bytes: {value!r}")
            if pubkey_index is None:
                pubkey_index = _registry_pubkey_index(state)
            hit = pubkey_index.get(key)
            if hit is not None:
                out.append(hit)
        elif value.isdigit():
            index = int(value)
            if index < n:
                out.append(index)
        else:
            raise BadRequest(f"malformed validator id {value!r}")
    return out


def validators_data(state, context, indices=None, statuses=None) -> list:
    """The scalar validators document: a full per-validator walk —
    exactly the cost model the columnar gather replaces."""
    epoch = current_epoch(state, context)
    rows = []
    index_iter = (
        range(len(state.validators)) if indices is None else indices
    )
    for index in index_iter:
        validator = state.validators[index]
        balance = int(state.balances[index])
        status = validator_status(validator, balance, epoch)
        if statuses is not None and status not in statuses:
            continue
        rows.append(
            {
                "index": str(index),
                "balance": str(balance),
                "status": status,
                "validator": type(validator).to_json(validator),
            }
        )
    return rows


def balances_data(state, indices=None) -> list:
    index_iter = (
        range(len(state.balances)) if indices is None else indices
    )
    return [
        {"index": str(index), "balance": str(int(state.balances[index]))}
        for index in index_iter
    ]


def _validate_epoch_window(state, context, epoch: int, what: str) -> None:
    cur = current_epoch(state, context)
    if not (max(0, cur - 1) <= epoch <= cur + 1):
        raise BadRequest(
            f"{what} epoch {epoch} outside the served window "
            f"[{max(0, cur - 1)}, {cur + 1}] of the state at slot "
            f"{int(state.slot)}"
        )


def committees_data(state, context, epoch=None, index=None, slot=None) -> list:
    """Every (slot, committee) row of ``epoch`` (default: the state's
    current epoch), optionally narrowed by ``?index=``/``?slot=`` — the
    spec committee machinery (cached shuffles) is the single source."""
    spe = int(context.SLOTS_PER_EPOCH)
    if slot is not None and epoch is not None and slot // spe != epoch:
        raise BadRequest(f"slot {slot} is not in epoch {epoch}")
    if epoch is None:
        epoch = (
            slot // spe if slot is not None else current_epoch(state, context)
        )
    _validate_epoch_window(state, context, epoch, "committees")
    slots = (slot,) if slot is not None else range(epoch * spe, (epoch + 1) * spe)
    per_slot = h.get_committee_count_per_slot(state, epoch, context)
    if index is not None and index >= per_slot:
        raise BadRequest(
            f"committee index {index} out of range ({per_slot} per slot)"
        )
    rows = []
    for s in slots:
        for committee_index in (index,) if index is not None else range(per_slot):
            committee = h.get_beacon_committee(state, s, committee_index, context)
            rows.append(
                {
                    "index": str(committee_index),
                    "slot": str(s),
                    "validators": [str(v) for v in committee],
                }
            )
    return rows


def sync_committees_data(state, context, epoch=None) -> dict:
    """current/next sync committee pubkeys resolved to registry indices
    (plus the per-subnet aggregates). 400 outside the two stored
    periods or on a pre-altair state."""
    committee = getattr(state, "current_sync_committee", None)
    if committee is None:
        raise BadRequest("state has no sync committees (phase0)")
    period_epochs = int(context.EPOCHS_PER_SYNC_COMMITTEE_PERIOD)
    cur = current_epoch(state, context)
    if epoch is not None:
        delta = epoch // period_epochs - cur // period_epochs
        if delta == 1:
            committee = state.next_sync_committee
        elif delta != 0:
            raise BadRequest(
                f"epoch {epoch} outside the stored sync-committee periods "
                f"of the state at epoch {cur}"
            )
    pubkey_index = _registry_pubkey_index(state)
    indices = []
    for key in committee.public_keys:
        hit = pubkey_index.get(bytes(key))
        if hit is None:  # impossible for a spec-built committee
            raise BadRequest("sync committee member not in the registry")
        indices.append(hit)
    per_subnet = max(1, len(indices) // SYNC_COMMITTEE_SUBNET_COUNT)
    return {
        "validators": [str(i) for i in indices],
        "validator_aggregates": [
            [str(i) for i in indices[at : at + per_subnet]]
            for at in range(0, len(indices), per_subnet)
        ],
    }


def attester_duty_map(state, context, epoch: int) -> dict:
    """validator index → (slot, committee_index, committee_length,
    committees_at_slot, position) over every committee of ``epoch`` —
    built once per (snapshot, epoch), then a duties request is one dict
    lookup per requested validator."""
    _validate_epoch_window(state, context, epoch, "attester duties")
    spe = int(context.SLOTS_PER_EPOCH)
    per_slot = h.get_committee_count_per_slot(state, epoch, context)
    duty_map: dict = {}
    for s in range(epoch * spe, (epoch + 1) * spe):
        for committee_index in range(per_slot):
            committee = h.get_beacon_committee(state, s, committee_index, context)
            length = len(committee)
            for position, validator in enumerate(committee):
                duty_map[validator] = (
                    s, committee_index, length, per_slot, position,
                )
    return duty_map


def attester_duties_data(state, duty_map: dict, indices) -> list:
    rows = []
    for index in indices:
        duty = duty_map.get(index)
        if duty is None:  # not active in the epoch: omitted, per spec
            continue
        slot, committee_index, length, per_slot, position = duty
        rows.append(
            {
                "pubkey": "0x" + bytes(
                    state.validators[index].public_key
                ).hex(),
                "validator_index": str(index),
                "committee_index": str(committee_index),
                "committee_length": str(length),
                "committees_at_slot": str(per_slot),
                "validator_committee_index": str(position),
                "slot": str(slot),
            }
        )
    return rows


def proposer_duties_data(state, context, epoch: int) -> list:
    """One proposer per slot of ``epoch`` — the spec sampling
    (``compute_proposer_index``) with the per-slot seed derived exactly
    as ``get_beacon_proposer_index`` derives it, without mutating the
    snapshot's slot."""
    cur = current_epoch(state, context)
    if epoch != cur:
        raise BadRequest(
            f"proposer duties are served for the state's current epoch "
            f"{cur} only (requested {epoch})"
        )
    spe = int(context.SLOTS_PER_EPOCH)
    indices = list(h.get_active_validator_indices(state, epoch))
    seed_base = h.get_seed(state, epoch, DomainType.BEACON_PROPOSER, context)
    rows = []
    for s in range(epoch * spe, (epoch + 1) * spe):
        seed = sha256(seed_base + s.to_bytes(8, "little")).digest()
        proposer = h.compute_proposer_index(state, indices, seed, context)
        rows.append(
            {
                "pubkey": "0x" + bytes(
                    state.validators[proposer].public_key
                ).hex(),
                "validator_index": str(proposer),
                "slot": str(s),
            }
        )
    return rows


def head_block_root(state) -> bytes:
    """The head BLOCK's hash_tree_root derived from the state alone:
    ``latest_block_header`` with its ``state_root`` filled the way
    ``process_slot`` fills it. Identical to the pipeline's claimed block
    root for the same head (test-asserted), so pipeline-less publishes
    index the same way."""
    from ..models.phase0.containers import BeaconBlockHeader

    header = state.latest_block_header.copy()
    if bytes(header.state_root) == b"\x00" * 32:
        header.state_root = type(state).hash_tree_root(state)
    return BeaconBlockHeader.hash_tree_root(header)


def dependent_root(state, context, epoch: int, duty: str,
                   head_root: "bytes | None" = None) -> bytes:
    """The ``dependent_root`` of a duties response: the block root the duty
    assignment is derived from, i.e. the last block before the epoch the
    shuffling seed reads.

    * proposer duties for ``epoch`` → block root at
      ``start_slot(epoch) - 1``;
    * attester duties for ``epoch`` → block root at
      ``start_slot(epoch - 1) - 1``;
    * a dependent slot before genesis → the genesis block root; at or
      past the state's slot → the head block root (``head_root`` when
      the caller has the pipeline's claimed one, else derived)."""
    spe = int(context.SLOTS_PER_EPOCH)
    if duty == "proposer":
        dep_slot = epoch * spe - 1
    else:
        dep_slot = max(0, epoch - 1) * spe - 1
    if 0 <= dep_slot < int(state.slot):
        return h.get_block_root_at_slot(state, dep_slot)
    if head_root is not None:
        return bytes(head_root)
    return head_block_root(state)


def rewards_summary_data(state, context) -> dict:
    """Scalar twin of ``views.rewards_summary_columnar`` — exact python
    ints over the literal containers."""
    from ..models.altair.constants import (
        TIMELY_HEAD_FLAG_INDEX,
        TIMELY_SOURCE_FLAG_INDEX,
        TIMELY_TARGET_FLAG_INDEX,
    )
    from ..models.altair.helpers import get_base_reward_per_increment

    participation = getattr(state, "previous_epoch_participation", None)
    if participation is None:
        raise BadRequest("state has no participation flags (phase0)")
    cur = current_epoch(state, context)
    previous_epoch = max(0, cur - 1)
    increment = int(context.EFFECTIVE_BALANCE_INCREMENT)
    active_count = eligible_count = 0
    active_balance = 0
    flag_balances = {"timely_source": 0, "timely_target": 0, "timely_head": 0}
    flag_bits = (
        ("timely_source", 1 << TIMELY_SOURCE_FLAG_INDEX),
        ("timely_target", 1 << TIMELY_TARGET_FLAG_INDEX),
        ("timely_head", 1 << TIMELY_HEAD_FLAG_INDEX),
    )
    for index, validator in enumerate(state.validators):
        active = h.is_active_validator(validator, previous_epoch)
        slashed = bool(validator.slashed)
        if active:
            active_count += 1
            active_balance += int(validator.effective_balance)
        if active or (
            slashed and previous_epoch + 1 < int(validator.withdrawable_epoch)
        ):
            eligible_count += 1
        if active and not slashed:
            flags = int(participation[index])
            for name, bit in flag_bits:
                if flags & bit:
                    flag_balances[name] += int(validator.effective_balance)
    return {
        "epoch": str(previous_epoch),
        "active_validators": str(active_count),
        "eligible_validators": str(eligible_count),
        "total_active_balance": str(max(increment, active_balance)),
        "base_reward_per_increment": str(
            int(get_base_reward_per_increment(state, context))
        ),
        "participation": {
            name: str(max(increment, balance))
            for name, balance in flag_balances.items()
        },
    }
