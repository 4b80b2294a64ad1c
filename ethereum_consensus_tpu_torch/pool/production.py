"""Block production: drain the pool against a HeadStore snapshot.

``produce_block`` builds a valid block for ``snapshot.slot + 1`` (or a
requested slot) whose body is packed from the pool: the vectorized
best-aggregate selection's attestations, plus every still-valid exit,
slashing, and BLS-to-execution change up to the fork's per-block caps.
Candidate ops are TRIAL-EXECUTED in block operation order on one scratch
copy of the advanced state (signature checks deferred — they were proven
at admission), so an op invalidated since admission (an exit for a
meanwhile-slashed validator, a slashing already applied on chain) is
dropped instead of poisoning the block. The final body then replays
through the fork's own ``process_block`` — every signature, including
the pool's aggregates, re-proves in one RLC flush — before the state
root is stamped, so a produced block is valid by construction and
replays bit-identically through the scalar oracle.

Key material never lives here: ``randao`` and ``sign`` are callbacks
``randao(state, slot, context) -> bytes`` and ``sign(state, block,
context) -> bytes`` (the scenario-mutator convention). Without ``sign`` the
signed envelope carries an empty signature — view-only production.
Execution-payload forks (bellatrix+) take ``body_extras(state, slot,
context) -> dict`` to supply the payload (and any other body fields);
phase0/altair production is self-contained — an empty sync aggregate is
the G2 infinity point per the no-participants rule.

Reference parity: ethereum_consensus_tpu/pool/production.py. The
replay's flush runs ``crypto/bls.py``'s batch, whose key sums go to B6
once the batch carries ``BLS_AGG_MIN_N`` keys; a kernel that fails
raises out of ``produce_block``.
"""

from __future__ import annotations

import time

from ..error import Error
from ..models.signature_batch import collect_signatures
from ..telemetry import metrics as _metrics
from ..utils import trace
from .selection import select_aggregates

__all__ = ["produce_block", "ProductionError", "eligible_groups"]

_G2_INFINITY = b"\xc0" + b"\x00" * 95


class ProductionError(Error):
    """Block production could not assemble a valid block."""


def _fork_module(fork: str):
    import importlib

    return importlib.import_module(f"..models.{fork}", __package__)


def eligible_groups(pool, state, slot: int, context, fork: str) -> list:
    """The pool's aggregate groups includable at ``slot`` on ``state``:
    inside the inclusion window, targeting the right epoch, sourcing the
    state's matching justified checkpoint — the non-crypto half of the
    fork's attestation validation, applied group-wise (every row of a
    group shares its data)."""
    spe = int(context.SLOTS_PER_EPOCH)
    current_epoch = int(state.slot) // spe
    previous_epoch = max(0, current_epoch - 1)
    electra = fork == "electra"
    out = []
    for group in pool.groups():
        if group.slot + int(context.MIN_ATTESTATION_INCLUSION_DELAY) > slot:
            continue
        if not electra and group.slot + spe < slot:
            continue
        data = group.attestations[0].data
        target_epoch = int(data.target.epoch)
        if target_epoch not in (previous_epoch, current_epoch):
            continue
        source = (
            state.current_justified_checkpoint
            if target_epoch == current_epoch
            else state.previous_justified_checkpoint
        )
        if data.source != source:
            continue
        out.append(group)
    return out


def _trial(fn, scratch, op, context) -> bool:
    """Structurally apply one candidate op on the production scratch
    (signatures collected, not verified — admission proved them);
    False drops the candidate."""
    try:
        with collect_signatures():
            fn(scratch, op, context)
        return True
    except Error:
        _metrics.counter("pool.production.dropped").inc()
        return False


def produce_block(snapshot, pool, context, slot: "int | None" = None,
                  randao=None, sign=None, body_extras=None,
                  scalar_selection: bool = False):
    """Drain the pool into a signed block on top of ``snapshot``.

    Returns the fork's ``SignedBeaconBlock`` (empty signature when no
    ``sign`` callback). Raises ``ProductionError`` when the assembled
    body cannot replay cleanly — a bug or a poisoned pool, never a
    normal outcome."""
    t0 = time.perf_counter()
    fork = snapshot.fork
    mod = _fork_module(fork)
    ns = mod.build(context.preset)
    from ..models.phase0 import helpers as h
    from ..models.phase0.containers import BeaconBlockHeader

    state = snapshot.raw.copy()
    if slot is None:
        slot = int(snapshot.slot) + 1
    slot = int(slot)
    with trace.span("pool.produce", slot=slot, fork=fork):
        if int(state.slot) < slot:
            mod.slot_processing.process_slots(state, slot, context)
        proposer_index = h.get_beacon_proposer_index(state, context)
        bp = mod.block_processing

        # trial-execute candidates in block operation order on ONE
        # scratch: later ops see earlier ops' effects exactly as the
        # real block application will
        v_scratch = state.copy()
        electra = fork == "electra"
        max_ps = int(context.MAX_PROPOSER_SLASHINGS)
        max_as = int(
            getattr(context, "MAX_ATTESTER_SLASHINGS_ELECTRA",
                    context.MAX_ATTESTER_SLASHINGS)
            if electra
            else context.MAX_ATTESTER_SLASHINGS
        )
        max_att = int(
            getattr(context, "MAX_ATTESTATIONS_ELECTRA",
                    context.MAX_ATTESTATIONS)
            if electra
            else context.MAX_ATTESTATIONS
        )
        max_exits = int(context.MAX_VOLUNTARY_EXITS)

        proposer_slashings = [
            op.copy() for op in pool.proposer_slashings()
            if _trial(bp.process_proposer_slashing, v_scratch, op, context)
        ][:max_ps]
        attester_slashings = [
            op.copy() for op in pool.attester_slashings()
            if _trial(bp.process_attester_slashing, v_scratch, op, context)
        ][:max_as]

        groups = eligible_groups(pool, state, slot, context, fork)
        picks = select_aggregates(groups, max_att, scalar=scalar_selection)
        attestations = []
        for group, row in picks:
            att = group.attestations[row].copy()
            if _trial(bp.process_attestation, v_scratch, att, context):
                attestations.append(att)

        voluntary_exits = [
            op.copy() for op in pool.voluntary_exits()
            if _trial(bp.process_voluntary_exit, v_scratch, op, context)
        ][:max_exits]

        body_kwargs = dict(
            randao_reveal=(
                randao(state, slot, context) if randao is not None
                else b"\x00" * 96
            ),
            eth1_data=state.eth1_data.copy(),
            proposer_slashings=proposer_slashings,
            attester_slashings=attester_slashings,
            attestations=attestations,
            voluntary_exits=voluntary_exits,
        )
        if fork != "phase0":
            body_kwargs["sync_aggregate"] = ns.SyncAggregate(
                sync_committee_bits=[False]
                * int(context.SYNC_COMMITTEE_SIZE),
                sync_committee_signature=_G2_INFINITY,
            )
        if "bls_to_execution_changes" in getattr(
            ns.BeaconBlockBody, "__ssz_fields__", {}
        ):
            changes = [
                op.copy() for op in pool.bls_changes()
                if _trial(
                    bp.process_bls_to_execution_change, v_scratch, op,
                    context,
                )
            ][: int(context.MAX_BLS_TO_EXECUTION_CHANGES)]
            body_kwargs["bls_to_execution_changes"] = changes
        if body_extras is not None:
            body_kwargs.update(body_extras(state, slot, context))
        body = ns.BeaconBlockBody(**body_kwargs)

        block = ns.BeaconBlock(
            slot=slot,
            proposer_index=proposer_index,
            parent_root=BeaconBlockHeader.hash_tree_root(
                state.latest_block_header
            ),
            body=body,
        )
        # the validity proof: the assembled body replays through the
        # fork's own process_block — every collected signature (randao,
        # pool aggregates, ops) proves in one RLC flush — before the
        # state root is stamped
        scratch = state.copy()
        try:
            if randao is None:
                with collect_signatures():
                    bp.process_block(scratch, block, context)
            else:
                with collect_signatures() as batch:
                    bp.process_block(scratch, block, context)
                batch.flush()
        except Error as exc:
            raise ProductionError(
                f"assembled block failed replay: {type(exc).__name__}: {exc}"
            ) from exc
        block.state_root = type(scratch).hash_tree_root(scratch)

        if sign is not None:
            signature = sign(state, block, context)
        else:
            signature = b"\x00" * 96
        signed = ns.SignedBeaconBlock(message=block, signature=signature)
    _metrics.counter("pool.blocks_produced").inc()
    _metrics.histogram("pool.produce_s").observe(time.perf_counter() - t0)
    return signed
