"""Light-client document production off pipeline-committed snapshots.

Bootstraps, updates, finality + optimistic updates (the altair
light-client sync protocol objects) built from ``HeadStore`` snapshots:
the committed state supplies the sync committees and the header (its
``latest_block_header`` with ``state_root`` filled is the head block's
header — the ``head_block_root`` identity the serving oracle
test-asserts), the committed signed BLOCK — retained on the snapshot by
the pipeline's state channel — supplies the
``sync_aggregate``/``signature_slot`` pair and, on capella+, the body
the ``execution_branch`` is proven over. Every branch comes off the
warm stored-levels walker (proofs/extract.py), so producing an update
against a just-committed head costs tree-depth node reads.

Branch depths are derived from the ACTUAL state type via
``get_generalized_index`` — never hardcoded — which is also what pinned
the electra container drift (electra's 37-field state
pushes ``finalized_checkpoint.root`` to depth 7 and the sync committees
to depth 6; the inherited deneb vectors declared 6 and 5).

Unservable requests raise ``serving.oracle.BadRequest`` (handler 400)
or ``LookupError`` (handler 404): pre-altair states, snapshots without
a retained block where one is required, unretained attested/finalized
ancestors.

Reference parity: ethereum_consensus_tpu/proofs/light_client.py.
"""

from __future__ import annotations

from ..fork import Fork
from ..ssz import core as _core
from ..types import FORK_SEQUENCE, fork_module
from .extract import ProofContext

__all__ = [
    "fork_of",
    "light_client_header",
    "light_client_bootstrap",
    "light_client_update",
    "light_client_finality_update",
    "light_client_optimistic_update",
    "light_client_updates",
    "sync_committee_period",
]

_ZERO32 = b"\x00" * 32

# forks carrying an execution payload header inside LightClientHeader
_EXECUTION_HEADER_FORKS = ("capella", "deneb", "electra")


def _bad_request(message: str):
    from ..serving.oracle import BadRequest

    return BadRequest(message)


def fork_of(snap) -> str:
    """The snapshot's fork name — the wrapper's version tag when the
    pipeline published it, else detected from the container class."""
    if snap.fork:
        return snap.fork
    preset = snap.context.preset
    for fork in reversed(FORK_SEQUENCE):
        try:
            if type(snap.raw) is fork_module(fork).build(preset).BeaconState:
                return fork.name.lower()
        except Exception:  # noqa: BLE001 — kind absent in fork
            continue
    raise _bad_request("snapshot state is not a known BeaconState")


def _ns(snap):
    fork = fork_of(snap)
    if fork == "phase0":
        raise _bad_request("light-client data requires an altair+ state")
    return fork_module(Fork[fork.upper()]).build(snap.context.preset), fork


def _beacon_header(snap):
    """The snapshot's own block header: ``latest_block_header`` with the
    state root filled the way ``process_slot`` fills it (the snapshot
    root is that state root — no re-hash)."""
    header = snap.raw.latest_block_header.copy()
    if bytes(header.state_root) == _ZERO32:
        header.state_root = snap.root
    return header


def light_client_header(snap, ns=None, fork=None):
    """The fork's ``LightClientHeader`` for the snapshot's head block.
    capella+ headers embed the execution payload header (the state's
    ``latest_execution_payload_header`` IS the head block's, by
    ``process_execution_payload``) plus the ``execution_branch`` proven
    over the retained block body — no body retained, no header."""
    if ns is None:
        ns, fork = _ns(snap)
    beacon = _beacon_header(snap)
    if fork not in _EXECUTION_HEADER_FORKS:
        return ns.LightClientHeader(beacon=beacon)
    block = getattr(snap, "block", None)
    if block is None:
        raise _bad_request(
            f"{fork} light-client headers need the committed block "
            "(execution_branch is proven over its body); this snapshot "
            "retained none"
        )
    body = block.message.body
    body = getattr(body, "data", body)
    body_t = type(body)
    gi = _core.get_generalized_index(body_t, "execution_payload")
    branch = ProofContext(body_t, body).proof(gi)
    return ns.LightClientHeader(
        beacon=beacon,
        execution=snap.raw.latest_execution_payload_header.copy(),
        execution_branch=branch,
    )


def light_client_bootstrap(snap):
    """Spec ``create_light_client_bootstrap`` off one snapshot: the
    header, the state's CURRENT sync committee, and its branch extracted
    warm off the stored levels."""
    ns, fork = _ns(snap)
    state_t = type(snap.raw)
    gi = _core.get_generalized_index(state_t, "current_sync_committee")
    branch = ProofContext(state_t, snap.raw).proof(gi)
    return (
        ns.LightClientBootstrap(
            header=light_client_header(snap, ns, fork),
            current_sync_committee=snap.raw.current_sync_committee,
            current_sync_committee_branch=branch,
        ),
        fork,
    )


def _attested_for(store, snap):
    """(attested snapshot, sync_aggregate, signature_slot) for the block
    committed at ``snap``: the aggregate in the block body signs the
    PARENT block's state — resolved through the store's block-root
    index."""
    block = getattr(snap, "block", None)
    if block is None:
        raise _bad_request(
            "light-client updates need the committed block (its "
            "sync_aggregate signs the attested header); this snapshot "
            "retained none"
        )
    attested = store.resolve(bytes(block.message.parent_root))
    if attested is None:
        raise LookupError(
            "attested (parent) snapshot not retained by the store"
        )
    return attested, block.message.body.sync_aggregate, int(block.message.slot)


def _header_as(header, fork, ns_to, fork_to):
    """Spec ``upgrade_lc_header_to_*``: re-type ``header`` (built in
    ``fork``) as ``fork_to``'s ``LightClientHeader``. An update's
    finalized header can lag the attested fork across a boundary, but
    the update container is declared in the ATTESTED fork — fields the
    older fork lacks stay at their defaults, exactly as the spec's
    upgrade chain leaves them."""
    if fork_to == fork:
        return header
    out = ns_to.LightClientHeader.default()
    out.beacon = header.beacon
    if fork in _EXECUTION_HEADER_FORKS:  # fork_to is newer, so capella+
        for name in type(out.execution).fields():
            if hasattr(header.execution, name):
                setattr(out.execution, name, getattr(header.execution, name))
        out.execution_branch = list(header.execution_branch)
    return out


def _finalized_parts(store, attested):
    """(finalized_header, finality_branch) proven on the ATTESTED state.
    A zero finalized root (pre-finality) serves the spec's empty header;
    a non-zero root must resolve through the block-root index."""
    ns, fork = _ns(attested)
    state_t = type(attested.raw)
    gi = _core.get_generalized_index(
        state_t, "finalized_checkpoint", "root"
    )
    branch = ProofContext(state_t, attested.raw).proof(gi)
    fin_root = bytes(attested.raw.finalized_checkpoint.root)
    if fin_root == _ZERO32:
        return ns.LightClientHeader.default(), branch
    finalized = store.resolve(fin_root)
    if finalized is None:
        raise LookupError("finalized snapshot not retained by the store")
    return (
        _header_as(light_client_header(finalized), fork_of(finalized), ns, fork),
        branch,
    )


def light_client_update(store, snap=None):
    """Spec ``create_light_client_update`` for the block committed at
    ``snap`` (default: head): attested header + NEXT sync committee and
    branch proven on the attested state, the finality pair, and the
    block's sync aggregate."""
    snap = snap if snap is not None else store.head
    if snap is None:
        raise LookupError("no snapshot published")
    attested, aggregate, signature_slot = _attested_for(store, snap)
    ns, fork = _ns(attested)
    state_t = type(attested.raw)
    gi = _core.get_generalized_index(state_t, "next_sync_committee")
    next_branch = ProofContext(state_t, attested.raw).proof(gi)
    finalized_header, finality_branch = _finalized_parts(store, attested)
    return (
        ns.LightClientUpdate(
            attested_header=light_client_header(attested, ns, fork),
            next_sync_committee=attested.raw.next_sync_committee,
            next_sync_committee_branch=next_branch,
            finalized_header=finalized_header,
            finality_branch=finality_branch,
            sync_aggregate=aggregate,
            signature_slot=signature_slot,
        ),
        fork,
    )


def light_client_finality_update(store, snap=None):
    snap = snap if snap is not None else store.head
    if snap is None:
        raise LookupError("no snapshot published")
    attested, aggregate, signature_slot = _attested_for(store, snap)
    ns, fork = _ns(attested)
    finalized_header, finality_branch = _finalized_parts(store, attested)
    return (
        ns.LightClientFinalityUpdate(
            attested_header=light_client_header(attested, ns, fork),
            finalized_header=finalized_header,
            finality_branch=finality_branch,
            sync_aggregate=aggregate,
            signature_slot=signature_slot,
        ),
        fork,
    )


def light_client_optimistic_update(store, snap=None):
    snap = snap if snap is not None else store.head
    if snap is None:
        raise LookupError("no snapshot published")
    attested, aggregate, signature_slot = _attested_for(store, snap)
    ns, fork = _ns(attested)
    return (
        ns.LightClientOptimisticUpdate(
            attested_header=light_client_header(attested, ns, fork),
            sync_aggregate=aggregate,
            signature_slot=signature_slot,
        ),
        fork,
    )


def sync_committee_period(snap) -> int:
    ctx = snap.context
    return int(snap.slot) // (
        int(ctx.EPOCHS_PER_SYNC_COMMITTEE_PERIOD) * int(ctx.SLOTS_PER_EPOCH)
    )


def light_client_updates(store, start_period: int, count: int) -> list:
    """Best-effort ``updates?start_period=&count=``: one update per
    requested sync-committee period, produced from the NEWEST retained
    snapshot of that period whose attested ancestor is also retained —
    a bounded store serves the recent periods, exactly what a following
    light client polls for."""
    if count < 1:
        return []
    wanted = range(int(start_period), int(start_period) + int(count))
    out: dict = {}
    for snap in reversed(store.snapshots()):
        if getattr(snap, "block", None) is None:
            continue
        period = sync_committee_period(snap)
        if period not in wanted or period in out:
            continue
        try:
            out[period] = light_client_update(store, snap)
        except LookupError:
            continue  # unretained ancestor: an older snapshot may serve
        except Exception as exc:  # noqa: BLE001 — BadRequest only
            from ..serving.oracle import BadRequest

            if isinstance(exc, BadRequest):
                continue
            raise
    return [out[p] for p in sorted(out)]
