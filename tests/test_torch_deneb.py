"""The port's deneb fork against the reference package.

Every comparison hands the reference's SSZ bytes to the port and requires
identical post-state bytes and roots, the same verdict or the same error
class. Cases: the upgrade ladder phase0 → deneb through ``Executor`` (each
fork's first block on its upgrade slot) and ``upgrade_to_deneb`` from
capella alone; a signed deneb chain whose blocks carry blob commitments
across two epoch boundaries on the four routes of ``torch_routes.py``;
EIP-7514's activation cap on the columnar and literal routes, against
capella's exit churn limit; EIP-7045's inclusion window through the
columnar block engine and the scalar loop; EIP-7044's exit domain; the
blob commitments' versioned hashes, their per-block limit and an engine
that rejects the payload; and a blob sidecar's inclusion proof.
"""

import pytest

import chain_utils
import torch_genesis
from ethereum_consensus_tpu import error as ref_error
from ethereum_consensus_tpu import executor as ref_executor
from ethereum_consensus_tpu.domains import DomainType
from ethereum_consensus_tpu.models import capella as ref_capella
from ethereum_consensus_tpu.models import deneb as ref_deneb
from ethereum_consensus_tpu.models import epoch_vector as ref_epoch_vector
from ethereum_consensus_tpu.models.deneb import blob_sidecar as ref_sidecar
from ethereum_consensus_tpu.models.phase0 import containers as ref_phase0
from ethereum_consensus_tpu.signing import compute_signing_root
from ethereum_consensus_tpu.ssz import core as ref_ssz
from ethereum_consensus_tpu_torch import error as port_error
from ethereum_consensus_tpu_torch import executor as port_executor
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.fork import Fork
from ethereum_consensus_tpu_torch.models import deneb as port_deneb
from ethereum_consensus_tpu_torch.models import ops_vector
from ethereum_consensus_tpu_torch.models import phase0 as port_phase0
from ethereum_consensus_tpu_torch.models.deneb import blob_sidecar as port_sidecar
from ethereum_consensus_tpu_torch.primitives import FAR_FUTURE_EPOCH
from ethereum_consensus_tpu_torch.types import fork_module
from torch_routes import ROUTES, check_kernels, identity, route  # noqa: F401 (fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

LADDER_FORKS = ("phase0", "altair", "bellatrix", "capella", "deneb")
N_BLOCKS = 17  # slots 1..17 at 8 slots an epoch: boundaries into epochs 1 and 2


def _port_ctx(reference_ctx=None) -> Context:
    """A port context with the reference context's fork schedule."""
    ctx = Context.for_minimal()
    if reference_ctx is not None:
        for fork in LADDER_FORKS[1:]:
            name = f"{fork}_fork_epoch"
            setattr(ctx, name, getattr(reference_ctx, name))
    return ctx


def _port_type(fork: str, name: str):
    return getattr(fork_module(Fork.from_str(fork)).build(Context.for_minimal().preset), name)


def _ref_ns():
    return ref_deneb.build(chain_utils.Context.for_minimal().preset)


def _commitments(slot: int, count: "int | None" = None) -> list:
    """``slot % 4`` (or ``count``) distinct G1 points as blob commitments: a
    public key is a compressed G1 point."""
    count = slot % 4 if count is None else count
    return [chain_utils.public_key_bytes(1000 + 8 * slot + k) for k in range(count)]


def _outcomes(pre: bytes, block, ref_ctx=None, port_ctx=None) -> tuple:
    """(reference, port) outcome of applying the deneb ``block`` to the deneb
    state ``pre``: the error class's name, or the post-state's (bytes, root)."""
    ns = _ref_ns()
    data = ns.SignedBeaconBlock.serialize(block)
    ref = ref_executor.Executor(ns.BeaconState.deserialize(pre),
                                ref_ctx or chain_utils.Context.for_minimal())
    try:
        ref.apply_block(ns.SignedBeaconBlock.deserialize(data))
        ref_out = (ref.state.serialize(), ref.state.hash_tree_root())
    except ref_error.Error as exc:
        ref_out = type(exc).__name__
    port = port_executor.Executor(_port_type("deneb", "BeaconState").deserialize(pre),
                                  port_ctx or Context.for_minimal())
    try:
        port.apply_block(_port_type("deneb", "SignedBeaconBlock").deserialize(data))
        port_out = (port.state.serialize(), port.state.hash_tree_root())
    except port_error.Error as exc:
        port_out = type(exc).__name__
    return ref_out, port_out


# ---------------------------------------------------------------------------
# the upgrade ladder through Executor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ladder():
    """The reference's signed chain from phase0 genesis up the forks, one an
    epoch (tests/chain_utils.py produce_full_upgrade_chain), cut after
    deneb's epoch; with the reference Executor's (fork, bytes, root) after
    every block."""
    state, ctx, blocks = torch_genesis.produce_full_upgrade_chain(64)
    blocks = [b for b in blocks
              if chain_utils.full_upgrade_fork_at_slot(int(b.message.slot), ctx) in LADDER_FORKS]
    ex = ref_executor.Executor(state.copy(), ctx)
    after = []
    for block in blocks:
        ex.apply_block(block)
        after.append((str(ex.state.version()), ex.state.serialize(), ex.state.hash_tree_root()))
    assert after[-1][0] == "deneb"
    return (type(state).serialize(state),
            [type(b).serialize(b) for b in blocks], after, ctx)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_upgrade_ladder_to_deneb_matches_reference(ladder, route):
    state_bytes, block_bytes, after, ref_ctx = ladder
    ctx = _port_ctx(ref_ctx)
    ex = port_executor.Executor(
        port_phase0.build(ctx.preset).BeaconState.deserialize(state_bytes), ctx)
    before = (route.counter.value(), route.fused_fallbacks())
    firsts = set()
    for data, (fork, post, root) in zip(block_bytes, after):
        block = _port_type(fork, "SignedBeaconBlock").deserialize(data)
        ex.apply_block(block)
        assert str(ex.state.version()) == fork
        assert identity(ex.state.data, post, root), f"{fork} block at slot {block.message.slot}"
        firsts.add(fork)
    assert firsts == set(LADDER_FORKS)
    # the boundaries into epochs 1 to 4 ran under phase0, altair, bellatrix
    # and capella rules (the upgrade to deneb follows the last); the fused
    # kernel runs the altair family's three
    boundaries = 4
    expected = boundaries - 1 if route.name == "device_fused" else boundaries
    assert (route.counter.value() - before[0], route.fused_fallbacks()) == (expected, before[1])
    check_kernels(route, expected)
    if route.name.startswith("device"):
        quotients = ("ALTAIR", "BELLATRIX", "BELLATRIX")
        assert route.denominators == [
            int(ctx.inactivity_score_bias) * int(getattr(ctx, f"INACTIVITY_PENALTY_QUOTIENT_{q}"))
            for q in quotients]


def test_upgrade_to_deneb_from_capella_matches_reference():
    state, ctx, blocks = torch_genesis.produce_full_upgrade_chain(64)
    ex = ref_executor.Executor(state.copy(), ctx)
    fork_slot = int(ctx.deneb_fork_epoch) * int(ctx.SLOTS_PER_EPOCH)
    for block in blocks:
        if int(block.message.slot) >= fork_slot:
            break
        ex.apply_block(block)
    capella_state = ex.state.data
    ref_capella.slot_processing.process_slots(capella_state, fork_slot, ctx)
    port_state = _port_type("capella", "BeaconState").deserialize(
        type(capella_state).serialize(capella_state))
    upgraded = ref_deneb.upgrade_to_deneb(capella_state, ctx)
    port_up = port_deneb.upgrade_to_deneb(port_state, _port_ctx(ctx))
    assert type(port_up) is _port_type("deneb", "BeaconState")
    assert identity(port_up, type(upgraded).serialize(upgraded),
                    type(upgraded).hash_tree_root(upgraded))
    assert int(port_up.latest_execution_payload_header.blob_gas_used) == 0
    assert bytes(port_up.fork.current_version) == bytes(ctx.deneb_fork_version)


# ---------------------------------------------------------------------------
# a signed deneb chain with blob commitments, across epoch boundaries
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def deneb_chain():
    """The reference's signed deneb chain from a deneb genesis, two
    aggregates and ``slot % 4`` blob commitments a block; with the
    reference's (bytes, root) after every block."""
    state, ctx = torch_genesis.fresh_genesis_deneb(64, "minimal")
    scratch = state.copy()
    transition = ref_deneb.state_transition
    blocks, pending = [], []
    for slot in range(1, N_BLOCKS + 1):
        block = chain_utils.produce_block_deneb(scratch, slot, ctx, attestations=pending,
                                                blob_kzg_commitments=_commitments(slot))
        transition.state_transition_block_in_slot(scratch, block, transition.Validation.ENABLED,
                                                  ctx)
        per_slot = ref_deneb.helpers.get_committee_count_per_slot(
            scratch, slot // int(ctx.SLOTS_PER_EPOCH), ctx)
        pending = [chain_utils.make_attestation(scratch, slot, index, ctx)
                   for index in range(min(2, per_slot))]
        blocks.append(block)
    ns = ref_deneb.build(ctx.preset)
    ex = ref_executor.Executor(ns.BeaconState.deserialize(ns.BeaconState.serialize(state)), ctx)
    after = []
    for block in blocks:
        ex.apply_block(block)
        after.append((ex.state.serialize(), ex.state.hash_tree_root()))
    assert sum(len(b.message.body.blob_kzg_commitments) for b in blocks) >= N_BLOCKS
    return (ns.BeaconState.serialize(state), [ns.SignedBeaconBlock.serialize(b) for b in blocks],
            after)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_deneb_chain_matches_reference(deneb_chain, route):
    state_bytes, block_bytes, after = deneb_chain
    ctx = Context.for_minimal()
    ex = port_executor.Executor(_port_type("deneb", "BeaconState").deserialize(state_bytes), ctx)
    block_type = _port_type("deneb", "SignedBeaconBlock")
    before, fallbacks = route.counter.value(), route.fused_fallbacks()
    for i, data in enumerate(block_bytes):
        ex.apply_block(block_type.deserialize(data))
        assert identity(ex.state.data, *after[i]), f"block {i + 1} differs"
    boundaries = N_BLOCKS // int(ctx.SLOTS_PER_EPOCH)
    # the fused kernel skips the genesis boundary like the stages it fuses
    expected = boundaries - 1 if route.name == "device_fused" else boundaries
    assert route.counter.value() - before == expected
    assert route.fused_fallbacks() == fallbacks
    check_kernels(route, expected)
    denominator = int(ctx.inactivity_score_bias) * int(ctx.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX)
    want = [denominator] * (boundaries - 1) if route.name.startswith("device") else []
    assert route.denominators == want


# ---------------------------------------------------------------------------
# EIP-7514: the activation churn cap
# ---------------------------------------------------------------------------

ACTIVE_EXTRA = 128  # 192 active validators: an exit churn limit of 6 on minimal
QUEUED = 12


def _queued_state(fork: str):
    """A genesis state of ``fork`` with ACTIVE_EXTRA more active validators
    (no real keys: the boundary reads none) and QUEUED eligible entrants."""
    state, ctx = torch_genesis.fresh_genesis_fork(fork, 64, "minimal")
    max_balance = int(ctx.MAX_EFFECTIVE_BALANCE)
    for k in range(ACTIVE_EXTRA + QUEUED):
        queued = k >= ACTIVE_EXTRA
        state.validators.append(ref_phase0.Validator(
            public_key=chain_utils.synthetic_pubkey_bytes(64 + k),
            withdrawal_credentials=b"\x00" * 32, effective_balance=max_balance,
            activation_eligibility_epoch=0,
            activation_epoch=FAR_FUTURE_EPOCH if queued else 0,
            exit_epoch=FAR_FUTURE_EPOCH, withdrawable_epoch=FAR_FUTURE_EPOCH))
        state.balances.append(max_balance)
        state.previous_epoch_participation.append(0)
        state.current_epoch_participation.append(0)
        state.inactivity_scores.append(0)
    for key in ("_active_idx_cache", "_proposer_cache", "_total_active_balance_cache",
                "_pubkey_index_cache"):
        state.__dict__.pop(key, None)
    return state, ctx


@pytest.mark.parametrize("route", ["columnar", "literal"], indirect=True)
@pytest.mark.parametrize("fork", ["deneb", "capella"])
def test_activation_churn_cap_matches_reference(fork, route, monkeypatch):
    state, ctx = _queued_state(fork)
    if route.name == "columnar":
        monkeypatch.setattr(ref_epoch_vector, "EPOCH_VECTOR_MIN_VALIDATORS", 0)
    pre = type(state).serialize(state)
    slot = int(ctx.SLOTS_PER_EPOCH)
    chain_utils._fork_module(fork).slot_processing.process_slots(state, slot, ctx)
    port_ctx = Context.for_minimal()
    port_state = _port_type(fork, "BeaconState").deserialize(pre)
    before = route.counter.value()
    fork_module(Fork.from_str(fork)).slot_processing.process_slots(port_state, slot, port_ctx)
    assert route.counter.value() - before == 1
    assert identity(port_state, type(state).serialize(state), type(state).hash_tree_root(state))
    churn = port_deneb.helpers.get_validator_churn_limit(port_state, port_ctx)
    assert churn == 6
    activated = sum(int(v.activation_epoch) != FAR_FUTURE_EPOCH
                    for v in port_state.validators[64 + ACTIVE_EXTRA:])
    cap = int(port_ctx.max_per_epoch_activation_churn_limit)
    assert activated == (min(cap, churn) if fork == "deneb" else churn)


# ---------------------------------------------------------------------------
# EIP-7045 and EIP-7044 through blocks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def late_attestation_block():
    """The deneb chain's state at slot 16 and a block at slot 17 carrying
    an aggregate of slot 8: included 9 slots late, more than an epoch,
    with its target the previous epoch. The chain carries no other
    attestation, so the aggregate's flags are the only ones of epoch 1."""
    state, ctx = torch_genesis.fresh_genesis_deneb(64, "minimal")
    blocks = chain_utils.produce_chain(state, ctx, 16, "deneb", atts_per_block=0)
    scratch = state.copy()
    for block in blocks:
        ref_deneb.state_transition.state_transition(scratch, block, ctx)
    late = chain_utils.make_attestation(scratch, 8, 0, ctx)
    block = chain_utils.produce_block_deneb(scratch.copy(), 17, ctx, attestations=[late])
    return type(scratch).serialize(scratch), block


@pytest.mark.parametrize("engine", ["columnar", "scalar"])
def test_late_attestation_is_accepted_like_reference(late_attestation_block, engine,
                                                     monkeypatch):
    pre, block = late_attestation_block
    if engine == "columnar":
        monkeypatch.setattr(ops_vector, "BATCH_MIN_VALIDATORS", 0)
    batched = []
    real = ops_vector.process_attestations_batch

    def recording(*args, **kwargs):
        batched.append(real(*args, **kwargs))
        return batched[-1]

    monkeypatch.setattr(ops_vector, "process_attestations_batch", recording)
    ref_out, port_out = _outcomes(pre, block)
    assert isinstance(port_out, tuple) and port_out == ref_out
    assert batched == [engine == "columnar"]
    # the target flag alone: too late for the source's and the head's
    post = _port_type("deneb", "BeaconState").deserialize(port_out[0])
    flags = {int(post.previous_epoch_participation[i]) for i in
             port_deneb.helpers.get_attesting_indices(
                 post, block.message.body.attestations[0].data,
                 block.message.body.attestations[0].aggregation_bits, Context.for_minimal())}
    assert flags == {0b010}


@pytest.mark.parametrize("version", ["capella", "deneb"])
def test_exit_domain_is_pinned_to_capella_like_reference(version):
    """EIP-7044: an exit signed under the capella fork version is valid in
    deneb; one signed under deneb's own version is not."""
    state, ctx = torch_genesis.fresh_genesis_deneb(64, "minimal")
    ctx.shard_committee_period = 0  # the genesis validators may exit at once
    port_ctx = Context.for_minimal()
    port_ctx.shard_committee_period = 0
    ns = _ref_ns()
    pre = type(state).serialize(state)
    message = ns.VoluntaryExit(epoch=0, validator_index=9)
    domain = ref_deneb.helpers.compute_domain(
        DomainType.VOLUNTARY_EXIT, getattr(ctx, f"{version}_fork_version"),
        bytes(state.genesis_validators_root), ctx)
    signature = chain_utils.secret_key(9).sign(
        compute_signing_root(ns.VoluntaryExit, message, domain)).to_bytes()
    signed_exit = ns.SignedVoluntaryExit(message=message, signature=signature)
    good_exit = signed_exit.copy()
    if version == "deneb":
        capella_domain = ref_deneb.helpers.compute_domain(
            DomainType.VOLUNTARY_EXIT, ctx.capella_fork_version,
            bytes(state.genesis_validators_root), ctx)
        good_exit.signature = chain_utils.secret_key(9).sign(
            compute_signing_root(ns.VoluntaryExit, message, capella_domain)).to_bytes()
    block = chain_utils.produce_block_fork("deneb", state.copy(), 1, ctx,
                                           voluntary_exits=[good_exit])
    block.message.body.voluntary_exits = [signed_exit]
    block.signature = chain_utils.sign_block(state, block.message, ctx)
    ref_out, port_out = _outcomes(pre, block, ctx, port_ctx)
    assert port_out == ref_out
    if version == "capella":
        post = _port_type("deneb", "BeaconState").deserialize(port_out[0])
        assert int(post.validators[9].exit_epoch) != FAR_FUTURE_EPOCH
    else:
        assert port_out == "InvalidVoluntaryExit"


# ---------------------------------------------------------------------------
# blob commitments in the execution payload, and a blob sidecar
# ---------------------------------------------------------------------------


def test_versioned_hashes_are_equal():
    for commitment in _commitments(3) + [b"\x00" * 48]:
        want = ref_deneb.helpers.kzg_commitment_to_versioned_hash(commitment)
        assert port_deneb.helpers.kzg_commitment_to_versioned_hash(commitment) == want
        assert want[:1] == b"\x01"


@pytest.mark.parametrize("case", ["at_limit", "over_limit", "engine_rejects"])
def test_blob_payload_checks_match_reference(case):
    state, ctx = torch_genesis.fresh_genesis_deneb(64, "minimal")
    pre = type(state).serialize(state)
    limit = int(ctx.MAX_BLOBS_PER_BLOCK)
    block = chain_utils.produce_block_deneb(state.copy(), 1, ctx,
                                            blob_kzg_commitments=_commitments(1, limit))
    ref_ctx, port_ctx = chain_utils.Context.for_minimal(), Context.for_minimal()
    if case == "over_limit":
        block.message.body.blob_kzg_commitments.append(_commitments(2, 1)[0])
        block.signature = chain_utils.sign_block(state, block.message, ctx)
    elif case == "engine_rejects":
        ref_ctx.execution_engine = port_ctx.execution_engine = False
    ref_out, port_out = _outcomes(pre, block, ref_ctx, port_ctx)
    assert port_out == ref_out
    if case == "at_limit":
        assert isinstance(port_out, tuple)
    else:
        assert port_out == {"over_limit": "InvalidBlobData",
                            "engine_rejects": "ExecutionEngineError"}[case]


@pytest.mark.parametrize("index", [0, 5])
def test_blob_sidecar_inclusion_proof_matches_reference(index):
    state, ctx = torch_genesis.fresh_genesis_deneb(64, "minimal")
    ns = _ref_ns()
    block = chain_utils.produce_block_deneb(state.copy(), 1, ctx,
                                            blob_kzg_commitments=_commitments(1, 6)).message
    body = block.body
    gindex = ref_ssz.get_generalized_index(ns.BeaconBlockBody, "blob_kzg_commitments", index)
    branch = ref_ssz.prove(ns.BeaconBlockBody, body, gindex)
    assert len(branch) == int(ctx.KZG_COMMITMENT_INCLUSION_PROOF_DEPTH)
    header = ref_phase0.BeaconBlockHeader(
        slot=block.slot, proposer_index=block.proposer_index, parent_root=block.parent_root,
        state_root=block.state_root, body_root=ns.BeaconBlockBody.hash_tree_root(body))
    sidecar = ns.BlobSidecar(
        index=index, kzg_commitment=body.blob_kzg_commitments[index],
        signed_block_header=ref_phase0.SignedBeaconBlockHeader(message=header),
        kzg_commitment_inclusion_proof=branch)
    changed = sidecar.copy()
    changed.kzg_commitment_inclusion_proof[3] = bytes(32 * [0x5A])
    port_ctx = Context.for_minimal()
    port_body = _port_type("deneb", "BeaconBlockBody")
    verdicts = []
    for candidate in (sidecar, changed):
        ref_verdict = ref_sidecar.verify_blob_sidecar_inclusion_proof(
            candidate, ns.BeaconBlockBody, ctx)
        port_candidate = _port_type("deneb", "BlobSidecar").deserialize(
            ns.BlobSidecar.serialize(candidate))
        port_verdict = port_sidecar.verify_blob_sidecar_inclusion_proof(
            port_candidate, port_body, port_ctx)
        verdicts.append((ref_verdict, port_verdict))
    assert verdicts == [(True, True), (False, False)]
    assert port_sidecar.get_subtree_index(gindex) == ref_sidecar.get_subtree_index(gindex)
