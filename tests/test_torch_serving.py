"""The port's Beacon-API read plane (serving/) against the reference.

Both packages' ``HeadStore``s hold the same commits of the reference's
five-boundary upgrade chain (``tests/torch_read_plane.py``), and every
route of ``BeaconDataPlane._dispatch`` is asked the same request on the
head of each fork, phase0 through electra: the same status and the same
JSON after ``sort_keys``, 400s and 404s included. Then the columnar and
scalar routes, ``state_id`` resolution, snapshot isolation across a
commit, a rollback that is never published, the one-gather-per-batch
rule, the status machine and the memory census's headstore probe.
"""

import json

import pytest

import chain_utils
import torch_genesis
from ethereum_consensus_tpu.models import ops_vector as ref_ops_vector
from ethereum_consensus_tpu.serving import BeaconDataPlane as RefDataPlane
from ethereum_consensus_tpu.serving import oracle as ref_oracle
from ethereum_consensus_tpu.serving import views as ref_views
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.error import InvalidBlock
from ethereum_consensus_tpu_torch.executor import Executor
from ethereum_consensus_tpu_torch.models import ops_vector
from ethereum_consensus_tpu_torch.models.phase0 import containers, helpers
from ethereum_consensus_tpu_torch.pipeline import ChainPipeline, FlushPolicy
from ethereum_consensus_tpu_torch.serving import BeaconDataPlane, HeadStore, oracle, views
from ethereum_consensus_tpu_torch.ssz import core
from ethereum_consensus_tpu_torch.telemetry import memory, metrics
from torch_read_plane import FORKS, chain, last_of, read, stores
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

STATES = "/eth/v1/beacon/states"


def _requests(fork: str, commit, state) -> list:
    """(method, path, params, body) of every route, with refusals."""
    epoch = commit.slot // 8
    pubkey = "0x" + bytes(state.validators[3].public_key).hex()
    unknown = "0x" + "ab" * 48
    head_root = "0x" + commit.root.hex()
    block_root = "0x" + (commit.block_root or b"\0" * 32).hex()
    g_slot = core.get_generalized_index(type(state), "slot")
    g_val = core.get_generalized_index(type(state), "validators", 9)
    g_bal = core.get_generalized_index(type(state), "balances", 40)
    get = "GET"
    return [
        (get, "/eth/v1/beacon/genesis", {}, None),
        (get, f"{STATES}/head/root", {}, None),
        (get, f"{STATES}/{head_root}/root", {}, None),
        (get, f"{STATES}/{block_root}/root", {}, None),
        (get, f"{STATES}/{commit.slot}/fork", {}, None),
        (get, f"{STATES}/head/finality_checkpoints", {}, None),
        (get, f"{STATES}/finalized/root", {}, None),
        (get, f"{STATES}/justified/root", {}, None),
        (get, f"{STATES}/genesis/root", {}, None),
        (get, f"{STATES}/head/randao", {}, None),
        (get, f"{STATES}/head/randao", {"epoch": [str(max(0, epoch - 1))]}, None),
        (get, f"{STATES}/head/validators", {}, None),
        (get, f"{STATES}/head/validators", {"id": [f"0,5,{pubkey},63", unknown, "999"]}, None),
        (get, f"{STATES}/head/validators", {"status": ["active", "pending_queued"]}, None),
        (get, f"{STATES}/head/validators", {"status": ["withdrawal"], "id": ["1,2"]}, None),
        (get, f"{STATES}/head/validators", {"status": ["nonsense"]}, None),
        (get, f"{STATES}/head/validators", {"id": ["zzz"]}, None),
        (get, f"{STATES}/head/validators", {"id": ["0x1234"]}, None),
        (get, f"{STATES}/head/validators/7", {}, None),
        (get, f"{STATES}/head/validators/{pubkey}", {}, None),
        (get, f"{STATES}/head/validators/999999", {}, None),
        (get, f"{STATES}/head/validator_balances", {}, None),
        (get, f"{STATES}/head/validator_balances", {"id": ["1,2,3", pubkey]}, None),
        (get, f"{STATES}/head/committees", {}, None),
        (get, f"{STATES}/head/committees", {"epoch": [str(epoch)], "index": ["0"]}, None),
        (get, f"{STATES}/head/committees", {"slot": [str(commit.slot)]}, None),
        (get, f"{STATES}/head/committees", {"epoch": ["99"]}, None),
        (get, f"{STATES}/head/committees", {"index": ["7"]}, None),
        (get, f"{STATES}/head/committees", {"slot": ["0"], "epoch": ["1"]}, None),
        (get, f"{STATES}/head/sync_committees", {}, None),
        (get, f"{STATES}/head/sync_committees", {"epoch": [str(epoch + 8)]}, None),
        (get, f"{STATES}/head/sync_committees", {"epoch": ["4096"]}, None),
        (get, f"{STATES}/head/epoch_rewards", {}, None),
        (get, f"{STATES}/head/proof", {"gindex": [str(g_slot)]}, None),
        (get, f"{STATES}/head/proof", {"gindex": [f"{g_val},{g_bal}", str(g_slot)]}, None),
        (get, f"{STATES}/head/proof", {}, None),
        (get, f"{STATES}/head/proof", {"gindex": ["x"]}, None),
        (get, f"{STATES}/head/proof", {"gindex": ["0"]}, None),
        (get, f"/eth/v1/beacon/light_client/bootstrap/{block_root}", {}, None),
        (get, "/eth/v1/beacon/light_client/bootstrap/0x" + "00" * 32, {}, None),
        (get, "/eth/v1/beacon/light_client/updates", {"start_period": ["0"], "count": ["4"]}, None),
        (get, "/eth/v1/beacon/light_client/updates", {"count": ["4"]}, None),
        (get, "/eth/v1/beacon/light_client/finality_update", {}, None),
        (get, "/eth/v1/beacon/light_client/optimistic_update", {}, None),
        (get, "/eth/v1/beacon/light_client/nope", {}, None),
        ("POST", f"/eth/v1/validator/duties/attester/{epoch}", {}, [0, 1, 2, 9, 63, 999]),
        ("POST", f"/eth/v1/validator/duties/attester/{epoch + 1}", {}, ["5", pubkey]),
        ("POST", f"/eth/v1/validator/duties/attester/{epoch}", {}, {"not": "a list"}),
        ("POST", "/eth/v1/validator/duties/attester/99", {}, [1]),
        (get, f"/eth/v1/validator/duties/proposer/{epoch}", {}, None),
        (get, "/eth/v1/validator/duties/proposer/99", {}, None),
        (get, f"{STATES}/nonsense/validators", {}, None),
        (get, f"{STATES}/4091/root", {}, None),
        (get, f"{STATES}/head/nope", {}, None),
        ("POST", f"{STATES}/head/root", {}, None),
        (get, "/eth/v2/debug/beacon/states/head", {}, None),
    ]


def _answer(plane, request) -> tuple:
    status, doc = plane.handle(*request)
    return status, json.dumps(doc, sort_keys=True)


@pytest.mark.parametrize("fork", FORKS)
def test_every_route_equals_reference(fork):
    upto = last_of(fork)
    plane = BeaconDataPlane(stores("port", upto))
    ref_plane = RefDataPlane(stores("ref", upto))
    commits, _ = chain()
    commit = commits[upto]
    state = read("port", commit)[0]
    statuses = set()
    for request in _requests(fork, commit, state):
        got = _answer(plane, request)
        assert got == _answer(ref_plane, request), request
        statuses.add(got[0])
        if request[1].endswith("/proof") and got[0] == 200:
            doc = json.loads(got[1])["data"]
            assert doc["proof"]
    assert {200, 400, 404} <= statuses


@pytest.mark.parametrize("fork", ["phase0", "electra"])
def test_scalar_fallback_serves_the_columnar_bytes(fork, monkeypatch):
    """With the columnar engine off (``ECT_OPS_VECTOR=off``) a fresh
    snapshot has no bundle and serves every registry route from the scalar
    oracle: the same bytes."""
    upto = last_of(fork)
    commits, _ = chain()
    commit = commits[upto]
    state = read("port", commit)[0]
    registry = [r for r in _requests(fork, commit, state)
                if any(k in r[1] for k in ("validator", "epoch_rewards"))]
    columnar = [_answer(BeaconDataPlane(stores("port", upto, start=upto)), r) for r in registry]
    monkeypatch.setenv("ECT_OPS_VECTOR", "off")
    store = stores("port", upto, start=upto)
    assert store.head.bundle() is None
    before = metrics.counter("serving.fallback").value()
    scalar = [_answer(BeaconDataPlane(store), r) for r in registry]
    assert scalar == columnar
    assert metrics.counter("serving.fallback").value() > before


def test_state_id_resolution_equals_reference():
    upto = last_of("capella")
    store, ref_store = stores("port", upto), stores("ref", upto)
    commits, _ = chain()
    ids = ["head", "finalized", "justified", "genesis", "0", "7", "9", str(commits[upto].slot),
           "4091", "nonsense", "0xzz", "0x" + "ab" * 32]
    ids += ["0x" + c.root.hex() for c in commits[: upto + 1: 5]]
    ids += ["0x" + c.block_root.hex() for c in commits[1: upto + 1: 5]]
    for state_id in ids:
        got, want = store.resolve(state_id), ref_store.resolve(state_id)
        assert (got is None) == (want is None), state_id
        if got is not None:
            assert (got.root, got.slot, got.block_root) == (want.root, want.slot, want.block_root)
    assert store.resolve("finalized") is not None
    assert len(store) == len(ref_store) == upto + 1
    assert oracle.head_block_root(store.head.raw) == store.head.block_root


def test_registry_snapshot_and_gather_rows_equal_reference():
    commits, _ = chain()
    commit = commits[last_of("deneb")]
    state, ref_state = read("port", commit)[0], read("ref", commit)[0]
    bundle = ops_vector.columns_for(state).registry_snapshot()
    want = ref_ops_vector.columns_for(ref_state).registry_snapshot()
    assert set(bundle) == set(want)
    for name, column in bundle.items():
        assert not column.flags.writeable
        assert column.tolist() == want[name].tolist(), name
    rows = ops_vector.gather_rows(bundle, [3, 1, 3], ("balances",))
    assert rows["balances"].tolist() == [int(state.balances[i]) for i in (3, 1, 3)]
    assert rows["balances"].flags.writeable
    epoch = commit.slot // 8
    assert views.status_code_column(bundle, epoch).tolist() == \
        ref_views.status_code_column(want, epoch).tolist()


def test_status_machine_lockstep_equals_reference():
    import numpy as np

    from ethereum_consensus_tpu_torch.primitives import FAR_FUTURE_EPOCH as FAR

    epoch = 10
    rows = [
        ((FAR, FAR, FAR, FAR, False, 1), "pending_initialized"),
        ((5, 20, FAR, FAR, False, 1), "pending_queued"),
        ((0, 0, FAR, FAR, False, 1), "active_ongoing"),
        ((0, 0, 15, 20, False, 1), "active_exiting"),
        ((0, 0, 15, 20, True, 1), "active_slashed"),
        ((0, 0, 5, 20, False, 1), "exited_unslashed"),
        ((0, 0, 5, 20, True, 1), "exited_slashed"),
        ((0, 0, 5, 9, False, 1), "withdrawal_possible"),
        ((0, 0, 5, 9, True, 0), "withdrawal_done"),
    ]
    names = ("activation_eligibility_epoch", "activation_epoch", "exit_epoch",
             "withdrawable_epoch", "slashed", "balances")
    bundle = {name: np.array([r[0][i] for r in rows], np.bool_ if name == "slashed" else np.uint64)
              for i, name in enumerate(names)}
    codes = views.status_code_column(bundle, epoch)
    assert [views.STATUS_NAMES[c] for c in codes.tolist()] == [r[1] for r in rows]
    assert codes.tolist() == ref_views.status_code_column(bundle, epoch).tolist()

    class _V:
        def __init__(self, elig, act, exit_epoch, wd, slashed):
            self.activation_eligibility_epoch = elig
            self.activation_epoch = act
            self.exit_epoch = exit_epoch
            self.withdrawable_epoch = wd
            self.slashed = slashed

    for values, want in rows:
        assert oracle.validator_status(_V(*values[:5]), values[5], epoch) == want
        assert ref_oracle.validator_status(_V(*values[:5]), values[5], epoch) == want
    assert views.parse_statuses(["active", "exited_slashed"]) == {2, 3, 4, 6}
    with pytest.raises(ValueError):
        views.parse_statuses(["nonsense"])


def test_one_gather_per_batch():
    store = stores("port", last_of("altair"), start=last_of("altair"))
    plane = BeaconDataPlane(store)
    plane.handle("GET", f"{STATES}/head/validators", {"id": ["1"]}, None)  # build the bundle
    for path, params in (
        (f"{STATES}/head/validators", {"id": [",".join(str(i) for i in range(0, 60, 2))]}),
        (f"{STATES}/head/validator_balances", {"id": [",".join(str(i) for i in range(40))]}),
        (f"{STATES}/head/validators", {"status": ["active"]}),
        (f"{STATES}/head/validator_balances", {}),
    ):
        gathers = metrics.counter("serving.gathers").value()
        requests = metrics.counter("serving.requests").value()
        assert plane.handle("GET", path, params, None)[0] == 200
        assert metrics.counter("serving.gathers").value() - gathers == 1, (path, params)
        assert metrics.counter("serving.requests").value() - requests == 1


# ---------------------------------------------------------------------------
# the pipeline's state channel: isolation and rollbacks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def phase0_chain():
    """A 64-validator phase0 genesis and eight signed blocks, as the port's
    state and blocks, with the honest post-state roots."""
    ref_state, ref_ctx = torch_genesis.fresh_genesis(64, "minimal")
    blocks = chain_utils.produce_chain(ref_state, ref_ctx, 8)
    ctx = Context.for_minimal()
    ns = containers.build(ctx.preset)
    state = ns.BeaconState.deserialize(type(ref_state).serialize(ref_state))
    port_blocks = [ns.SignedBeaconBlock.deserialize(type(b).serialize(b)) for b in blocks]
    return state, ctx, port_blocks


@pytest.fixture
def attached():
    store = HeadStore().attach()
    yield store
    store.detach()
    metrics.gauge("pipeline.broken").set(0)


def test_snapshot_isolation_across_commit(phase0_chain, attached):
    state, ctx, blocks = phase0_chain
    store = attached
    pipe = ChainPipeline(Executor(state.copy(), ctx), policy=FlushPolicy(window_size=2,
                                                                         max_in_flight=2))
    for block in blocks[:4]:
        pipe.submit(block)
    while not pipe._sched.idle:
        pipe._settle_oldest()
    first = store.head
    assert first is not None and first.slot == 4
    assert first.root == bytes(blocks[3].message.state_root)
    assert first.bundle() is not None  # built before the later commits
    plane = BeaconDataPlane(store)
    path = f"{STATES}/0x{first.root.hex()}/validators"
    before = _answer(plane, ("GET", path, {}, None))
    for block in blocks[4:]:
        pipe.submit(block)
    pipe.close()
    assert store.head.slot == 8 and store.head.root != first.root
    assert _answer(plane, ("GET", path, {}, None)) == before
    assert json.loads(before[1])["data"] == oracle.validators_data(first.raw, ctx)
    bundle = first.bundle()
    assert not bundle["balances"].flags.writeable
    with pytest.raises(ValueError):
        bundle["balances"][0] = 1


def test_rollback_never_published(phase0_chain, attached):
    """A tampered proposer signature at block 4 of a window of four: the
    store's head is block 3's committed state, and no state the window
    rolled back reaches the store."""
    state, ctx, blocks = phase0_chain
    store = attached
    bad = blocks[4].copy()
    bad.signature = bytes(blocks[3].signature)
    pipe = ChainPipeline(Executor(state.copy(), ctx), policy=FlushPolicy(window_size=4))
    with pytest.raises(InvalidBlock):
        for block in blocks[:4] + [bad] + blocks[5:]:
            pipe.submit(block)
        pipe.close()
    honest = {bytes(b.message.state_root) for b in blocks}
    published = [snap.root for snap in store.snapshots()]
    assert published and set(published) <= honest
    assert store.head.root == bytes(blocks[3].message.state_root)
    assert store.head.block.message.slot == blocks[3].message.slot
    assert bytes(blocks[4].message.state_root) not in published


def test_dependent_root_is_a_block_root(phase0_chain, attached):
    state, ctx, blocks = phase0_chain
    store = attached
    Executor(state.copy(), ctx).stream(blocks, policy=FlushPolicy(window_size=3, max_in_flight=2))
    snap = store.head
    raw = snap.raw
    epoch = int(raw.slot) // 8
    block_roots = {type(b.message).hash_tree_root(b.message) for b in blocks}
    assert snap.block_root in block_roots
    assert store.resolve("0x" + snap.block_root.hex()) is snap
    for duty in ("attester", "proposer"):
        dep = oracle.dependent_root(raw, ctx, epoch, duty, head_root=snap.block_root)
        spe = 8
        dep_slot = (epoch if duty == "proposer" else epoch - 1) * spe - 1
        if 0 <= dep_slot < int(raw.slot):
            assert dep == helpers.get_block_root_at_slot(raw, dep_slot)
        else:
            assert dep == snap.block_root


def test_headstore_probe_in_the_memory_census():
    store = stores("port", 3)
    for snap in store.snapshots():
        snap.bundle()
    nbytes, entries = store.memory_census()
    assert entries == 4 and nbytes > 0
    row = memory.census()["serving.snapshots"]
    assert row["entries"] >= 4 and row["bytes"] >= nbytes
