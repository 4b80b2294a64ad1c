"""The port's proof plane (proofs/, parallel/runtime.py ``proof_gather``)
against the reference on the same bytes.

The states are the reference's five-boundary upgrade chain
(``tests/torch_read_plane.py``), phase0 through electra, read from SSZ
inside each test under the geometry the ``geometry`` fixture sets on both
packages' ``ssz/core.py``: the default one (a 64-validator registry is
below the dirty-tracking threshold, so its layers are served cold) and a
shrunk one (groups of 4 chunks, so every list carries stored levels and a
multiproof plans many groups). Single branches, multiproofs on the lazy
host route and on the columnar ``ECT_MESH`` route, the light-client
documents, and the gate's journal are held equal to the reference's.

The first test is the regression test for an order fault of the test
suite: ``tests/test_proofs.py`` settles a copy of ``chain_utils``'s cached
genesis under its shrunk geometry, and the levels it leaves in the cache
broke the chains of ``tests/test_torch_telemetry.py`` built after it in the
same process (see ``tests/torch_genesis.py``).
"""

import contextlib
import random
import subprocess
import sys
from pathlib import Path

import pytest

from ethereum_consensus_tpu import proofs as ref_proofs
from ethereum_consensus_tpu.parallel import runtime as ref_runtime
from ethereum_consensus_tpu.proofs import light_client as ref_lc
from ethereum_consensus_tpu.ssz import List as RefList
from ethereum_consensus_tpu.ssz import uint64 as ref_uint64
from ethereum_consensus_tpu.ssz import core as ref_core
from ethereum_consensus_tpu.telemetry import device as ref_device
from ethereum_consensus_tpu_torch import _device_flags, ops, proofs
from ethereum_consensus_tpu_torch.parallel import runtime
from ethereum_consensus_tpu_torch.proofs import light_client as lc
from ethereum_consensus_tpu_torch.proofs import multiproof
from ethereum_consensus_tpu_torch.ssz import List, core, uint64
from ethereum_consensus_tpu_torch.ssz import hash as port_hash
from ethereum_consensus_tpu_torch.ssz.merkle import is_valid_merkle_branch_for_generalized_index
from ethereum_consensus_tpu_torch.telemetry import device, metrics
from torch_read_plane import FORKS, chain, last_of, read, stores
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]

# (group shift, dirty-tracking threshold in chunks, bulk-roots threshold)
GEOMETRIES = {"default": None, "small": (2, 1 << 2, 4)}
MESH_ENV = ("ECT_MESH", "ECT_MESH_PROOF_MIN_CHUNKS")


def test_order_fault_regression():
    """``tests/test_proofs.py``'s shrunk-geometry walk, then the port's
    telemetry tests in the same process: every test passes."""
    done = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "tests/test_proofs.py::test_walker_differential_container_registry",
         "tests/test_torch_telemetry.py"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stdout[-4000:]


@contextlib.contextmanager
def _geometry(name: str):
    """Both packages' dirty-group geometry for the block; states read inside
    it take it, and nothing that outlives it was settled under it."""
    modules = (core, ref_core)
    saved = [(m._DIRTY_GROUP_SHIFT, m._DIRTY_TRACK_MIN_CHUNKS, m._BULK_ROOTS_MIN) for m in modules]
    shrunk = GEOMETRIES[name]
    if shrunk is not None:
        for m in modules:
            m._DIRTY_GROUP_SHIFT, m._DIRTY_TRACK_MIN_CHUNKS, m._BULK_ROOTS_MIN = shrunk
    try:
        yield name
    finally:
        for m, values in zip(modules, saved):
            m._DIRTY_GROUP_SHIFT, m._DIRTY_TRACK_MIN_CHUNKS, m._BULK_ROOTS_MIN = values


@pytest.fixture(params=sorted(GEOMETRIES))
def geometry(request):
    with _geometry(request.param) as name:
        yield name


@pytest.fixture
def mesh_env(monkeypatch):
    """Both runtimes reset around a test that sets ECT_MESH*, the routed
    device the host."""
    runtime.reset()
    ref_runtime.reset()
    monkeypatch.setattr(_device_flags, "DEVICE", "cpu")
    yield monkeypatch
    for key in MESH_ENV:
        monkeypatch.delenv(key, raising=False)
    runtime.reset()
    ref_runtime.reset()
    ops.uninstall()


def _paths(fork: str) -> list:
    paths = [("slot",), ("validators", 0, "effective_balance"), ("validators", 63, "public_key"),
             ("validators", 17), ("balances", 17), ("balances", 63),
             ("finalized_checkpoint", "root"), ("latest_block_header", "state_root"),
             ("randao_mixes", 5), ("block_roots", 3), ("eth1_data", "deposit_root")]
    if fork != "phase0":
        paths += [("current_sync_committee",), ("next_sync_committee",), ("inactivity_scores", 9),
                  ("previous_epoch_participation", 40)]
    if fork in ("capella", "deneb", "electra"):
        paths += [("latest_execution_payload_header", "block_hash"),
                  ("next_withdrawal_validator_index",)]
    return paths


def _head(fork: str) -> tuple:
    commits, _ = chain()
    commit = commits[last_of(fork)]
    return commit, read("port", commit)[0], read("ref", commit)[0]


def _validator_gindices(state_type, indices) -> list:
    return sorted(core.get_generalized_index(state_type, "validators", i) for i in indices)


# ---------------------------------------------------------------------------
# single branches and multiproofs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fork", FORKS)
def test_single_branches_equal_reference(fork, geometry):
    commit, state, ref_state = _head(fork)
    pc = proofs.ProofContext(type(state), state)
    rc = ref_proofs.ProofContext(type(ref_state), ref_state)
    assert pc.root == rc.root == commit.root
    for path in _paths(fork):
        g = core.get_generalized_index(type(state), *path)
        assert g == ref_core.get_generalized_index(type(ref_state), *path), path
        branch = pc.proof(g)
        assert branch == rc.proof(g), path
        assert pc.node_at(g) == rc.node_at(g), path
        assert branch == core.prove(type(state), state, g), path
        assert is_valid_merkle_branch_for_generalized_index(pc.node_at(g), branch, g, pc.root)
    assert pc.declines == rc.declines
    assert pc.warm() == rc.warm()


@pytest.mark.parametrize("fork", FORKS)
def test_multiproof_equal_reference(fork, geometry):
    commit, state, ref_state = _head(fork)
    gindices = sorted(set(_validator_gindices(type(state), range(0, 64, 5))) | {
        core.get_generalized_index(type(state), *path) for path in _paths(fork)})
    mp = proofs.extract_multiproof(type(state), state, gindices)
    want = ref_proofs.extract_multiproof(type(ref_state), ref_state, gindices)
    assert (mp.gindices, mp.leaves, mp.proof) == (want.gindices, want.leaves, want.proof)
    assert mp.verify(commit.root)
    assert proofs.verify_multiproof(mp.leaves, mp.proof, mp.gindices, commit.root)
    assert proofs.get_helper_indices(gindices) == ref_proofs.get_helper_indices(gindices)
    bad = list(mp.proof)
    bad[0] = b"\xff" * 32
    assert not proofs.verify_multiproof(mp.leaves, bad, mp.gindices, commit.root)
    with pytest.raises(ValueError):
        proofs.extract_multiproof(type(state), state, [gindices[0], gindices[0]])


def test_helper_indices_and_multi_root_equal_reference():
    rng = random.Random(0x23)
    LT = List[uint64, 1 << 12]
    values = [rng.randrange(1 << 64) for _ in range(300)]
    root = LT.hash_tree_root(values)
    for _ in range(8):
        picks = sorted({int(core.get_generalized_index(LT, i))
                        for i in rng.sample(range(300), rng.randrange(1, 12))})
        assert proofs.get_helper_indices(picks) == ref_proofs.get_helper_indices(picks)
        leaves = [core.compute_subtree_root(LT, values, g) for g in picks]
        helpers = [core.compute_subtree_root(LT, values, h)
                   for h in proofs.get_helper_indices(picks)]
        assert proofs.calculate_multi_merkle_root(leaves, helpers, picks) == root
        assert ref_proofs.calculate_multi_merkle_root(leaves, helpers, picks) == root
    assert proofs.get_helper_indices([8, 9]) == [5, 3]
    assert proofs.get_helper_indices([9]) == [8, 5, 3]


def test_cold_declines_counted_as_the_reference():
    """An untracked list served cold: the same decline counter and branch."""
    LT = List[uint64, 1 << 12]
    plain = list(range(40))
    g = int(core.get_generalized_index(LT, 5))
    before = metrics.counter("proofs.fallback.untracked_list").value()
    with _geometry("small"):
        got = proofs.extract_proof(LT, plain, g)
        want = ref_proofs.extract_proof(RefList[ref_uint64, 1 << 12], plain, g)
    assert got == want == core.prove(LT, plain, g)
    assert metrics.counter("proofs.fallback.untracked_list").value() == before + 1


# ---------------------------------------------------------------------------
# the columnar route behind proof_gather
# ---------------------------------------------------------------------------


def _counting_hasher(monkeypatch, levels: list) -> None:
    """Every level of at least 16 parents goes to the installed device
    hasher (here SHA-256's plain version); its parent counts land in
    ``levels``."""
    inner = port_hash._device_hasher
    assert inner is not None

    def hasher(nodes: bytes) -> bytes:
        levels.append(len(nodes) // 64)
        return inner(nodes)
    monkeypatch.setattr(port_hash, "_device_hasher", hasher)
    monkeypatch.setattr(port_hash, "DEVICE_MIN_NODES", 16)


@pytest.mark.parametrize("fork", ["phase0", "electra"])
def test_columnar_route_gives_the_host_routes_bytes(fork, mesh_env):
    """Under ECT_MESH=1 the multiproof's planned groups rebuild in one set
    of level passes on the device hasher: the same gindices, leaves and
    helpers as the lazy host route and as the reference's columnar route."""
    with _geometry("small"):
        commit, state, ref_state = _head(fork)
        gindices = _validator_gindices(type(state), range(1, 64, 4))
        host = proofs.extract_multiproof(type(state), state, gindices)
        mesh_env.setenv("ECT_MESH", "1")
        mesh_env.setenv("ECT_MESH_PROOF_MIN_CHUNKS", "1")
        ops.install(device="cpu")
        levels: list = []
        _counting_hasher(mesh_env, levels)
        built: list = []
        inner = multiproof._columnar_group_build

        def columnar_group_build(pending):
            at = len(levels)
            inner(pending)
            built.append(levels[at:])
        mesh_env.setattr(multiproof, "_columnar_group_build", columnar_group_build)
        engaged = metrics.counter("mesh.engage.proofs").value()
        state = read("port", commit)[0]
        columnar = proofs.extract_multiproof(type(state), state, gindices)
        ref_state = read("ref", commit)[0]
        want = ref_proofs.extract_multiproof(type(ref_state), ref_state, gindices)
    assert metrics.counter("mesh.engage.proofs").value() == engaged + 1
    # 16 groups of 4 chunks: the two levels of one columnar rebuild
    assert built == [[32, 16]]
    got = (columnar.gindices, columnar.leaves, columnar.proof)
    assert got == (host.gindices, host.leaves, host.proof)
    assert got == (want.gindices, want.leaves, want.proof)
    assert columnar.verify(commit.root)


def _journal(routes) -> list:
    return [(r["kind"], r["choice"], r["reason"], r["inputs"]) for r in routes]


@pytest.mark.parametrize("threshold", ["1", str(1 << 20)])
def test_proof_gather_journal_equals_reference(threshold, mesh_env):
    """Engaged and below_threshold: the same decision and the same
    ``mesh.proofs`` journal entry as the reference (both runtimes
    provisioned before the observatories start)."""
    mesh_env.setenv("ECT_MESH", "1")
    mesh_env.setenv("ECT_MESH_PROOF_MIN_CHUNKS", threshold)
    assert runtime.mesh() is not None and ref_runtime.mesh() is not None
    with device.observing() as obs, ref_device.observing() as ref_obs:
        got = runtime.proof_gather(4096)
        want = ref_runtime.proof_gather(4096)
    assert (got is None) == (want is None) == (threshold != "1")
    journal = _journal(obs.routes())
    assert journal == _journal(ref_obs.routes())
    assert journal[0][:3] == (("mesh.proofs", "device", "engaged") if threshold == "1"
                              else ("mesh.proofs", "host", "below_threshold"))


def test_proof_gather_raises_where_the_reference_declines(mesh_env):
    """A mesh that cannot be built: the reference journals a decline and
    builds on the host; the port raises from ``extract_multiproof`` (the
    divergence ROADMAP lists). An unparsable threshold raises too."""
    with _geometry("small"):
        commit, state, ref_state = _head("altair")
        gindices = _validator_gindices(type(state), (3, 40))
        mesh_env.setenv("ECT_MESH", "2")
        with ref_device.observing() as ref_obs:
            want = ref_proofs.extract_multiproof(type(ref_state), ref_state, gindices)
        with pytest.raises(RuntimeError, match="2 devices"):
            proofs.extract_multiproof(type(state), state, gindices)
        runtime.reset()
        mesh_env.setenv("ECT_MESH", "1")
        mesh_env.setenv("ECT_MESH_PROOF_MIN_CHUNKS", "many")
        with pytest.raises(ValueError, match="ECT_MESH_PROOF_MIN_CHUNKS"):
            proofs.extract_multiproof(type(state), state, gindices)
    assert want.verify(commit.root)
    assert [e[:3] for e in _journal(ref_obs.routes()) if e[0] == "mesh.proofs"] == [
        ("mesh.proofs", "host", "devices_unavailable")]


# ---------------------------------------------------------------------------
# light-client documents
# ---------------------------------------------------------------------------


def _outcome(fn, *args):
    """("ok", fork, SSZ bytes) or ("raised", exception type name, message);
    for a list of (document, fork) pairs, ("ok", [(fork, SSZ bytes), ...]).
    A phase0 block has no sync aggregate: both packages raise
    AttributeError for its update (the handler's 500)."""
    try:
        doc, fork = fn(*args)
    except Exception as exc:  # noqa: BLE001 — both packages' refusals compared
        return "raised", type(exc).__name__, str(exc)
    if isinstance(doc, list):
        return "ok", [(f, type(d).serialize(d)) for d, f in doc]
    return "ok", fork, type(doc).serialize(doc)


@pytest.mark.parametrize("fork", FORKS)
def test_light_client_documents_equal_reference(fork):
    """Bootstrap, update, finality and optimistic updates off the fork's
    last commit, with every earlier commit retained: the same SSZ bytes and
    fork, or the same refusal (phase0: 400)."""
    upto = last_of(fork)
    store, ref_store = stores("port", upto), stores("ref", upto)
    head, ref_head = store.head, ref_store.head
    got = _outcome(lc.light_client_bootstrap, head)
    assert got == _outcome(ref_lc.light_client_bootstrap, ref_head)
    assert got[0] == ("raised" if fork == "phase0" else "ok")
    for name in ("light_client_update", "light_client_finality_update",
                 "light_client_optimistic_update"):
        got = _outcome(getattr(lc, name), store, head)
        assert got == _outcome(getattr(ref_lc, name), ref_store, ref_head), name
        assert got[0] == ("raised" if fork == "phase0" else "ok"), (name, got)
    got = _outcome(lambda: (lc.light_client_updates(store, 0, 8), "-"))
    assert got == _outcome(lambda: (ref_lc.light_client_updates(ref_store, 0, 8), "-"))
    assert lc.sync_committee_period(head) == ref_lc.sync_committee_period(ref_head)
    assert lc.fork_of(head) == ref_lc.fork_of(ref_head) == fork
