"""The port's mesh runtime (``parallel/runtime.py``) and its three seams.

The ``ECT_MESH`` switch: off imports nothing of ``parallel``; a bad value,
or more devices than there are, raises; ``auto`` on one device,
``below_threshold`` and ``phase0_family`` are counted declines; the merkle
hook is installed at the first consult and cleared by ``reset``; an
injected fault raises. Then the seams on a CPU mesh (the kernels' plain
versions, ``ops.install(device="cpu")``; the host's device count made 4 or 2
with a monkeypatch, the counterpart of the reference's forced host-device
count): an altair boundary crossing with the thresholds at 1 gives the
reference's post-state bytes and root through the sharded fused route and,
when that declines, the sharded staged stages; and a batch of signature
sets takes the sharded RLC route with the host route's verdicts and blame.
Every test resets both packages' runtimes: provisioning is once per
process.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chain_utils
from ethereum_consensus_tpu.models.altair import slot_processing as ref_slots
from ethereum_consensus_tpu.parallel import runtime as ref_runtime
from ethereum_consensus_tpu_torch import _device_flags, ops
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.crypto import bls
from ethereum_consensus_tpu_torch.models import altair as port_altair
from ethereum_consensus_tpu_torch.models import epoch_vector
from ethereum_consensus_tpu_torch.models.altair import slot_processing as port_slots
from ethereum_consensus_tpu_torch.parallel import epoch as mesh_epoch
from ethereum_consensus_tpu_torch.parallel import mesh as mesh_mod
from ethereum_consensus_tpu_torch.parallel import pairing as mesh_pairing
from ethereum_consensus_tpu_torch.parallel import runtime, virtual_mesh
from ethereum_consensus_tpu_torch.ssz import merkle as ssz_merkle
from ethereum_consensus_tpu_torch.telemetry import metrics
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def mesh_env(monkeypatch):
    """Both runtimes reset around a test that sets ECT_MESH*, the routed
    device the host; the suite leaves with the mesh off."""
    runtime.reset()
    ref_runtime.reset()
    monkeypatch.setattr(_device_flags, "DEVICE", "cpu")
    yield monkeypatch
    for key in ("ECT_MESH", "ECT_MESH_EPOCH_MIN_N", "ECT_MESH_MERKLE_MIN_CHUNKS"):
        monkeypatch.delenv(key, raising=False)
    runtime.reset()
    ref_runtime.reset()
    ops.uninstall()


def _count(name: str) -> int:
    return metrics.counter(name).value()


def _devices(monkeypatch, n: int) -> None:
    """The host reports ``n`` devices: chip_mesh(n) is n shards of it."""
    monkeypatch.setattr(mesh_mod, "device_count", lambda device_type=None: n)


# ---------------------------------------------------------------------------
# the switch
# ---------------------------------------------------------------------------


def test_off_imports_nothing_of_parallel(tmp_path):
    """An altair epoch pass with ECT_MESH unset, in a fresh process: the
    engine runs and the parallel package is never imported."""
    state, ctx = chain_utils.fresh_genesis_altair(64, "minimal")
    ref_slots.process_slots(state, 15, ctx)
    pre = tmp_path / "pre.ssz"
    pre.write_bytes(type(state).serialize(state))
    code = f"""
import os, sys
os.environ.pop("ECT_MESH", None)
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.models import altair, epoch_vector
from ethereum_consensus_tpu_torch.models.altair import slot_processing
from ethereum_consensus_tpu_torch.telemetry import metrics
epoch_vector.EPOCH_VECTOR_MIN_VALIDATORS = 0
ctx = Context.for_minimal()
state = altair.build(ctx.preset).BeaconState.deserialize(open({str(pre)!r}, "rb").read())
slot_processing.process_slots(state, 16, ctx)
assert metrics.counter("epoch_vector.epochs").value() == 1
bad = [m for m in sys.modules if m.startswith("ethereum_consensus_tpu_torch.parallel")]
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_off_and_zero_are_not_requested(mesh_env):
    for value in (None, "off", "0", "none", "host"):
        if value is None:
            mesh_env.delenv("ECT_MESH", raising=False)
        else:
            mesh_env.setenv("ECT_MESH", value)
        assert not runtime.requested()
        assert runtime.mesh() is None and runtime.epoch_sweeps(1 << 20) is None
        assert runtime.pairing_mesh(528) is None
    assert runtime.status() == {"requested": False, "env": "host", "devices": 0}


@pytest.mark.parametrize("value", ["bogus", "-1", "1.5"])
def test_bad_value_raises(mesh_env, value):
    mesh_env.setenv("ECT_MESH", value)
    with pytest.raises(ValueError, match="ECT_MESH"):
        runtime.mesh()
    with pytest.raises(ValueError):
        runtime.epoch_sweeps(1 << 20)
    assert ssz_merkle._MESH_MERKLEIZER is None


def test_more_devices_than_present_raises(mesh_env):
    mesh_env.setenv("ECT_MESH", "2")  # the host is one device
    with pytest.raises(RuntimeError, match="2 devices, 1 available"):
        runtime.pairing_mesh(528)
    runtime.reset()
    mesh_env.setattr(_device_flags, "DEVICE", "cuda")
    mesh_env.setattr(mesh_mod.torch.cuda, "device_count", lambda: 0)
    mesh_env.setenv("ECT_MESH", "1")  # no card
    with pytest.raises(RuntimeError, match="1 devices, 0 available"):
        runtime.mesh()


def test_auto_on_one_device_is_a_counted_decline(mesh_env):
    mesh_env.setenv("ECT_MESH", "auto")
    before = _count("mesh.decline.single_device")
    assert runtime.mesh() is None
    assert runtime.epoch_sweeps(1 << 20) is None
    assert runtime.status() == {"requested": True, "env": "auto", "devices": 0,
                                "reason": "single_device"}
    # the runtime's decline, then the epoch route's
    assert _count("mesh.decline.single_device") == before + 2


def test_thresholds_and_family_are_counted_declines(mesh_env):
    mesh_env.setenv("ECT_MESH", "1")
    assert runtime.device_count() == 1
    before = _count("mesh.decline.below_threshold")
    assert runtime.epoch_sweeps(runtime.DEFAULT_EPOCH_MIN_N - 1) is None
    assert _count("mesh.decline.below_threshold") == before + 1
    before = _count("mesh.decline.phase0_family")
    assert runtime.epoch_sweeps(1 << 20, family="phase0") is None
    assert _count("mesh.decline.phase0_family") == before + 1
    mesh_env.setenv("ECT_MESH_EPOCH_MIN_N", "1")
    engaged = _count("mesh.engage")
    runner = runtime.epoch_sweeps(1000)
    assert isinstance(runner, mesh_epoch.MeshEpochSweeps) and runner.n_dev == 1
    assert _count("mesh.engage") == engaged + 1
    mesh_env.setenv("ECT_MESH_EPOCH_MIN_N", "many")
    with pytest.raises(ValueError, match="ECT_MESH_EPOCH_MIN_N"):
        runtime.epoch_sweeps(1000)


def test_merkle_hook_installed_at_first_consult_and_cleared_by_reset(mesh_env):
    mesh_env.setenv("ECT_MESH", "4")
    mesh_env.setenv("ECT_MESH_MERKLE_MIN_CHUNKS", "64")
    _devices(mesh_env, 4)
    assert ssz_merkle._MESH_MERKLEIZER is None  # not at import, not at the env write
    assert runtime.status()["devices"] == 4
    assert ssz_merkle._MESH_MERKLEIZER is not None
    chunks = np.random.default_rng(5).bytes(32 * 100)
    engaged = _count("mesh.engage")
    routed = ssz_merkle.merkleize_chunks(chunks, limit=2**10)
    assert _count("mesh.engage") == engaged + 1
    # a tree narrower than the mesh: the mesh_shape decline, the host root
    shape = _count("mesh.decline.mesh_shape")
    small = np.random.default_rng(6).bytes(32 * 64)
    runtime._install_merkle_hook(virtual_mesh(128, "cpu"))
    assert ssz_merkle.merkleize_chunks(small) is not None
    assert _count("mesh.decline.mesh_shape") == shape + 1
    runtime.reset()
    assert ssz_merkle._MESH_MERKLEIZER is None
    assert routed == ssz_merkle.merkleize_chunks(chunks, limit=2**10)


def test_injected_fault_raises(mesh_env):
    mesh_env.setenv("ECT_MESH", "1")
    runtime.install_fault_hook(lambda kind: kind in ("epoch", "pairing"))
    before = _count("mesh.decline.injected_fault")
    n = 8
    cols = (np.zeros(n, np.uint64), np.zeros(n, np.uint64), np.zeros(n, np.uint8),
            np.zeros(n, bool), np.zeros(n, bool), np.zeros(n, bool), np.zeros(n, np.uint64))
    runner = mesh_epoch.MeshEpochSweeps(virtual_mesh(1, "cpu"))
    with pytest.raises(runtime.MeshFaultInjected):
        runner.fused(*cols, increment=1, brpi=1, active_increments=1, denominator=1, bias=4,
                     recovery_rate=16, weights=(14, 26, 14), weight_denominator=64,
                     leaking=False, head_flag_index=2, target_flag_index=1)
    with pytest.raises(runtime.MeshFaultInjected):
        mesh_pairing.miller_partials_sharded(virtual_mesh(1, "cpu"), [b""], [b""], [b""], [1])
    assert _count("mesh.decline.injected_fault") == before + 2
    runtime.reset()
    assert runtime._FAULT_HOOK is None


# ---------------------------------------------------------------------------
# the epoch seam: an altair boundary on a 4-shard mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def altair_boundary():
    """An altair state at slot 15 with seeded participation and scores, and
    the reference's post-boundary (bytes, root) at slot 16."""
    state, ctx = chain_utils.fresh_genesis_altair(64, "minimal")
    ref_slots.process_slots(state, 15, ctx)
    rng = np.random.default_rng(3)
    n = len(state.validators)
    state.previous_epoch_participation = [int(v) for v in rng.integers(0, 8, n)]
    state.current_epoch_participation = [int(v) for v in rng.integers(0, 8, n)]
    state.inactivity_scores = [int(v) for v in rng.integers(0, 40, n)]
    chain_utils._strip_spec_caches(state)
    typ = type(state)
    pre = typ.serialize(state)
    ref_slots.process_slots(state, 16, ctx)
    return pre, typ.serialize(state), typ.hash_tree_root(state)


@pytest.mark.parametrize("fused_declines", [False, True], ids=["fused", "staged"])
def test_altair_boundary_on_a_4_shard_mesh_matches_reference(mesh_env, altair_boundary,
                                                             fused_declines):
    pre, post, root = altair_boundary
    mesh_env.setattr(epoch_vector, "EPOCH_VECTOR_MIN_VALIDATORS", 0)
    mesh_env.setenv("ECT_MESH", "4")
    mesh_env.setenv("ECT_MESH_EPOCH_MIN_N", "1")
    mesh_env.setenv("ECT_MESH_MERKLE_MIN_CHUNKS", "64")
    _devices(mesh_env, 4)
    calls = {"fused": 0, "inactivity_scores": 0, "rewards": 0}
    for name in calls:
        original = getattr(mesh_epoch.MeshEpochSweeps, name)

        def counting(self, *args, _name=name, _original=original, **kwargs):
            calls[_name] += 1
            if _name == "fused" and fused_declines:
                return None  # the wrap census: the staged stages take over
            return _original(self, *args, **kwargs)

        mesh_env.setattr(mesh_epoch.MeshEpochSweeps, name, counting)
    ctx = Context.for_minimal()
    state = port_altair.build(ctx.preset).BeaconState.deserialize(pre)
    engaged, fused_mesh = _count("mesh.engage"), _count("epoch_vector.fused.mesh")
    wrap = _count("mesh.decline.wrap_guard")
    port_slots.process_slots(state, 16, ctx)
    typ = type(state)
    assert typ.serialize(state) == post
    assert typ.hash_tree_root(state) == root
    if fused_declines:
        assert calls == {"fused": 1, "inactivity_scores": 1, "rewards": 1}
        assert _count("mesh.decline.wrap_guard") == wrap + 1
    else:
        assert calls == {"fused": 1, "inactivity_scores": 0, "rewards": 0}
        assert _count("epoch_vector.fused.mesh") == fused_mesh + 1
    # the epoch route and, after the consult, the merkle hook's roots
    assert _count("mesh.engage") >= engaged + 2


# ---------------------------------------------------------------------------
# the pairing seam: a batch of sets on the sharded route
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def signature_sets():
    sets = []
    for i in range(3):
        sk = bls.SecretKey(i + 201)
        msg = bytes([i]) * 32
        sets.append(bls.SignatureSet([sk.public_key()], msg, sk.sign(msg)))
    tampered = list(sets)
    tampered[1] = bls.SignatureSet(sets[1].public_keys, sets[1].message, sets[2].signature)
    return sets, tampered


def _sharded_calls(monkeypatch) -> list:
    seen = []
    original = mesh_pairing.batch_verify_sharded

    def counting(*args, mesh=None, **kwargs):
        seen.append(mesh.n_dev)
        return original(*args, mesh=mesh, **kwargs)

    monkeypatch.setattr(mesh_pairing, "batch_verify_sharded", counting)
    return seen


def test_sets_on_the_ect_mesh_route_match_the_host_route(mesh_env, signature_sets):
    sets, tampered = signature_sets
    host = (bls.verify_signature_sets(sets), bls.verify_signature_sets(tampered))
    assert host == ([True] * 3, [True, False, True])
    mesh_env.setenv("ECT_MESH", "2")
    _devices(mesh_env, 2)
    seen = _sharded_calls(mesh_env)
    ops.install(device="cpu", pairing_min_sets=2)
    engaged = _count("mesh.engage")
    assert bls.verify_signature_sets(sets) == host[0]
    assert bls.last_batch_route() == "device"
    assert bls.verify_signature_sets(tampered) == host[1]
    assert seen == [2, 2]
    assert _count("mesh.engage") == engaged + 2


def test_several_devices_shard_without_ect_mesh(mesh_env, signature_sets):
    """The reference's second branch: no ECT_MESH, but the routed type has
    several devices, so the batch shards over them all."""
    sets, _ = signature_sets
    mesh_env.delenv("ECT_MESH", raising=False)
    _devices(mesh_env, 2)
    seen = _sharded_calls(mesh_env)
    ops.install(device="cpu", pairing_min_sets=2)
    assert bls.verify_signature_sets(sets) == [True] * 3
    assert seen == [2]
