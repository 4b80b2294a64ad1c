"""A window of signed blocks verified as one RLC batch, in both packages.

A three-block minimal-preset phase0 chain (two attestations per block) is
built with the reference package and applied through each package's
``Executor.apply_block_with_validation`` inside ``defer_flushes``, so that
the blocks' ten signature sets gather in one sink, as the reference's
chain pipeline gathers its window. The sets are then verified with one
``verify_signature_sets`` call on the device pairing route of each package:
``ops.install(device="cpu", pairing_min_sets=2)`` in the port (the kernels'
plain versions) and ``ops.install(pairing_min_sets=2)`` in the reference
(its device programs on JAX's CPU). Verdicts, the blame of a copy with one
aggregate's signature replaced by its neighbour's, and the route taken must
agree. A kernel that fails raises out of ``verify_signature_sets``: no host
route answers for it. The same window on the "mxu" multiplier runs in
tests/test_torch_window_mxu.py.
"""

import pytest

import chain_utils
from ethereum_consensus_tpu import executor as ref_executor
from ethereum_consensus_tpu import ops as ref_ops
from ethereum_consensus_tpu.crypto import bls as ref_bls
from ethereum_consensus_tpu.models import signature_batch as ref_batch
from ethereum_consensus_tpu.models.phase0 import containers as ref_containers
from ethereum_consensus_tpu_torch import executor as port_executor
from ethereum_consensus_tpu_torch import ops
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.crypto import bls as port_bls
from ethereum_consensus_tpu_torch.models import signature_batch as port_batch
from ethereum_consensus_tpu_torch.models.phase0 import containers as port_containers
from ethereum_consensus_tpu_torch.native import bls as port_native
from ethereum_consensus_tpu_torch.ops import pairing
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N_BLOCKS = 3
# block 3's first attestation: the proposer and randao sets of blocks 1-3
# and block 2's two attestations come first (block 1 has none to include)
TAMPERED = 2 + 4 + 2


@pytest.fixture(scope="module")
def chain():
    state, ctx = chain_utils.fresh_genesis(64, "minimal")
    blocks = chain_utils.produce_chain(state, ctx, N_BLOCKS, "phase0", atts_per_block=2)
    ns = ref_containers.build(ctx.preset)
    return (ns.BeaconState.serialize(state),
            [ns.SignedBeaconBlock.serialize(b) for b in blocks])


def _window(executor_mod, containers, batch_mod, ctx, chain):
    """The sets of the chain's blocks, gathered in one sink."""
    state_bytes, block_bytes = chain
    ns = containers.build(ctx.preset)
    executor = executor_mod.Executor(ns.BeaconState.deserialize(state_bytes), ctx)
    sink = batch_mod.SignatureBatch()
    with batch_mod.defer_flushes(sink):
        for data in block_bytes:
            executor.apply_block_with_validation(ns.SignedBeaconBlock.deserialize(data),
                                                 executor_mod.Validation.ENABLED)
    return list(sink.sets)


@pytest.fixture(scope="module")
def port_sets(chain):
    return _window(port_executor, port_containers, port_batch, Context.for_minimal(), chain)


@pytest.fixture(scope="module")
def ref_sets(chain):
    return _window(ref_executor, ref_containers, ref_batch,
                   chain_utils.Context.for_minimal(), chain)


def _tampered(bls, sets):
    out = list(sets)
    out[TAMPERED] = bls.SignatureSet(sets[TAMPERED].public_keys, sets[TAMPERED].message,
                                     sets[TAMPERED + 1].signature)
    return out


@pytest.fixture
def port_device_route():
    ops.install(device="cpu", pairing_min_sets=2)
    yield
    ops.uninstall()


@pytest.fixture
def ref_device_route():
    ref_ops.install(pairing_min_sets=2)
    yield
    ref_ops.uninstall()


def test_the_window_gathers_the_same_sets(port_sets, ref_sets):
    assert len(port_sets) == len(ref_sets) == 10
    for p, r in zip(port_sets, ref_sets):
        assert [k.to_bytes() for k in p.public_keys] == [k.to_bytes() for k in r.public_keys]
        assert (p.message, p.signature.to_bytes()) == (r.message, r.signature.to_bytes())
    assert len(port_sets[TAMPERED].public_keys) > 1  # an aggregate


def test_window_verdicts_and_blame_on_the_device_routes(port_sets, ref_sets,
                                                        port_device_route, ref_device_route):
    before = port_bls._ROUTE_DEVICE.value()
    assert port_bls.verify_signature_sets(port_sets) == [True] * len(port_sets)
    assert port_bls.last_batch_route() == "device"
    assert port_bls._ROUTE_DEVICE.value() == before + 1
    assert ref_bls.verify_signature_sets(ref_sets) == [True] * len(ref_sets)
    assert ref_bls.last_batch_route() == "device"

    # the batch fails on the device route, then the blame verifies set by set
    port_blame = port_bls.verify_signature_sets(_tampered(port_bls, port_sets))
    assert port_bls.last_batch_route() == "device"
    ref_blame = ref_bls.verify_signature_sets(_tampered(ref_bls, ref_sets))
    assert ref_bls.last_batch_route() == "device"
    assert port_blame == ref_blame
    assert [i for i, ok in enumerate(port_blame) if not ok] == [TAMPERED]
    # a single set verifies without the RLC batch
    assert port_bls.verify_signature_sets(port_sets[:1]) == [True]
    assert port_bls.last_batch_route() is None


def test_below_the_threshold_the_host_route_verifies(port_sets):
    ops.install(device="cpu", pairing_min_sets=len(port_sets) + 1)
    try:
        before = port_bls._ROUTE_HOST.value()
        assert port_bls.verify_signature_sets(port_sets) == [True] * len(port_sets)
        assert port_bls.last_batch_route() == "host"
        assert port_bls._ROUTE_HOST.value() == before + 1
    finally:
        ops.uninstall()


@pytest.mark.parametrize("kernel", ["g1_mul_affine", "g2_mul_sum"])
def test_a_failing_kernel_raises(port_sets, port_device_route, monkeypatch, kernel):
    """Whichever way the dispatcher goes (the plain version for CPU
    tensors, the launcher for CUDA ones), a failure propagates, and the
    host multi-pairing is never asked."""
    def failed(*args):
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error 719")

    def host_route(*args):
        raise AssertionError("the host multi-pairing answered for the device")

    monkeypatch.setattr(pairing, f"{kernel}_plain", failed)
    monkeypatch.setattr(pairing, f"{kernel}_cuda", failed)
    monkeypatch.setattr(port_native, "batch_verify_raw", host_route)
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        port_bls.verify_signature_sets(port_sets)

