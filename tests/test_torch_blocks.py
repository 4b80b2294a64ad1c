"""The slice end to end: phase0 blocks through both packages' Executor.

A six-block minimal-preset chain (inside the first epoch, two attestations
per block) is built with the reference package. Its SSZ bytes go through
the reference ``Executor`` and the port's ``Executor`` block by block;
post-state bytes and roots must be identical after every block. The port
runs twice: on the host path, and with ``ops.install(device="cpu")`` at
thresholds of 1 so that every shuffle and every pubkey aggregation goes
through the kernels' plain versions. Tampered blocks raise the same error
class in both packages.
"""

import pytest

import chain_utils
import torch_genesis
from ethereum_consensus_tpu import executor as ref_executor
from ethereum_consensus_tpu.models.phase0 import containers as ref_containers
from ethereum_consensus_tpu_torch import executor as port_executor
from ethereum_consensus_tpu_torch import ops
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.models.phase0 import containers as port_containers
from ethereum_consensus_tpu_torch.ops import g1, shuffle
from ethereum_consensus_tpu_torch.ssz import hash as port_hash
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N_BLOCKS = 6


@pytest.fixture(scope="module")
def chain():
    state, ctx = torch_genesis.fresh_genesis(64, "minimal")
    blocks = chain_utils.produce_chain(state, ctx, N_BLOCKS, "phase0", atts_per_block=2)
    ns = ref_containers.build(ctx.preset)
    return (
        ns.BeaconState.serialize(state),
        [ns.SignedBeaconBlock.serialize(b) for b in blocks],
    )


def _ref_states(state_bytes, block_bytes):
    """(bytes, root) after each block, through the reference Executor."""
    ns = ref_containers.build(chain_utils.Context.for_minimal().preset)
    ex = ref_executor.Executor(
        ns.BeaconState.deserialize(state_bytes), chain_utils.Context.for_minimal()
    )
    out = []
    for data in block_bytes:
        ex.apply_block(ns.SignedBeaconBlock.deserialize(data))
        out.append((ex.state.serialize(), ex.state.hash_tree_root()))
    return out


def _port_states(state_bytes, block_bytes):
    ctx = Context.for_minimal()
    ns = port_containers.build(ctx.preset)
    ex = port_executor.Executor(ns.BeaconState.deserialize(state_bytes), ctx)
    out = []
    for data in block_bytes:
        ex.apply_block(ns.SignedBeaconBlock.deserialize(data))
        out.append((ex.state.serialize(), ex.state.hash_tree_root()))
    return out


@pytest.fixture
def host_path():
    ops.uninstall()
    yield
    ops.uninstall()


@pytest.fixture
def device_routed(monkeypatch):
    monkeypatch.setattr(port_hash, "DEVICE_MIN_NODES", 256)
    monkeypatch.setattr(port_hash, "_device_hasher", None)
    ops.install(device="cpu", shuffle_min_n=1, bls_agg_min_n=1)
    yield
    ops.uninstall()


def test_blocks_match_reference_on_host_path(chain, host_path):
    state_bytes, block_bytes = chain
    assert _port_states(state_bytes, block_bytes) == _ref_states(state_bytes, block_bytes)


def test_blocks_match_reference_through_device_routes(chain, device_routed, monkeypatch):
    state_bytes, block_bytes = chain
    routed = {"shuffle": 0, "g1": 0}
    plain_shuffle, plain_g1 = shuffle.shuffle_plain, g1.g1_sum_sets_plain

    def counting_shuffle(*args):
        routed["shuffle"] += 1
        return plain_shuffle(*args)

    def counting_g1(*args):
        routed["g1"] += 1
        return plain_g1(*args)

    monkeypatch.setattr(shuffle, "shuffle_plain", counting_shuffle)
    monkeypatch.setattr(g1, "g1_sum_sets_plain", counting_g1)
    assert _port_states(state_bytes, block_bytes) == _ref_states(state_bytes, block_bytes)
    assert routed["shuffle"] > 0, "no shuffle went through the kernel's route"
    assert routed["g1"] > 0, "no aggregation went through the kernel's route"


def _tampered(state_bytes, block_bytes, how):
    """The last block of the chain, tampered and re-signed by its proposer:
    ``swap`` exchanges its two attestations' signatures, ``root`` corrupts
    its state root."""
    ctx = chain_utils.Context.for_minimal()
    ns = ref_containers.build(ctx.preset)
    block = ns.SignedBeaconBlock.deserialize(block_bytes[-1])
    atts = block.message.body.attestations
    if how == "swap":
        atts[0].signature, atts[1].signature = atts[1].signature, atts[0].signature
    else:
        block.message.state_root = b"\x13" * 32
    genesis = ns.BeaconState.deserialize(state_bytes)
    block.signature = chain_utils.sign_block(genesis, block.message, ctx)
    return ns.SignedBeaconBlock.serialize(block)


def _error_class(apply, state_bytes, block_bytes, bad):
    ex = apply(state_bytes, block_bytes[:-1])
    try:
        ex(bad)
    except Exception as exc:  # noqa: BLE001 — the class is what is compared
        return type(exc).__name__
    return None


def _ref_apply(state_bytes, good):
    ctx = chain_utils.Context.for_minimal()
    ns = ref_containers.build(ctx.preset)
    ex = ref_executor.Executor(ns.BeaconState.deserialize(state_bytes), ctx)
    for data in good:
        ex.apply_block(ns.SignedBeaconBlock.deserialize(data))
    return lambda data: ex.apply_block(ns.SignedBeaconBlock.deserialize(data))


def _port_apply(state_bytes, good):
    ctx = Context.for_minimal()
    ns = port_containers.build(ctx.preset)
    ex = port_executor.Executor(ns.BeaconState.deserialize(state_bytes), ctx)
    for data in good:
        ex.apply_block(ns.SignedBeaconBlock.deserialize(data))
    return lambda data: ex.apply_block(ns.SignedBeaconBlock.deserialize(data))


@pytest.mark.parametrize("route", ["host_path", "device_routed"])
@pytest.mark.parametrize("how", ["swap", "root"])
def test_tampered_block_raises_the_reference_error(chain, request, route, how):
    request.getfixturevalue(route)
    state_bytes, block_bytes = chain
    bad = _tampered(state_bytes, block_bytes, how)
    ref = _error_class(_ref_apply, state_bytes, block_bytes, bad)
    port = _error_class(_port_apply, state_bytes, block_bytes, bad)
    assert ref == {"swap": "InvalidAttestation", "root": "InvalidStateRoot"}[how]
    assert port == ref


def test_a_block_of_an_unported_fork_is_refused(chain):
    """The port carries phase0 only: a container of another fork is an
    UnknownForkError, as in the reference for a container it does not know."""
    from ethereum_consensus_tpu.models.altair import containers as ref_altair
    from ethereum_consensus_tpu_torch.error import UnknownForkError

    state_bytes, _blocks = chain
    ctx = Context.for_minimal()
    ns = port_containers.build(ctx.preset)
    ex = port_executor.Executor(ns.BeaconState.deserialize(state_bytes), ctx)
    altair_block = ref_altair.build(chain_utils.Context.for_minimal().preset).SignedBeaconBlock()
    with pytest.raises(UnknownForkError):
        ex.apply_block(altair_block)
    with pytest.raises(UnknownForkError):
        ex.apply_block(ns.BeaconBlock())
