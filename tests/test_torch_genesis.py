"""The port's genesis of every fork against the reference package.

``initialize_beacon_state_from_eth1`` and ``get_genesis_block`` of phase0,
altair, bellatrix, capella, deneb and electra on the same deposits give
identical bytes and roots, with and without a top-up, an invalid signature
and a partial deposit among them; ``IncrementalDepositRoot`` gives the
reference's roots, and the SSZ deposit list's, at deposit counts 0 to 33.
"""

import functools

import pytest

import chain_utils
from ethereum_consensus_tpu.models import genesis_common as ref_genesis_common
from ethereum_consensus_tpu.models.phase0 import containers as ref_phase0
from ethereum_consensus_tpu.ssz import List as RefList
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.fork import Fork
from ethereum_consensus_tpu_torch.models import genesis_common as port_genesis_common
from ethereum_consensus_tpu_torch.models.phase0 import containers as port_phase0
from ethereum_consensus_tpu_torch.ssz import List as PortList
from ethereum_consensus_tpu_torch.types import fork_module
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FORKS = ("phase0", "altair", "bellatrix", "capella", "deneb", "electra")
GWEI = 10**9


@functools.lru_cache(maxsize=None)
def _deposits(kind: str) -> bytes:
    """The deposits' SSZ bytes: 64 full deposits, or those plus a top-up of
    validator 3, a deposit with another key's signature and a 31 ETH one."""
    ctx = chain_utils.Context.for_minimal()
    datas = [chain_utils.make_deposit_data(i, ctx) for i in range(64)]
    if kind == "mixed":
        datas.append(chain_utils.make_deposit_data(3, ctx, amount=GWEI))
        bad = chain_utils.make_deposit_data(64, ctx)
        bad.signature = chain_utils.make_deposit_data(65, ctx).signature
        datas.append(bad)
        datas.append(chain_utils.make_deposit_data(66, ctx, amount=31 * GWEI))
    deposits = chain_utils.deposits_from_datas(datas, ctx)
    ns = chain_utils.build(ctx.preset)
    return RefList[ns.Deposit, 2**32].serialize(deposits)


@pytest.mark.parametrize("kind", ["full", "mixed"])
@pytest.mark.parametrize("fork", FORKS)
def test_genesis_matches_reference(fork, kind):
    ref_mod = chain_utils._fork_module(fork)
    ctx = chain_utils.Context.for_minimal()
    port_mod = fork_module(Fork.from_str(fork))
    port_ctx = Context.for_minimal()
    ref_ns = chain_utils.build(ctx.preset)
    port_ns = port_mod.build(port_ctx.preset)
    data = _deposits(kind)
    ref_deposits = list(RefList[ref_ns.Deposit, 2**32].deserialize(data))
    port_deposits = list(PortList[port_ns.Deposit, 2**32].deserialize(data))
    ref_kwargs, port_kwargs = {}, {}
    if fork not in ("phase0", "altair"):
        header = chain_utils.make_genesis_payload_header(ctx, fork)
        ref_kwargs["execution_payload_header"] = header
        port_kwargs["execution_payload_header"] = port_ns.ExecutionPayloadHeader.deserialize(
            type(header).serialize(header))
    ref_state = ref_mod.genesis.initialize_beacon_state_from_eth1(
        chain_utils.ETH1_BLOCK_HASH, chain_utils.ETH1_TIMESTAMP, ref_deposits, ctx, **ref_kwargs)
    port_state = port_mod.genesis.initialize_beacon_state_from_eth1(
        chain_utils.ETH1_BLOCK_HASH, chain_utils.ETH1_TIMESTAMP, port_deposits, port_ctx,
        **port_kwargs)
    assert type(port_state) is port_ns.BeaconState
    assert port_ns.BeaconState.serialize(port_state) == type(ref_state).serialize(ref_state)
    assert port_ns.BeaconState.hash_tree_root(port_state) == type(ref_state).hash_tree_root(
        ref_state)
    ref_block = ref_mod.genesis.get_genesis_block(ref_state, ctx)
    port_block = port_mod.genesis.get_genesis_block(port_state, port_ctx)
    assert port_ns.BeaconBlock.serialize(port_block) == type(ref_block).serialize(ref_block)
    assert port_mod.genesis.is_valid_genesis_state(port_state, port_ctx) == (
        ref_mod.genesis.is_valid_genesis_state(ref_state, ctx))
    # the invalid signature adds no validator; the top-up adds none either
    assert len(port_state.validators) == (64 if kind == "full" else 65)
    active = sum(int(v.activation_epoch) == 0 for v in port_state.validators)
    assert active == 64


@pytest.mark.parametrize("count", range(34))
def test_incremental_deposit_root_matches_reference(count):
    ctx = chain_utils.Context.for_minimal()
    datas = [chain_utils.make_deposit_data(i % 8, ctx, amount=(i + 1) * GWEI)
             for i in range(count)]
    ref_root, port_root = (ref_genesis_common.IncrementalDepositRoot(),
                           port_genesis_common.IncrementalDepositRoot())
    ref_roots, port_roots = [], []
    for data in datas:
        leaf = ref_phase0.DepositData.hash_tree_root(data)
        ref_roots.append(ref_root.push(leaf))
        port_roots.append(port_root.push(
            port_phase0.DepositData.hash_tree_root(
                port_phase0.DepositData.deserialize(ref_phase0.DepositData.serialize(data)))))
    assert port_roots == ref_roots
    assert port_root.count == count
    port_list = PortList[port_phase0.DepositData, 2**32]
    ssz_root = port_list.hash_tree_root(
        [port_phase0.DepositData.deserialize(ref_phase0.DepositData.serialize(d)) for d in datas])
    assert ssz_root == RefList[ref_phase0.DepositData, 2**32].hash_tree_root(datas)
    if count:
        assert port_roots[-1] == ssz_root
