"""The port's SSZ against the reference: same roots, same bytes.

Values are built in the reference package, carried across as SSZ bytes and
read back by the port; both sides must give identical ``hash_tree_root``
and re-serialize to identical bytes. The device-hasher route is exercised
on the CPU with the routing threshold lowered, as the reference's own
integration test does.
"""

import numpy as np
import pytest

import chain_utils
from ethereum_consensus_tpu.config import Context as RefContext
from ethereum_consensus_tpu.models.phase0 import containers as ref_containers
from ethereum_consensus_tpu_torch import convert, ops
from ethereum_consensus_tpu_torch.config import MINIMAL
from ethereum_consensus_tpu_torch.models.phase0 import containers as port_containers
from ethereum_consensus_tpu_torch.ssz import hash as port_hash
from ethereum_consensus_tpu_torch.ssz.merkle import merkleize_chunks

_rng = np.random.default_rng(1234)


def _b(n: int) -> bytes:
    return _rng.bytes(n)


def _u64() -> int:
    return int(_rng.integers(0, 2**63)) * 2 + 1


def _checkpoint(ns):
    return ns.Checkpoint(epoch=_u64(), root=_b(32))


def _attestation_data(ns):
    return ns.AttestationData(
        slot=_u64(), index=_u64(), beacon_block_root=_b(32),
        source=_checkpoint(ns), target=_checkpoint(ns),
    )


def _header(ns):
    return ns.BeaconBlockHeader(
        slot=_u64(), proposer_index=_u64(), parent_root=_b(32),
        state_root=_b(32), body_root=_b(32),
    )


def _block(ns):
    body = ns.BeaconBlockBody(
        randao_reveal=_b(96),
        eth1_data=ns.Eth1Data(deposit_root=_b(32), deposit_count=_u64(), block_hash=_b(32)),
        graffiti=_b(32),
        attestations=[
            ns.Attestation(
                aggregation_bits=[bool(x) for x in _rng.integers(0, 2, size=5 + i)],
                data=_attestation_data(ns),
                signature=_b(96),
            )
            for i in range(3)
        ],
        proposer_slashings=[
            ns.ProposerSlashing(
                signed_header_1=ns.SignedBeaconBlockHeader(message=_header(ns), signature=_b(96)),
                signed_header_2=ns.SignedBeaconBlockHeader(message=_header(ns), signature=_b(96)),
            )
        ],
        voluntary_exits=[
            ns.SignedVoluntaryExit(
                message=ns.VoluntaryExit(epoch=_u64(), validator_index=_u64()),
                signature=_b(96),
            )
        ],
    )
    return ns.BeaconBlock(
        slot=_u64(), proposer_index=_u64(), parent_root=_b(32), state_root=_b(32), body=body
    )


# name -> factory over the reference's minimal-preset namespace
FACTORIES = {
    "Fork": lambda ns: ns.Fork(previous_version=_b(4), current_version=_b(4), epoch=_u64()),
    "Checkpoint": _checkpoint,
    "Validator": lambda ns: ns.Validator(
        public_key=_b(48), withdrawal_credentials=_b(32), effective_balance=_u64(),
        slashed=True, activation_eligibility_epoch=_u64(), activation_epoch=_u64(),
        exit_epoch=_u64(), withdrawable_epoch=_u64(),
    ),
    "AttestationData": _attestation_data,
    "DepositData": lambda ns: ns.DepositData(
        public_key=_b(48), withdrawal_credentials=_b(32), amount=_u64(), signature=_b(96)
    ),
    "BeaconBlockHeader": _header,
    "SigningData": lambda ns: ns.SigningData(object_root=_b(32), domain=_b(32)),
    "BeaconBlock": _block,
    "PendingAttestation": lambda ns: ns.PendingAttestation(
        aggregation_bits=[True, False, True], data=_attestation_data(ns),
        inclusion_delay=_u64(), proposer_index=_u64(),
    ),
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_container_roots_and_bytes_match_reference(name):
    ref_cls = getattr(ref_containers.build(RefContext.for_minimal().preset), name)
    port_cls = getattr(port_containers.build(MINIMAL), name)
    value = FACTORIES[name](ref_containers.build(RefContext.for_minimal().preset))
    data = ref_cls.serialize(value)
    carried = port_cls.deserialize(data)
    assert port_cls.serialize(carried) == data
    assert port_cls.hash_tree_root(carried) == ref_cls.hash_tree_root(value)


@pytest.fixture(scope="module")
def ref_state():
    state, _ctx = chain_utils.build_fast_registry_state(1024, "phase0", "minimal")
    return state


def test_beacon_state_root_and_bytes_match_reference(ref_state):
    ref_type = type(ref_state)
    data = ref_type.serialize(ref_state)
    state = convert.state_from_ssz(data, MINIMAL)
    port_type = type(state)
    assert port_type.serialize(state) == data
    assert port_type.hash_tree_root(state) == ref_type.hash_tree_root(ref_state)


def _route_counter(monkeypatch, threshold: int) -> list:
    """Lower the device threshold, install the port's hasher on the CPU and
    record the parent-node count of every level routed through it."""
    monkeypatch.setattr(port_hash, "DEVICE_MIN_NODES", threshold)
    monkeypatch.setattr(port_hash, "_device_hasher", None)
    ops.install(device="cpu")
    installed = port_hash._device_hasher
    calls = []

    def counting(nodes: bytes) -> bytes:
        calls.append(len(nodes) // 64)
        return installed(nodes)

    port_hash.register_device_hasher(counting)
    return calls


def test_device_hasher_route_keeps_roots(monkeypatch):
    chunks = np.random.default_rng(3).bytes(32 * 4096)
    before = merkleize_chunks(chunks)
    calls = _route_counter(monkeypatch, 1024)
    assert merkleize_chunks(chunks) == before
    assert calls == [2048, 1024]  # top two levels routed to the device hasher


def test_device_hasher_route_keeps_state_root(monkeypatch, ref_state):
    ref_type = type(ref_state)
    data = ref_type.serialize(ref_state)
    calls = _route_counter(monkeypatch, 256)
    state = convert.state_from_ssz(data, MINIMAL)
    assert type(state).hash_tree_root(state) == ref_type.hash_tree_root(ref_state)
    assert calls and min(calls) >= 256
