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
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

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


# ---------------------------------------------------------------------------
# the bulk paths of fixed-size collections against the per-element path
# ---------------------------------------------------------------------------

def _per_element(elem, values):
    """The per-element serialization: bytes, or the exception's class."""
    try:
        return b"".join(elem.serialize(v) for v in values)
    except Exception as exc:  # noqa: BLE001 - the class is what is compared
        return type(exc)


def _validators(n: int) -> list:
    ns = port_containers.build(MINIMAL)
    return [ns.Validator(public_key=_b(48), withdrawal_credentials=_b(32),
                         effective_balance=_u64(), slashed=bool(i % 3),
                         activation_eligibility_epoch=_u64(), activation_epoch=i,
                         exit_epoch=2**64 - 1, withdrawable_epoch=_u64())
            for i in range(n)]


def _uints(bits: int) -> list:
    return [0, 1, 2**bits - 1, *(int(x) for x in _rng.integers(0, 2**min(bits, 63), 37))]


# (element type, values) of collections the bulk paths take, and of values
# they must hand back to the per-element path (which raises its own error)
BULK_CASES = {
    "uint8": (lambda ssz: ssz.uint8, lambda: _uints(8)),
    "uint16": (lambda ssz: ssz.uint16, lambda: _uints(16)),
    "uint32": (lambda ssz: ssz.uint32, lambda: _uints(32)),
    "uint64": (lambda ssz: ssz.uint64, lambda: _uints(64)),
    "uint64_empty": (lambda ssz: ssz.uint64, lambda: []),
    "bytes32": (lambda ssz: ssz.ByteVector[32], lambda: [_b(32) for _ in range(9)]),
    "validators": (lambda ssz: port_containers.build(MINIMAL).Validator, lambda: _validators(40)),
    "validators_empty": (lambda ssz: port_containers.build(MINIMAL).Validator, lambda: []),
    "uint64_bool": (lambda ssz: ssz.uint64, lambda: [1, True, 3]),
    "uint64_negative": (lambda ssz: ssz.uint64, lambda: [1, -1]),
    "uint8_too_big": (lambda ssz: ssz.uint8, lambda: [1, 256]),
    "uint64_numpy": (lambda ssz: ssz.uint64, lambda: [np.uint64(5)]),
    "bytes32_short": (lambda ssz: ssz.ByteVector[32], lambda: [_b(32), _b(31)]),
    "bytes32_bytearray": (lambda ssz: ssz.ByteVector[32], lambda: [bytearray(_b(32))]),
}


def _bad_validators(change) -> list:
    values = _validators(5)
    change(values[3])
    return values


BULK_CASES.update({
    "validator_short_key": (lambda ssz: port_containers.build(MINIMAL).Validator,
                            lambda: _bad_validators(lambda v: setattr(v, "public_key", _b(47)))),
    "validator_int_flag": (lambda ssz: port_containers.build(MINIMAL).Validator,
                           lambda: _bad_validators(lambda v: setattr(v, "slashed", 1))),
    "validator_bad_flag": (lambda ssz: port_containers.build(MINIMAL).Validator,
                           lambda: _bad_validators(lambda v: setattr(v, "slashed", 2))),
    "validator_big_epoch": (lambda ssz: port_containers.build(MINIMAL).Validator,
                            lambda: _bad_validators(lambda v: setattr(v, "exit_epoch", 2**64))),
})


@pytest.mark.parametrize("case", sorted(BULK_CASES))
def test_bulk_collections_match_the_per_element_path(case):
    """Lists of fixed-size elements serialize to the per-element path's
    bytes (or raise its error) and read back to equal values."""
    from ethereum_consensus_tpu_torch import ssz

    elem_of, values_of = BULK_CASES[case]
    elem, values = elem_of(ssz), values_of()
    typ = ssz.List[elem, 1024]
    want = _per_element(elem, values)
    if isinstance(want, type):
        with pytest.raises(want):
            typ.serialize(values)
        return
    data = typ.serialize(values)
    assert data == want
    back = typ.deserialize(data)
    assert back == [bool(v) if type(v) is bool else v for v in values]
    assert [type(v) for v in back] == [type(elem.deserialize(want[:elem.fixed_size()]))
                                       for _ in back]
    assert typ.hash_tree_root(back) == typ.hash_tree_root(values)


@pytest.mark.parametrize("where", [0, 7, 39])
def test_bulk_read_refuses_a_bad_boolean(where):
    """A flag byte other than 0 or 1 anywhere in a container row is the
    per-element path's DeserializeError."""
    from ethereum_consensus_tpu_torch import ssz

    elem = port_containers.build(MINIMAL).Validator
    data = bytearray(ssz.List[elem, 1024].serialize(_validators(40)))
    data[where * elem.fixed_size() + 48 + 32 + 8] = 2  # the slashed flag
    with pytest.raises(ssz.DeserializeError, match="invalid boolean"):
        ssz.List[elem, 1024].deserialize(bytes(data))


def test_bulk_read_values_are_fresh_containers():
    """The rows read in bulk are plain containers: no cached root, a field
    write is seen by the next root."""
    from ethereum_consensus_tpu_torch import ssz

    elem = port_containers.build(MINIMAL).Validator
    typ = ssz.List[elem, 1024]
    back = typ.deserialize(typ.serialize(_validators(12)))
    assert all("_htr_cache" not in v.__dict__ for v in back)
    root = typ.hash_tree_root(back)
    back[4].effective_balance += 1
    assert typ.hash_tree_root(back) != root
