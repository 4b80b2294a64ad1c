"""The slice end to end: phase0 process_slots in the port and the reference.

The same minimal-preset state bytes go through both packages'
``process_slots`` to slot 7, the last slot before the first epoch boundary.
The port hashes with its device hasher routed on the CPU (threshold lowered
so the route is taken); post-state bytes and roots must be identical.
"""

import pytest

import chain_utils
from ethereum_consensus_tpu.config import Context as RefContext
from ethereum_consensus_tpu.models.phase0 import containers as ref_containers
from ethereum_consensus_tpu.models.phase0 import slot_processing as ref_slots
from ethereum_consensus_tpu_torch import convert, ops
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.models.phase0 import slot_processing
from ethereum_consensus_tpu_torch.ssz import hash as port_hash


@pytest.fixture(scope="module")
def state_bytes():
    state, _ctx = chain_utils.build_fast_registry_state(1024, "phase0", "minimal")
    return type(state).serialize(state)


def _ref_post_state(state_bytes: bytes, slot: int):
    ctx = RefContext.for_minimal()
    ref_type = ref_containers.build(ctx.preset).BeaconState
    state = ref_type.deserialize(state_bytes)
    ref_slots.process_slots(state, slot, ctx)
    return ref_type.serialize(state), ref_type.hash_tree_root(state)


def test_process_slots_matches_reference_with_port_hasher(monkeypatch, state_bytes):
    monkeypatch.setattr(port_hash, "DEVICE_MIN_NODES", 256)
    monkeypatch.setattr(port_hash, "_device_hasher", None)
    ops.install(device="cpu")
    installed = port_hash._device_hasher
    routed = []

    def counting(nodes: bytes) -> bytes:
        routed.append(len(nodes) // 64)
        return installed(nodes)

    port_hash.register_device_hasher(counting)

    ctx = Context.for_minimal()
    state = convert.state_from_ssz(state_bytes, ctx.preset)
    slot_processing.process_slots(state, 7, ctx)
    port_type = type(state)

    ref_bytes, ref_root = _ref_post_state(state_bytes, 7)
    assert state.slot == 7
    assert port_type.serialize(state) == ref_bytes
    assert port_type.hash_tree_root(state) == ref_root
    assert routed, "no level went through the port's device hasher"


def test_crossing_the_epoch_boundary_raises(state_bytes):
    ctx = Context.for_minimal()
    state = convert.state_from_ssz(state_bytes, ctx.preset)
    slot_processing.process_slots(state, 7, ctx)
    at_seven = type(state).serialize(state)
    with pytest.raises(NotImplementedError, match="epoch_processing"):
        slot_processing.process_slots(state, 8, ctx)
    assert type(state).serialize(state) == at_seven  # untouched


def test_process_slots_backwards_is_a_transition_error(state_bytes):
    from ethereum_consensus_tpu_torch.error import StateTransitionError

    ctx = Context.for_minimal()
    state = convert.state_from_ssz(state_bytes, ctx.preset)
    with pytest.raises(StateTransitionError):
        slot_processing.process_slots(state, 0, ctx)
