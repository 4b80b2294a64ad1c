"""The port's altair fork against the reference package.

Every comparison hands the reference's SSZ bytes to the port and requires
identical post-state bytes and roots, on the four routes of
``torch_routes.py`` (the G1 aggregation's threshold lowered only in the
rejection test).

Cases: the phase0 → altair upgrade through ``Executor`` (the first altair
block on the upgrade slot); a signed altair chain across three epoch
boundaries with full sync aggregates; scrambled boundaries under full,
leaking and target-only participation; a sync-committee period boundary;
and the rejections of a bad sync aggregate.
"""

import random

import pytest

import chain_utils
import torch_genesis
from ethereum_consensus_tpu import error as ref_error
from ethereum_consensus_tpu import executor as ref_executor
from ethereum_consensus_tpu.models import altair as ref_altair
from ethereum_consensus_tpu.models.altair import slot_processing as ref_slots
from ethereum_consensus_tpu.models.phase0 import containers as ref_phase0
from ethereum_consensus_tpu.primitives import FAR_FUTURE_EPOCH
from ethereum_consensus_tpu_torch import _device_flags
from ethereum_consensus_tpu_torch import error as port_error
from ethereum_consensus_tpu_torch import executor as port_executor
from ethereum_consensus_tpu_torch import ops
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.fork import Fork
from ethereum_consensus_tpu_torch.models import altair as port_altair
from ethereum_consensus_tpu_torch.models import epoch_vector
from ethereum_consensus_tpu_torch.models.altair import slot_processing as port_slots
from ethereum_consensus_tpu_torch.models.phase0 import containers as port_phase0
from ethereum_consensus_tpu_torch.ops import epoch as port_epoch
from torch_routes import ROUTES, check_kernels, identity, route  # noqa: F401 (fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N_BLOCKS = 25  # slots 1..25 at 8 slots an epoch: boundaries into epochs 1, 2, 3


def _port_ctx(altair_epoch: int = 0) -> Context:
    ctx = Context.for_minimal()
    ctx.altair_fork_epoch = altair_epoch
    return ctx


def _altair_type(name: str):
    return getattr(port_altair.build(Context.for_minimal().preset), name)


# ---------------------------------------------------------------------------
# the phase0 -> altair upgrade through Executor
# ---------------------------------------------------------------------------


def test_upgrade_through_executor_matches_reference():
    state, ctx, blocks = torch_genesis.produce_multi_fork_chain(64)
    fork_slot = int(ctx.SLOTS_PER_EPOCH)
    assert any(int(b.message.slot) == fork_slot for b in blocks), "no block on the upgrade slot"
    ref = ref_executor.Executor(state.copy(), ctx)
    phase0_ns = port_phase0.build(Context.for_minimal().preset)
    port = port_executor.Executor(
        phase0_ns.BeaconState.deserialize(type(state).serialize(state)), _port_ctx(1)
    )
    for block in blocks:
        ref.apply_block(block)
        port_type = (_altair_type("SignedBeaconBlock") if int(block.message.slot) >= fork_slot
                     else phase0_ns.SignedBeaconBlock)
        port.apply_block(port_type.deserialize(type(block).serialize(block)))
        assert port.state.version() == ref.state.version()
        assert identity(port.state.data, ref.state.serialize(), ref.state.hash_tree_root()), \
            f"block at slot {block.message.slot} differs"
    assert port.state.version() == Fork.ALTAIR


def test_block_of_a_later_fork_raises_unknown_fork():
    state, ctx, _blocks = torch_genesis.produce_multi_fork_chain(64)
    phase0_ns = port_phase0.build(Context.for_minimal().preset)
    port = port_executor.Executor(
        phase0_ns.BeaconState.deserialize(type(state).serialize(state)), _port_ctx(1)
    )
    with pytest.raises(port_error.UnknownForkError):
        port.apply_block(object())


# ---------------------------------------------------------------------------
# a signed altair chain across epoch boundaries
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def altair_chain():
    """A signed altair chain with full sync aggregates and the reference's
    (bytes, root) after every block."""
    state, ctx = torch_genesis.fresh_genesis_altair(64, "minimal")
    blocks = chain_utils.produce_chain(state, ctx, N_BLOCKS, "altair", atts_per_block=2)
    ns = ref_altair.build(ctx.preset)
    ex = ref_executor.Executor(ns.BeaconState.deserialize(ns.BeaconState.serialize(state)), ctx)
    after = []
    for block in blocks:
        ex.apply_block(block)
        after.append((ex.state.serialize(), ex.state.hash_tree_root()))
    assert any(s for s in ex.state.data.inactivity_scores) or any(
        p for p in ex.state.data.previous_epoch_participation
    )
    return (
        ns.BeaconState.serialize(state),
        [ns.SignedBeaconBlock.serialize(b) for b in blocks],
        after,
    )


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_altair_chain_matches_reference(altair_chain, route):
    state_bytes, block_bytes, after = altair_chain
    ctx = _port_ctx()
    ex = port_executor.Executor(_altair_type("BeaconState").deserialize(state_bytes), ctx)
    block_type = _altair_type("SignedBeaconBlock")
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


# ---------------------------------------------------------------------------
# scrambled boundaries
# ---------------------------------------------------------------------------

PARTICIPATION = {"full": 0b111, "leak": 0b000, "target": 0b010}


def _scramble(state, ctx, rng, epoch: int) -> None:
    """The reference's altair churn (tests/test_epoch_vector.py:46):
    ejection candidates, queue and activation candidates, slashed
    validators at the penalty halfway point, low and high balances, future
    exits, inactivity scores; plus appended entrants and hysteresis
    crossings both ways."""
    ns = ref_phase0.build(ctx.preset)
    n = len(state.validators)
    inc = int(ctx.EFFECTIVE_BALANCE_INCREMENT)
    for i in rng.sample(range(n), 6):
        state.validators[i].effective_balance = int(ctx.ejection_balance)
    for i in rng.sample(range(n), 5):
        v = state.validators[i]
        if v.activation_epoch > epoch:
            v.activation_eligibility_epoch = 0
    half = int(ctx.EPOCHS_PER_SLASHINGS_VECTOR) // 2
    for i in rng.sample(range(n), 3):
        v = state.validators[i]
        v.slashed = True
        v.withdrawable_epoch = epoch + half
        state.slashings[epoch % int(ctx.EPOCHS_PER_SLASHINGS_VECTOR)] = inc
    for i in rng.sample(range(n), 10):
        eff = int(state.validators[i].effective_balance)
        state.balances[i] = max(0, rng.choice([
            inc, 33 * inc, 62 * inc, 2100 * inc, eff - inc // 4 - 1, eff + 5 * inc // 4 + 1,
            inc // 3,
        ]))
    for i in rng.sample(range(n), 2):
        if state.validators[i].exit_epoch == FAR_FUTURE_EPOCH:
            state.validators[i].exit_epoch = epoch + 7
            state.validators[i].withdrawable_epoch = epoch + 7 + 256
    for i in rng.sample(range(n), 10):
        state.inactivity_scores[i] = rng.randrange(0, 200)
    for k in range(2):
        state.validators.append(ns.Validator(
            public_key=chain_utils.synthetic_pubkey_bytes(20_000 + n + k),
            withdrawal_credentials=b"\x00" * 32,
            effective_balance=int(ctx.MAX_EFFECTIVE_BALANCE),
            activation_eligibility_epoch=FAR_FUTURE_EPOCH if k else 0,
            activation_epoch=FAR_FUTURE_EPOCH,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        ))
        state.balances.append(int(ctx.MAX_EFFECTIVE_BALANCE))
        state.previous_epoch_participation.append(0)
        state.current_epoch_participation.append(0)
        state.inactivity_scores.append(0)
    chain_utils._strip_spec_caches(state)


@pytest.fixture(scope="module")
def scrambled_boundaries():
    """Seven boundaries per participation mode, in the reference package:
    for each, the pre-boundary bytes and the post-boundary (bytes, root).
    Without participation the finality delay passes the leak threshold at
    the boundary into epoch 7 (the sync-committee period ends at epoch 8,
    where the entrants' synthetic keys would be sampled)."""
    out = {}
    for mode, flags in PARTICIPATION.items():
        state, ctx = torch_genesis.fresh_genesis_altair(96, "minimal")
        rng = random.Random(mode)
        spe = int(ctx.SLOTS_PER_EPOCH)
        typ = type(state)
        cases = []
        for target in range(1, 8):
            if state.slot < target * spe - 1:
                ref_slots.process_slots(state, target * spe - 1, ctx)
            _scramble(state, ctx, rng, target - 1)
            n = len(state.validators)
            state.previous_epoch_participation = [flags] * n
            state.current_epoch_participation = [flags & 0b110] * n
            pre = typ.serialize(state)
            ref_slots.process_slots(state, target * spe, ctx)
            cases.append((pre, typ.serialize(state), typ.hash_tree_root(state)))
        out[mode] = cases
        if mode == "leak":
            assert state.slot // spe - 1 - state.finalized_checkpoint.epoch > 4, "no leak"
            assert any(state.inactivity_scores)
        if mode == "full":
            assert state.finalized_checkpoint.epoch >= 2, "full participation never finalized"
    return out


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("mode", list(PARTICIPATION))
def test_scrambled_boundaries_match_reference(scrambled_boundaries, mode, route):
    ctx = _port_ctx()
    typ = _altair_type("BeaconState")
    spe = int(ctx.SLOTS_PER_EPOCH)
    before, fallbacks = route.counter.value(), route.fused_fallbacks()
    for target, (pre, post, root) in enumerate(scrambled_boundaries[mode], start=1):
        state = typ.deserialize(pre)
        port_slots.process_slots(state, target * spe, ctx)
        assert identity(state, post, root), f"{mode}: boundary into epoch {target} differs"
    boundaries = len(scrambled_boundaries[mode])
    expected = boundaries - 1 if route.name == "device_fused" else boundaries
    assert route.counter.value() - before == expected
    assert route.fused_fallbacks() == fallbacks
    check_kernels(route, expected)


# ---------------------------------------------------------------------------
# the sync-committee period boundary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_sync_committee_rotation_matches_reference(route):
    state, ctx = torch_genesis.fresh_genesis_altair(64, "minimal")
    spe = int(ctx.SLOTS_PER_EPOCH)
    period = int(ctx.EPOCHS_PER_SYNC_COMMITTEE_PERIOD)
    state.slot = period * spe - 1  # the last slot of the first period
    typ = type(state)
    pre = typ.serialize(state)
    old_next = bytes(state.next_sync_committee.aggregate_public_key)
    ref_slots.process_slots(state, period * spe, ctx)
    assert bytes(state.current_sync_committee.aggregate_public_key) == old_next
    port_state = _altair_type("BeaconState").deserialize(pre)
    port_slots.process_slots(port_state, period * spe, _port_ctx())
    assert identity(port_state, typ.serialize(state), typ.hash_tree_root(state))


# ---------------------------------------------------------------------------
# rejections
# ---------------------------------------------------------------------------


def _bad_blocks():
    """(pre-state bytes, [(name, block bytes)]) for an altair block at slot
    1: its sync-aggregate signature replaced by a block-signature-shaped
    one, and its participation bits cut to half the committee."""
    state, ctx = torch_genesis.fresh_genesis_altair(64, "minimal")
    pre = type(state).serialize(state)
    block = chain_utils.produce_block_altair(state.copy(), 1, ctx)
    ns = ref_altair.build(ctx.preset)
    replaced = block.copy()
    replaced.message.body.sync_aggregate.sync_committee_signature = bytes(block.signature)
    replaced.signature = chain_utils.sign_block(state, replaced.message, ctx)
    half = block.copy()
    bits = list(half.message.body.sync_aggregate.sync_committee_bits)
    half.message.body.sync_aggregate.sync_committee_bits = [
        b and i < len(bits) // 2 for i, b in enumerate(bits)
    ]
    half.signature = chain_utils.sign_block(state, half.message, ctx)
    return pre, [(name, ns.SignedBeaconBlock.serialize(b))
                 for name, b in (("replaced", replaced), ("bits", half))]


@pytest.mark.parametrize("route", ["columnar", "device_fused"], indirect=True)
def test_bad_sync_aggregates_rejected_like_reference(route, monkeypatch):
    if route.name == "device_fused":
        # the sync aggregate's keys go through the G1 set sum's plain version
        monkeypatch.setattr(_device_flags, "BLS_AGG_MIN_N", 1)
    pre, bad = _bad_blocks()
    ctx = Context.for_minimal()
    ref_ctx = chain_utils.Context.for_minimal()
    ref_ns = ref_altair.build(ref_ctx.preset)
    for name, data in bad:
        ref = ref_executor.Executor(ref_ns.BeaconState.deserialize(pre), ref_ctx)
        with pytest.raises(ref_error.Error) as ref_exc:
            ref.apply_block(ref_ns.SignedBeaconBlock.deserialize(data))
        port = port_executor.Executor(_altair_type("BeaconState").deserialize(pre), ctx)
        with pytest.raises(port_error.Error) as port_exc:
            port.apply_block(_altair_type("SignedBeaconBlock").deserialize(data))
        assert type(port_exc.value).__name__ == type(ref_exc.value).__name__, name
        assert type(port_exc.value).__name__ == "InvalidSyncAggregate", name


# ---------------------------------------------------------------------------
# no fallback that hides the kernel
# ---------------------------------------------------------------------------


def test_fused_kernel_failure_raises(monkeypatch):
    """A failure of the fused kernel propagates out of the epoch pass: the
    port has no route that quietly runs the staged host kernels instead."""
    ops.uninstall()
    monkeypatch.setattr(epoch_vector, "EPOCH_VECTOR_MIN_VALIDATORS", 0)
    ops.install(device="cpu", sweeps_min_n=1, shuffle_min_n=1)
    try:
        state, ctx = torch_genesis.fresh_genesis_altair(64, "minimal")
        spe = int(ctx.SLOTS_PER_EPOCH)
        state.slot = 2 * spe - 1
        port_state = _altair_type("BeaconState").deserialize(type(state).serialize(state))

        def broken(*args, **kwargs):
            raise RuntimeError("fused epoch kernel launch failed: CUDA error 98")

        monkeypatch.setattr(port_epoch, "fused_epoch_plain", broken)
        with pytest.raises(RuntimeError, match="CUDA error 98"):
            port_slots.process_slots(port_state, 2 * spe, _port_ctx())
    finally:
        ops.uninstall()
