"""The port's phase0 epoch processing against the reference package.

Every comparison hands the reference's SSZ bytes to the port and requires
identical post-state bytes and roots. The port runs each boundary on three
routes: the columnar engine forced on at toy sizes (with the committee
masks), the literal stage list (``ECT_EPOCH_VECTOR=off``), and
``ops.install(device="cpu")`` with the sweeps, shuffle and hasher
thresholds lowered, where the engine declines (``device_sweeps``) and the
hysteresis sweep goes through the CUDA kernel's plain version.

* a signed minimal-preset chain through both packages' ``Executor``,
  crossing four epoch boundaries;
* eight scrambled boundaries under each of full, leaking and target-only
  participation (ejections, entrants, finalized activations, slashings at
  the halfway point, hysteresis crossings both ways);
* the committee masks against the reference's on scrambled pendings;
* the columnar caches' copy-on-write travel across ``state.copy()``.
"""

import random

import numpy as np
import pytest

import chain_utils
from ethereum_consensus_tpu import executor as ref_executor
from ethereum_consensus_tpu.models import committees as ref_committees
from ethereum_consensus_tpu.models.phase0 import containers as ref_containers
from ethereum_consensus_tpu.models.phase0 import slot_processing as ref_slots
from ethereum_consensus_tpu.primitives import FAR_FUTURE_EPOCH
from ethereum_consensus_tpu_torch import executor as port_executor
from ethereum_consensus_tpu_torch import ops
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.models import committees, epoch_vector, ops_vector
from ethereum_consensus_tpu_torch.models.phase0 import containers as port_containers
from ethereum_consensus_tpu_torch.models.phase0 import slot_processing as port_slots
from ethereum_consensus_tpu_torch.ops import sweeps
from ethereum_consensus_tpu_torch.ssz import hash as port_hash
from ethereum_consensus_tpu_torch.telemetry import metrics
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N_BLOCKS = 34  # slots 1..34 at 8 slots an epoch: boundaries with cur 0, 1, 2, 3
ROUTES = ["columnar", "literal", "device_cpu"]


@pytest.fixture
def route(request, monkeypatch):
    """Put the port on one route; yields the counter that must advance
    once per boundary on it."""
    ops.uninstall()
    if request.param == "columnar":
        monkeypatch.setattr(epoch_vector, "EPOCH_VECTOR_MIN_VALIDATORS", 0)
        monkeypatch.setattr(committees, "MASKS_MIN_VALIDATORS", 0)
        counter = "epoch_vector.epochs"
    elif request.param == "literal":
        monkeypatch.setattr(epoch_vector, "EPOCH_VECTOR_MIN_VALIDATORS", 0)
        monkeypatch.setenv("ECT_EPOCH_VECTOR", "off")
        counter = "epoch_vector.fallback.disabled"
    else:
        monkeypatch.setattr(port_hash, "DEVICE_MIN_NODES", 256)
        monkeypatch.setattr(port_hash, "_device_hasher", None)
        monkeypatch.setattr(epoch_vector, "EPOCH_VECTOR_MIN_VALIDATORS", 0)
        # the G1 aggregation keeps its host threshold: its plain version
        # costs a second a block here, and tests/test_torch_blocks.py holds
        # that route
        ops.install(device="cpu", sweeps_min_n=1, shuffle_min_n=1)
        counter = "epoch_vector.fallback.device_sweeps"
    yield metrics.counter(counter)
    ops.uninstall()


def _port_type():
    return port_containers.build(Context.for_minimal().preset).BeaconState


def _ref_ns():
    return ref_containers.build(chain_utils.Context.for_minimal().preset)


def _identity(state, ref_bytes, ref_root):
    typ = type(state)
    return typ.serialize(state) == ref_bytes and typ.hash_tree_root(state) == ref_root


@pytest.fixture(scope="module")
def chain():
    """A signed chain across four epoch boundaries and the reference's
    (bytes, root) after every block."""
    state, ctx = chain_utils.fresh_genesis(64, "minimal")
    blocks = chain_utils.produce_chain(state, ctx, N_BLOCKS, "phase0", atts_per_block=2)
    ns = _ref_ns()
    ex = ref_executor.Executor(ns.BeaconState.deserialize(ns.BeaconState.serialize(state)), ctx)
    after = []
    for block in blocks:
        ex.apply_block(block)
        after.append((ex.state.serialize(), ex.state.hash_tree_root()))
    assert ex.state.data.finalized_checkpoint.epoch >= 1, "the chain never finalized"
    return (
        ns.BeaconState.serialize(state),
        [ns.SignedBeaconBlock.serialize(b) for b in blocks],
        after,
    )


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_chain_across_boundaries_matches_reference(chain, route, monkeypatch):
    state_bytes, block_bytes, after = chain
    swept = []
    plain = sweeps.effective_balance_updates_plain

    def counting(*args):
        swept.append(1)
        return plain(*args)

    monkeypatch.setattr(sweeps, "effective_balance_updates_plain", counting)
    ctx = Context.for_minimal()
    ns = port_containers.build(ctx.preset)
    ex = port_executor.Executor(ns.BeaconState.deserialize(state_bytes), ctx)
    before = route.value()
    for i, data in enumerate(block_bytes):
        ex.apply_block(ns.SignedBeaconBlock.deserialize(data))
        assert _identity(ex.state.data, *after[i]), f"block {i + 1} differs"
    boundaries = N_BLOCKS // int(ctx.SLOTS_PER_EPOCH)
    assert route.value() - before == boundaries
    assert len(swept) == (boundaries if _device_cpu(route) else 0)


def _device_cpu(counter) -> bool:
    return counter.name == "epoch_vector.fallback.device_sweeps"


def _scramble(state, ctx, rng, epoch: int) -> None:
    """Registry churn in the reference state at ``epoch``, leaving the
    active sets of this and past epochs as they were (so the pendings
    already recorded keep their committees): ejection candidates, appended
    entrants and finalized-eligible validators, slashed validators at the
    penalty halfway point, hysteresis crossings both ways, future exits."""
    ns = _ref_ns()
    n = len(state.validators)
    inc = int(ctx.EFFECTIVE_BALANCE_INCREMENT)
    down, up = inc // 4, 5 * inc // 4
    for i in rng.sample(range(n), 4):
        state.validators[i].effective_balance = int(ctx.ejection_balance)
    for k in range(5):
        eligibility = FAR_FUTURE_EPOCH if k < 3 else 0
        state.validators.append(ns.Validator(
            public_key=chain_utils.synthetic_pubkey_bytes(10_000 + n + k),
            withdrawal_credentials=b"\x00" * 32,
            effective_balance=int(ctx.MAX_EFFECTIVE_BALANCE) if k != 1 else 17 * inc,
            activation_eligibility_epoch=eligibility,
            activation_epoch=FAR_FUTURE_EPOCH,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=FAR_FUTURE_EPOCH,
        ))
        state.balances.append(int(ctx.MAX_EFFECTIVE_BALANCE))
    half = int(ctx.EPOCHS_PER_SLASHINGS_VECTOR) // 2
    for i in rng.sample(range(n), 2):
        v = state.validators[i]
        v.slashed = True
        v.withdrawable_epoch = epoch + half
        state.slashings[epoch % int(ctx.EPOCHS_PER_SLASHINGS_VECTOR)] = 3 * inc
    for i in rng.sample(range(n), 12):
        eff = int(state.validators[i].effective_balance)
        state.balances[i] = max(0, rng.choice([
            eff - down - 1, eff - down, eff + up, eff + up + 1,
            inc, 33 * inc, 62 * inc, 2100 * inc,
        ]))
    for i in rng.sample(range(n), 2):
        if state.validators[i].exit_epoch == FAR_FUTURE_EPOCH:
            state.validators[i].exit_epoch = epoch + 7
            state.validators[i].withdrawable_epoch = epoch + 7 + 256
    chain_utils._strip_spec_caches(state)


def _participate(state, ctx, rng, epoch: int, mode: str) -> None:
    """Pending attestations for ``epoch``: every committee in full, none
    (a leak builds up), or random bits with the wrong head (source and
    target only)."""
    if mode == "leak":
        return
    chain_utils.inject_full_epoch_pendings(state, ctx, epoch=epoch)
    if mode == "target":
        for a in state.current_epoch_attestations:
            a.aggregation_bits = [rng.random() < 0.7 for _ in a.aggregation_bits]
            a.data.beacon_block_root = b"\x5a" * 32
            a.inclusion_delay = rng.randint(1, int(ctx.SLOTS_PER_EPOCH))


@pytest.fixture(scope="module")
def scrambled_boundaries():
    """Eight boundaries per participation mode, in the reference package:
    for each, the pre-boundary bytes and the post-boundary (bytes, root)."""
    out = {}
    for mode in ("full", "leak", "target"):
        state, ctx = chain_utils.fresh_genesis(96, "minimal")
        rng = random.Random(mode)
        spe = int(ctx.SLOTS_PER_EPOCH)
        typ = type(state)
        cases = []
        for target in range(1, 9):
            _scramble(state, ctx, rng, target - 1)
            if state.slot < target * spe - 1:
                ref_slots.process_slots(state, target * spe - 1, ctx)
            _participate(state, ctx, rng, target - 1, mode)
            pre = typ.serialize(state)
            ref_slots.process_slots(state, target * spe, ctx)
            cases.append((pre, typ.serialize(state), typ.hash_tree_root(state)))
        out[mode] = (cases, state)
    leaked = out["leak"][1]
    assert leaked.slot // 8 - 1 - leaked.finalized_checkpoint.epoch > 4, "no leak"
    assert out["full"][1].finalized_checkpoint.epoch >= 2, "full participation never finalized"
    return {mode: cases for mode, (cases, _state) in out.items()}


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("mode", ["full", "leak", "target"])
def test_scrambled_boundaries_match_reference(scrambled_boundaries, mode, route):
    ctx = Context.for_minimal()
    typ = _port_type()
    spe = int(ctx.SLOTS_PER_EPOCH)
    before = route.value()
    for target, (pre, post, root) in enumerate(scrambled_boundaries[mode], start=1):
        state = typ.deserialize(pre)
        port_slots.process_slots(state, target * spe, ctx)
        assert _identity(state, post, root), f"{mode}: boundary into epoch {target} differs"
    assert route.value() - before == len(scrambled_boundaries[mode])


def _prepared_state(validators: int, rng, epoch_span: int):
    """The reference phase0 state one slot before the ``epoch_span``
    boundary with both pending lists over every coverable committee, then
    scrambled: random bits, multi-slot inclusion delays, duplicate
    aggregates and slashed validators (the shape of
    tests/test_committee_masks.py)."""
    state, ctx = chain_utils.fresh_genesis_fork("phase0", validators, "minimal")
    spe = int(ctx.SLOTS_PER_EPOCH)
    ref_slots.process_slots(state, epoch_span * spe - 1, ctx)
    chain_utils.inject_full_epoch_pendings(state, ctx, epoch=epoch_span - 2)
    chain_utils.inject_full_epoch_pendings(state, ctx, epoch=epoch_span - 1)
    for lst in (state.previous_epoch_attestations, state.current_epoch_attestations):
        for a in lst:
            a.aggregation_bits = [rng.random() < 0.6 for _ in a.aggregation_bits]
            a.inclusion_delay = rng.randint(1, spe)
        for first in list(lst)[:2]:
            lst.append(type(first)(
                aggregation_bits=[rng.random() < 0.5 for _ in first.aggregation_bits],
                data=first.data.copy(),
                inclusion_delay=rng.randint(1, spe),
                proposer_index=first.proposer_index,
            ))
    for i in rng.sample(range(len(state.validators)), 4):
        state.validators[i].slashed = True
    chain_utils._strip_spec_caches(state)
    return state, ctx


_MASK_FIELDS = ("source", "target", "head", "covered", "inclusion_delay", "inclusion_proposer")


@pytest.mark.parametrize("validators", [256, 640])
def test_masks_match_reference(validators, monkeypatch):
    monkeypatch.setattr(ref_committees, "MASKS_MIN_VALIDATORS", 0)
    monkeypatch.setattr(committees, "MASKS_MIN_VALIDATORS", 0)
    rng = random.Random(validators)
    ctx = Context.for_minimal()
    typ = _port_type()
    for span in (3, 4):
        ref_state, ref_ctx = _prepared_state(validators, rng, span)
        data = type(ref_state).serialize(ref_state)
        cold, hashed = typ.deserialize(data), typ.deserialize(data)
        typ.hash_tree_root(hashed)  # fills the Bitlists' packed-bits entries
        assert all("bitpack" in a.aggregation_bits._root_cache
                   for a in hashed.previous_epoch_attestations)
        for epoch in (span - 2, span - 1):
            want = ref_committees.pending_masks_for(ref_state, epoch, ref_ctx)
            assert want is not None and want.att_count > 0
            for port_state in (cold, hashed):
                got = committees.pending_masks_for(port_state, epoch, ctx)
                assert got is not None and got.att_count == want.att_count
                for field in _MASK_FIELDS:
                    a, b = getattr(got, field), getattr(want, field)
                    assert a.dtype == b.dtype and np.array_equal(a, b), (epoch, field)


def test_boundary_no_longer_raises():
    state, ctx = chain_utils.fresh_genesis(64, "minimal")
    data = type(state).serialize(state)
    port_state = _port_type().deserialize(data)
    port_slots.process_slots(port_state, 2 * int(ctx.SLOTS_PER_EPOCH) + 1, Context.for_minimal())
    assert port_state.slot == 17


def _column_consistent(state) -> bool:
    cols = ops_vector.columns_for(state)
    vc = cols.validator_columns(state)
    for field in ("effective_balance", "activation_epoch", "activation_eligibility_epoch",
                  "exit_epoch", "withdrawable_epoch"):
        if vc[field].tolist() != [getattr(v, field) for v in state.validators]:
            return False
    return cols.list_column(state, "balances").tolist() == list(state.balances)


def test_columnar_epoch_travels_across_copy(monkeypatch):
    """An epoch processed on a copy must leave the original's bytes, root
    and column caches as they were, and both caches must agree with their
    lists."""
    monkeypatch.setattr(epoch_vector, "EPOCH_VECTOR_MIN_VALIDATORS", 0)
    monkeypatch.setattr(committees, "MASKS_MIN_VALIDATORS", 0)
    state, ctx = chain_utils.fresh_genesis(96, "minimal")
    spe = int(ctx.SLOTS_PER_EPOCH)
    ref_slots.process_slots(state, 2 * spe - 1, ctx)
    chain_utils.inject_full_epoch_pendings(state, ctx, epoch=1)
    for i in range(0, 96, 7):
        state.balances[i] = 29 * 10**9 + i
    port = _port_type().deserialize(type(state).serialize(state))
    pctx = Context.for_minimal()
    port_slots.process_slots(port, 2 * spe, pctx)  # builds and adopts the columns
    typ = type(port)
    root, data = typ.hash_tree_root(port), typ.serialize(port)
    base = port.balances._col_cache[1]
    copy = port.copy()
    assert copy.balances._col_cache[1] is base and not port.balances._col_owned
    port_slots.process_slots(copy, 3 * spe, pctx)  # a columnar pass on the copy
    assert typ.hash_tree_root(port) == root and typ.serialize(port) == data
    assert port.balances._col_cache[1] is base
    assert _column_consistent(port) and _column_consistent(copy)
