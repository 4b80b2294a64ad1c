"""The port's bellatrix fork, and the upgrade ladder through capella,
against the reference package.

Every comparison hands the reference's SSZ bytes to the port and requires
identical post-state bytes and roots, on the four routes of
``torch_routes.py``. Cases: the ladder phase0 → altair → bellatrix →
capella through ``Executor`` (each fork's first block on its upgrade slot);
a signed bellatrix chain across three epoch boundaries; scrambled
bellatrix boundaries in a leak with slashed validators at the penalty
halfway point; the bellatrix inactivity deltas, ``slash_validator`` and
the merge predicates; and a payload the execution engine rejects.
"""

import random

import pytest

import chain_utils
import torch_genesis
from ethereum_consensus_tpu import error as ref_error
from ethereum_consensus_tpu import executor as ref_executor
from ethereum_consensus_tpu.models import bellatrix as ref_bellatrix
from ethereum_consensus_tpu.models import capella as ref_capella
from ethereum_consensus_tpu.models.altair import helpers as ref_altair_helpers
from ethereum_consensus_tpu.models.bellatrix import slot_processing as ref_slots
from ethereum_consensus_tpu_torch import error as port_error
from ethereum_consensus_tpu_torch import executor as port_executor
from ethereum_consensus_tpu_torch import ops
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.fork import Fork
from ethereum_consensus_tpu_torch.models import bellatrix as port_bellatrix
from ethereum_consensus_tpu_torch.models import capella as port_capella
from ethereum_consensus_tpu_torch.models import phase0 as port_phase0
from ethereum_consensus_tpu_torch.models.bellatrix import slot_processing as port_slots
from ethereum_consensus_tpu_torch.primitives import FAR_FUTURE_EPOCH
from ethereum_consensus_tpu_torch.types import fork_module
from torch_routes import ROUTES, check_kernels, identity, route  # noqa: F401 (fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

LADDER_FORKS = ("phase0", "altair", "bellatrix", "capella")
N_BLOCKS = 25  # slots 1..25 at 8 slots an epoch: boundaries into epochs 1, 2, 3


def _port_ctx(reference_ctx=None) -> Context:
    """A port context with the reference context's fork schedule."""
    ctx = Context.for_minimal()
    if reference_ctx is not None:
        for fork in LADDER_FORKS[1:]:
            name = f"{fork}_fork_epoch"
            setattr(ctx, name, getattr(reference_ctx, name))
    return ctx


def _port_type(fork: str, name: str):
    return getattr(fork_module(Fork.from_str(fork)).build(Context.for_minimal().preset), name)


def _denominator(ctx, fork: str) -> int:
    quotient = "INACTIVITY_PENALTY_QUOTIENT_" + ("ALTAIR" if fork == "altair" else "BELLATRIX")
    return int(ctx.inactivity_score_bias) * int(getattr(ctx, quotient))


def _check_route(route, ctx, before: tuple, boundaries: int, forks: list) -> None:
    """The route's counter advanced once a boundary (the fused kernel skips
    the genesis epoch's, the first of every chain here), no fused route
    declined, each route reached its plain versions, and those got the
    quotient of the fork whose boundary they ran (``forks``, one a boundary
    past the genesis epoch's)."""
    expected = boundaries - 1 if route.name == "device_fused" else boundaries
    assert (route.counter.value() - before[0], route.fused_fallbacks()) == (expected, before[1])
    check_kernels(route, expected)
    if route.name.startswith("device"):
        assert route.denominators == [_denominator(ctx, f) for f in forks]
    else:
        assert route.denominators == []


# ---------------------------------------------------------------------------
# the upgrade ladder through Executor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ladder():
    """The reference's signed chain from phase0 genesis up the forks, one a
    epoch (tests/chain_utils.py produce_full_upgrade_chain), cut after
    capella's epoch; with the reference Executor's (fork, bytes, root)
    after every block."""
    state, ctx, blocks = torch_genesis.produce_full_upgrade_chain(64)
    blocks = [b for b in blocks
              if chain_utils.full_upgrade_fork_at_slot(int(b.message.slot), ctx) in LADDER_FORKS]
    ex = ref_executor.Executor(state.copy(), ctx)
    after = []
    for block in blocks:
        ex.apply_block(block)
        after.append((str(ex.state.version()), ex.state.serialize(), ex.state.hash_tree_root()))
    assert after[-1][0] == "capella"
    return (type(state).serialize(state),
            [type(b).serialize(b) for b in blocks], after, ctx)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_upgrade_ladder_matches_reference(ladder, route):
    state_bytes, block_bytes, after, ref_ctx = ladder
    ctx = _port_ctx(ref_ctx)
    ex = port_executor.Executor(
        port_phase0.build(ctx.preset).BeaconState.deserialize(state_bytes), ctx)
    before = (route.counter.value(), route.fused_fallbacks())
    firsts = set()
    for data, (fork, post, root) in zip(block_bytes, after):
        block = _port_type(fork, "SignedBeaconBlock").deserialize(data)
        ex.apply_block(block)
        assert str(ex.state.version()) == fork
        assert identity(ex.state.data, post, root), f"{fork} block at slot {block.message.slot}"
        firsts.add(fork)
    assert firsts == set(LADDER_FORKS)
    # the boundaries into epochs 1, 2 and 3 ran under phase0, altair and
    # bellatrix rules
    _check_route(route, ctx, before, 3, ["altair", "bellatrix"])


def test_upgrades_match_reference():
    """Each upgrade alone, from the reference's state at the fork slot."""
    state, ctx, _blocks = torch_genesis.produce_full_upgrade_chain(64)
    ref_state = state.copy()
    pctx = _port_ctx(ctx)
    for previous, fork in zip(LADDER_FORKS, LADDER_FORKS[1:]):
        ref_mod = chain_utils._fork_module(previous)
        fork_slot = int(getattr(ctx, f"{fork}_fork_epoch")) * int(ctx.SLOTS_PER_EPOCH)
        ref_mod.slot_processing.process_slots(ref_state, fork_slot, ctx)
        port_state = _port_type(previous, "BeaconState").deserialize(
            type(ref_state).serialize(ref_state))
        ref_state = getattr(chain_utils._fork_module(fork), f"upgrade_to_{fork}")(ref_state, ctx)
        port_up = getattr(fork_module(Fork.from_str(fork)), f"upgrade_to_{fork}")(port_state, pctx)
        assert type(port_up) is _port_type(fork, "BeaconState")
        assert identity(port_up, type(ref_state).serialize(ref_state),
                        type(ref_state).hash_tree_root(ref_state)), fork


# ---------------------------------------------------------------------------
# a signed bellatrix chain across epoch boundaries
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bellatrix_chain():
    state, ctx = torch_genesis.fresh_genesis_bellatrix(64, "minimal")
    blocks = chain_utils.produce_chain(state, ctx, N_BLOCKS, "bellatrix", atts_per_block=2)
    ns = ref_bellatrix.build(ctx.preset)
    ex = ref_executor.Executor(ns.BeaconState.deserialize(ns.BeaconState.serialize(state)), ctx)
    after = []
    for block in blocks:
        ex.apply_block(block)
        after.append((ex.state.serialize(), ex.state.hash_tree_root()))
    return (ns.BeaconState.serialize(state),
            [ns.SignedBeaconBlock.serialize(b) for b in blocks], after)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_bellatrix_chain_matches_reference(bellatrix_chain, route):
    state_bytes, block_bytes, after = bellatrix_chain
    ctx = _port_ctx()
    ex = port_executor.Executor(_port_type("bellatrix", "BeaconState").deserialize(state_bytes),
                                ctx)
    block_type = _port_type("bellatrix", "SignedBeaconBlock")
    before = (route.counter.value(), route.fused_fallbacks())
    for i, data in enumerate(block_bytes):
        ex.apply_block(block_type.deserialize(data))
        assert identity(ex.state.data, *after[i]), f"block {i + 1} differs"
    assert ex.state.data.latest_execution_payload_header.block_number == N_BLOCKS
    boundaries = N_BLOCKS // int(ctx.SLOTS_PER_EPOCH)
    _check_route(route, ctx, before, boundaries, ["bellatrix"] * (boundaries - 1))


# ---------------------------------------------------------------------------
# scrambled bellatrix boundaries: a leak, scores, slashings
# ---------------------------------------------------------------------------


def _scramble(state, ctx, rng, epoch: int) -> None:
    """Inactivity scores, slashed validators at the penalty halfway point
    (the slashing multiplier), low and high balances, and a participation
    with the target flag missed by a third: the bellatrix quotients show."""
    n = len(state.validators)
    inc = int(ctx.EFFECTIVE_BALANCE_INCREMENT)
    half = int(ctx.EPOCHS_PER_SLASHINGS_VECTOR) // 2
    for i in rng.sample(range(n), 3):
        v = state.validators[i]
        v.slashed = True
        v.withdrawable_epoch = epoch + half
    state.slashings[epoch % int(ctx.EPOCHS_PER_SLASHINGS_VECTOR)] = 3 * inc
    for i in rng.sample(range(n), 8):
        state.balances[i] = rng.choice([inc, 33 * inc, inc // 3, 31 * inc + inc // 2])
    for i in range(n):
        state.inactivity_scores[i] = rng.randrange(0, 400)
        state.previous_epoch_participation[i] = 0b001 if i % 3 == 0 else 0b111
        state.current_epoch_participation[i] = 0b011 if i % 5 == 0 else 0b110
    chain_utils._strip_spec_caches(state)


@pytest.fixture(scope="module")
def scrambled_boundaries():
    """Boundaries into epochs 1..6 of a bellatrix genesis state with no
    blocks (finality stalls: the leak starts at the boundary into epoch 6),
    each scrambled first: (pre bytes, post bytes, post root)."""
    state, ctx = torch_genesis.fresh_genesis_bellatrix(64, "minimal")
    rng = random.Random("bellatrix")
    spe = int(ctx.SLOTS_PER_EPOCH)
    typ = type(state)
    cases = []
    for target in range(1, 7):
        ref_slots.process_slots(state, target * spe - 1, ctx)
        _scramble(state, ctx, rng, target - 1)
        pre = typ.serialize(state)
        ref_slots.process_slots(state, target * spe, ctx)
        cases.append((pre, typ.serialize(state), typ.hash_tree_root(state)))
    assert any(v.slashed and v.exit_epoch != FAR_FUTURE_EPOCH for v in state.validators)
    return cases


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_scrambled_bellatrix_boundaries_match_reference(scrambled_boundaries, route):
    ctx = _port_ctx()
    typ = _port_type("bellatrix", "BeaconState")
    spe = int(ctx.SLOTS_PER_EPOCH)
    before = (route.counter.value(), route.fused_fallbacks())
    for target, (pre, post, root) in enumerate(scrambled_boundaries, start=1):
        state = typ.deserialize(pre)
        port_slots.process_slots(state, target * spe, ctx)
        assert identity(state, post, root), f"boundary into epoch {target} differs"
    boundaries = len(scrambled_boundaries)
    _check_route(route, ctx, before, boundaries, ["bellatrix"] * (boundaries - 1))


@pytest.mark.parametrize("where", ["host", "device"])
def test_inactivity_deltas_use_the_bellatrix_quotient(scrambled_boundaries, where):
    """The literal route's bellatrix inactivity deltas, on the host loop and
    through the kernel's plain version, against the reference's loop; and
    the altair quotient gives other deltas on the same state."""
    pre = scrambled_boundaries[-1][0]
    ref_state = ref_bellatrix.build(chain_utils.Context.for_minimal().preset) \
        .BeaconState.deserialize(pre)
    ref_ctx = chain_utils.Context.for_minimal()
    want = ref_bellatrix.helpers.get_inactivity_penalty_deltas(ref_state, ref_ctx)
    altair = ref_altair_helpers.get_inactivity_penalty_deltas(ref_state, ref_ctx)
    assert any(want[1]) and want != altair
    ops.uninstall()
    if where == "device":
        ops.install(device="cpu", sweeps_min_n=1)
    try:
        state = _port_type("bellatrix", "BeaconState").deserialize(pre)
        got = port_bellatrix.helpers.get_inactivity_penalty_deltas(state, _port_ctx())
    finally:
        ops.uninstall()
    assert (list(got[0]), list(got[1])) == (list(want[0]), list(want[1]))


def test_slash_validator_matches_reference():
    state, ctx = torch_genesis.fresh_genesis_bellatrix(64, "minimal")
    ref_slots.process_slots(state, 3 * int(ctx.SLOTS_PER_EPOCH) + 2, ctx)
    pre = type(state).serialize(state)
    port_state = _port_type("bellatrix", "BeaconState").deserialize(pre)
    for index, whistleblower in ((5, None), (9, 17)):
        ref_bellatrix.helpers.slash_validator(state, index, whistleblower, ctx)
        port_bellatrix.helpers.slash_validator(port_state, index, whistleblower, _port_ctx())
    assert identity(port_state, type(state).serialize(state), type(state).hash_tree_root(state))


@pytest.mark.parametrize("merged", [True, False], ids=["post_merge", "pre_merge"])
@pytest.mark.parametrize("payload", [True, False], ids=["payload", "empty_payload"])
def test_merge_predicates_match_reference(merged, payload):
    state, ctx = torch_genesis.fresh_genesis_bellatrix(64, "minimal")
    ns = ref_bellatrix.build(ctx.preset)
    if not merged:
        state.latest_execution_payload_header = ns.ExecutionPayloadHeader()
    body = ns.BeaconBlockBody()
    if payload:
        body.execution_payload = chain_utils.make_execution_payload(state, ctx)
    port_state = _port_type("bellatrix", "BeaconState").deserialize(type(state).serialize(state))
    port_body = _port_type("bellatrix", "BeaconBlockBody").deserialize(
        ns.BeaconBlockBody.serialize(body))
    for name in ("is_merge_transition_complete",):
        assert getattr(port_bellatrix.helpers, name)(port_state) == \
            getattr(ref_bellatrix.helpers, name)(state)
    for name in ("is_merge_transition_block", "is_execution_enabled"):
        assert getattr(port_bellatrix.helpers, name)(port_state, port_body) == \
            getattr(ref_bellatrix.helpers, name)(state, body)
    assert port_bellatrix.helpers.compute_timestamp_at_slot(port_state, 7, _port_ctx()) == \
        ref_bellatrix.helpers.compute_timestamp_at_slot(state, 7, ctx)


# ---------------------------------------------------------------------------
# the execution engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fork", ["bellatrix", "capella"])
def test_engine_rejection_is_the_reference_error(fork):
    """With the engine mock set to False both packages refuse the block's
    payload with the same error; with True both apply it alike."""
    ref_mod = {"bellatrix": ref_bellatrix, "capella": ref_capella}[fork]
    port_mod = {"bellatrix": port_bellatrix, "capella": port_capella}[fork]
    state, ctx = torch_genesis.fresh_genesis_fork(fork, 64, "minimal")
    pre = type(state).serialize(state)
    block = chain_utils.produce_block_fork(fork, state.copy(), 1, ctx)
    data = type(block).serialize(block)
    ref_ns = ref_mod.build(ctx.preset)
    port_ns = port_mod.build(Context.for_minimal().preset)
    outcomes = []
    for engine in (False, True):
        ref_ctx, port_ctx = chain_utils.Context.for_minimal(), _port_ctx()
        ref_ctx.execution_engine = port_ctx.execution_engine = engine
        ref = ref_executor.Executor(ref_ns.BeaconState.deserialize(pre), ref_ctx)
        port = port_executor.Executor(port_ns.BeaconState.deserialize(pre), port_ctx)
        try:
            ref.apply_block(ref_ns.SignedBeaconBlock.deserialize(data))
            ref_outcome = (ref.state.serialize(), ref.state.hash_tree_root())
        except ref_error.Error as exc:
            ref_outcome = type(exc).__name__
        try:
            port.apply_block(port_ns.SignedBeaconBlock.deserialize(data))
            port_outcome = (port.state.serialize(), port.state.hash_tree_root())
        except port_error.Error as exc:
            port_outcome = type(exc).__name__
        assert port_outcome == ref_outcome
        outcomes.append(port_outcome)
    assert outcomes[0] == "ExecutionEngineError" and outcomes[1] != outcomes[0]
