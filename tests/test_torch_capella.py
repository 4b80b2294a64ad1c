"""The port's capella fork against the reference package.

Every comparison hands the reference's SSZ bytes to the port and requires
identical post-state bytes and roots, or the same error class. Cases: a
signed capella chain with full and partial withdrawals across three epoch
boundaries, then on to the boundary into epoch 8 where the minimal preset
appends a historical summary, on the four routes of ``torch_routes.py``;
``get_expected_withdrawals`` with the registry columns on and off (full
and partial withdrawals, the sweep's wrap past the registry's end, a hit at
``next_withdrawal_validator_index``); BLS-to-execution changes, valid and
refused; and a payload whose withdrawals were changed.
"""

import pytest

import chain_utils
from ethereum_consensus_tpu import error as ref_error
from ethereum_consensus_tpu import executor as ref_executor
from ethereum_consensus_tpu.crypto import bls as ref_bls
from ethereum_consensus_tpu.domains import DomainType
from ethereum_consensus_tpu.models import capella as ref_capella
from ethereum_consensus_tpu.models.capella import block_processing as ref_bp
from ethereum_consensus_tpu.models.capella import slot_processing as ref_slots
from ethereum_consensus_tpu.signing import compute_signing_root
from ethereum_consensus_tpu_torch import error as port_error
from ethereum_consensus_tpu_torch import executor as port_executor
from ethereum_consensus_tpu_torch import ops
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.models import capella as port_capella
from ethereum_consensus_tpu_torch.models.capella import block_processing as port_bp
from ethereum_consensus_tpu_torch.models.capella import slot_processing as port_slots
from ethereum_consensus_tpu_torch.ops import g1 as port_g1
from ethereum_consensus_tpu_torch.telemetry import metrics
from torch_routes import ROUTES, check_kernels, identity, route  # noqa: F401 (fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N_BLOCKS = 25  # slots 1..25: boundaries into epochs 1, 2, 3
SUMMARY_SLOT = 65  # past the boundary into epoch 8, where a summary is appended
ETH1_VALIDATORS = range(0, 64, 5)  # 0x01 credentials and an excess balance


def _ctx() -> Context:
    return Context.for_minimal()


def _port_type(name: str):
    return getattr(port_capella.build(_ctx().preset), name)


def _ref_ns():
    return ref_capella.build(chain_utils.Context.for_minimal().preset)


def _address(i: int) -> bytes:
    return ref_bls.hash(b"exec-addr-%d" % i)[:20]


def _eth1_credentials(state, indices, excess: int) -> None:
    for i in indices:
        state.validators[i].withdrawal_credentials = b"\x01" + b"\x00" * 11 + _address(i)
        state.balances[i] = int(state.balances[i]) + excess


# ---------------------------------------------------------------------------
# a signed capella chain with withdrawals, then the summary boundary
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def capella_chain():
    """The reference's chain from a capella genesis whose 0x01 validators
    hold an excess (partial withdrawals in every sweep) and one of them is
    withdrawable (a full withdrawal); the (bytes, root) after every block,
    then after the empty slots to SUMMARY_SLOT."""
    state, ctx = chain_utils.fresh_genesis_capella(64, "minimal")
    _eth1_credentials(state, ETH1_VALIDATORS, 3 * 10**9)
    state.validators[ETH1_VALIDATORS[-1]].withdrawable_epoch = 0
    blocks = chain_utils.produce_chain(state, ctx, N_BLOCKS, "capella", atts_per_block=2)
    ns = ref_capella.build(ctx.preset)
    ex = ref_executor.Executor(ns.BeaconState.deserialize(ns.BeaconState.serialize(state)), ctx)
    after = []
    for block in blocks:
        ex.apply_block(block)
        after.append((ex.state.serialize(), ex.state.hash_tree_root()))
    withdrawals = sum(len(b.message.body.execution_payload.withdrawals) for b in blocks)
    assert withdrawals >= N_BLOCKS and ex.state.data.balances[ETH1_VALIDATORS[-1]] == 0
    end = ex.state.data
    ref_slots.process_slots(end, SUMMARY_SLOT, ctx)
    assert len(end.historical_summaries) == 1
    return (ns.BeaconState.serialize(state), [ns.SignedBeaconBlock.serialize(b) for b in blocks],
            after, (ns.BeaconState.serialize(end), ns.BeaconState.hash_tree_root(end)))


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_capella_chain_and_summary_boundary_match_reference(capella_chain, route):
    state_bytes, block_bytes, after, summary = capella_chain
    ctx = _ctx()
    ex = port_executor.Executor(_port_type("BeaconState").deserialize(state_bytes), ctx)
    block_type = _port_type("SignedBeaconBlock")
    before, fallbacks = route.counter.value(), route.fused_fallbacks()
    for i, data in enumerate(block_bytes):
        ex.apply_block(block_type.deserialize(data))
        assert identity(ex.state.data, *after[i]), f"block {i + 1} differs"
    state = ex.state.data
    port_slots.process_slots(state, SUMMARY_SLOT, ctx)
    assert identity(state, *summary), "the empty slots to the summary boundary differ"
    assert len(state.historical_summaries) == 1
    # the fused kernel skips the genesis boundary like the stages it fuses
    boundaries = SUMMARY_SLOT // int(ctx.SLOTS_PER_EPOCH)
    expected = boundaries - 1 if route.name == "device_fused" else boundaries
    assert route.counter.value() - before == expected
    assert route.fused_fallbacks() == fallbacks
    check_kernels(route, expected)
    denominator = int(ctx.inactivity_score_bias) * int(ctx.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX)
    want = [denominator] * (boundaries - 1) if route.name.startswith("device") else []
    assert route.denominators == want


# ---------------------------------------------------------------------------
# the withdrawals sweep
# ---------------------------------------------------------------------------

WITHDRAWAL_CASES = {
    # (0x01 validators, withdrawable ones, cursor, excess on 0x01)
    "partial": (range(0, 64, 3), (), 0, 10**9),
    "full": (range(0, 64, 4), (8, 12, 40), 0, 0),
    "mixed": (range(64), (3, 60), 0, 2 * 10**9),
    "wrap": ((1, 2, 61, 63), (2,), 56, 10**9),
    "at_cursor": ((20, 21, 30), (), 20, 10**9),
    "sweep_edge": ((55, 56), (), 40, 10**9),  # the sweep's last index, and the one past it
    "none": ((), (), 63, 10**9),
}


def _withdrawal_state(case: str):
    """A capella genesis state at epoch 1 set up for ``case``."""
    eth1, withdrawable, cursor, excess = WITHDRAWAL_CASES[case]
    state, ctx = chain_utils.fresh_genesis_capella(64, "minimal")
    ref_slots.process_slots(state, int(ctx.SLOTS_PER_EPOCH) + 1, ctx)
    _eth1_credentials(state, eth1, excess)
    for i in withdrawable:
        state.validators[i].withdrawable_epoch = 1
    state.next_withdrawal_validator_index = cursor
    state.next_withdrawal_index = 1000
    return state, ctx


@pytest.mark.parametrize("columns", ["on", "off"])
@pytest.mark.parametrize("case", list(WITHDRAWAL_CASES))
def test_expected_withdrawals_match_reference(case, columns, monkeypatch):
    state, ctx = _withdrawal_state(case)
    want = ref_bp._get_expected_withdrawals_loop(state, ctx)
    assert ref_bp.get_expected_withdrawals(state, ctx) == want
    ns = _ref_ns()
    port_state = _port_type("BeaconState").deserialize(type(state).serialize(state))
    hits = metrics.counter("ops_vector.fallback.columns_unavailable")
    before = hits.value()
    monkeypatch.setattr(port_bp, "WITHDRAWALS_VECTOR_MIN_VALIDATORS", 0)
    if columns == "off":
        monkeypatch.setenv("ECT_OPS_VECTOR", "off")
    got = port_bp.get_expected_withdrawals(port_state, _ctx())
    assert [port_capella.containers.Withdrawal.serialize(w) for w in got] == \
        [ns.Withdrawal.serialize(w) for w in want]
    assert (hits.value() > before) == (columns == "off")
    if case != "none":
        assert want
    if case == "sweep_edge":
        assert [int(w.validator_index) for w in want] == [55]
    # and the sweep's application: balances and both cursors
    payload_ns = ns.ExecutionPayload(withdrawals=want)
    ref_bp.process_withdrawals(state, payload_ns, ctx)
    port_bp.process_withdrawals(
        port_state, _port_type("ExecutionPayload").deserialize(
            ns.ExecutionPayload.serialize(payload_ns)), _ctx())
    assert identity(port_state, type(state).serialize(state), type(state).hash_tree_root(state))


def test_changed_withdrawal_is_refused_like_reference():
    state, ctx = _withdrawal_state("mixed")
    pre = type(state).serialize(state)
    block = chain_utils.produce_block_capella(state.copy(), int(state.slot) + 1, ctx)
    block.message.body.execution_payload.withdrawals[1].amount += 1
    block.signature = chain_utils.sign_block(state, block.message, ctx)
    assert _outcomes(pre, block) == ("InvalidWithdrawals",) * 2


# ---------------------------------------------------------------------------
# BLS-to-execution changes
# ---------------------------------------------------------------------------


def _change(state, ctx, index: int, *, key_of=None, sign_with=None):
    """A signed change of ``index``'s credentials to an execution address,
    from the key of ``key_of`` signed by the key of ``sign_with`` (both
    ``index`` unless given)."""
    ns = _ref_ns()
    message = ns.BlsToExecutionChange(
        validator_index=index,
        from_bls_public_key=chain_utils.public_key_bytes(index if key_of is None else key_of),
        to_execution_address=_address(1000 + index),
    )
    domain = ref_capella.helpers.compute_domain(
        DomainType.BLS_TO_EXECUTION_CHANGE, None, bytes(state.genesis_validators_root), ctx)
    root = compute_signing_root(ns.BlsToExecutionChange, message, domain)
    key = chain_utils.secret_key(index if sign_with is None else sign_with)
    return ns.SignedBlsToExecutionChange(message=message, signature=key.sign(root).to_bytes())


CHANGE_CASES = {
    "valid": ("valid", None),
    "wrong_prefix": ("eth1", "InvalidBlsToExecutionChange"),
    "other_key": ("key", "InvalidBlsToExecutionChange"),
    "bad_signature": ("signature", "InvalidBlsToExecutionChange"),
    "out_of_range": ("index", "InvalidBlsToExecutionChange"),
}


def _outcomes(pre: bytes, block, *, device: bool = False) -> tuple:
    """(reference, port) outcome of applying ``block`` to ``pre``: the
    error class's name, or the post-state's (bytes, root)."""
    ns = _ref_ns()
    data = ns.SignedBeaconBlock.serialize(block)
    ref = ref_executor.Executor(ns.BeaconState.deserialize(pre), chain_utils.Context.for_minimal())
    try:
        ref.apply_block(ns.SignedBeaconBlock.deserialize(data))
        ref_out = (ref.state.serialize(), ref.state.hash_tree_root())
    except ref_error.Error as exc:
        ref_out = type(exc).__name__
    port = port_executor.Executor(_port_type("BeaconState").deserialize(pre), _ctx())
    ops.uninstall()
    if device:
        ops.install(device="cpu", sweeps_min_n=1, shuffle_min_n=1, bls_agg_min_n=1)
    try:
        port.apply_block(_port_type("SignedBeaconBlock").deserialize(data))
        port_out = (port.state.serialize(), port.state.hash_tree_root())
    except port_error.Error as exc:
        port_out = type(exc).__name__
    finally:
        ops.uninstall()
    return ref_out, port_out


@pytest.mark.parametrize("case", list(CHANGE_CASES))
def test_bls_to_execution_changes_match_reference(case):
    state, ctx = chain_utils.fresh_genesis_capella(64, "minimal")
    _eth1_credentials(state, (7,), 0)
    pre = type(state).serialize(state)
    kind, error = CHANGE_CASES[case]
    changes = [_change(state, ctx, 3), _change(state, ctx, 11)]
    if kind == "eth1":
        changes.append(_change(state, ctx, 7))
    elif kind == "key":
        changes.append(_change(state, ctx, 20, key_of=21, sign_with=21))
    elif kind == "signature":
        changes.append(_change(state, ctx, 20, sign_with=21))
    elif kind == "index":
        changes.append(_change(state, ctx, 64, key_of=5, sign_with=5))
    good = chain_utils.produce_block_capella(state.copy(), 1, ctx,
                                             bls_to_execution_changes=changes[:2])
    block = good.copy()
    block.message.body.bls_to_execution_changes = changes
    block.signature = chain_utils.sign_block(state, block.message, ctx)
    ref_out, port_out = _outcomes(pre, block if error else good)
    assert port_out == ref_out
    if error:
        assert port_out == error
    else:
        post = _port_type("BeaconState").deserialize(port_out[0])
        assert bytes(post.validators[3].withdrawal_credentials)[:1] == b"\x01"


def test_bls_to_execution_changes_on_the_device_route(monkeypatch):
    """The changes' signature sets join the block's batch on the device
    route, where the G1 set sum's plain version adds every set's keys."""
    seen = []
    plain = port_g1.g1_sum_sets_plain

    def counting(points, offsets):
        seen.append(len(offsets) - 1)
        return plain(points, offsets)

    monkeypatch.setattr(port_g1, "g1_sum_sets_plain", counting)
    state, ctx = chain_utils.fresh_genesis_capella(64, "minimal")
    pre = type(state).serialize(state)
    changes = [_change(state, ctx, i) for i in (3, 4, 11)]
    block = chain_utils.produce_block_capella(state.copy(), 1, ctx,
                                              bls_to_execution_changes=changes)
    ref_out, port_out = _outcomes(pre, block, device=True)
    assert port_out == ref_out and isinstance(port_out, tuple)
    # the proposer's, randao's, the sync aggregate's and the three changes'
    assert seen and seen[0] >= 6
    bad = block.copy()
    bad.message.body.bls_to_execution_changes[1] = _change(state, ctx, 4, sign_with=5)
    bad.signature = chain_utils.sign_block(state, bad.message, ctx)
    assert _outcomes(pre, bad, device=True) == ("InvalidBlsToExecutionChange",) * 2
