"""The port's electra fork against the reference package.

Every comparison hands the reference's SSZ bytes to the port and requires
identical post-state bytes and roots, or the same error class. Cases: the
upgrade ladder phase0 → electra through ``Executor`` on the four routes of
``torch_routes.py``, and ``upgrade_to_electra`` from deneb alone on a state
with pending validators and compounding balances (the port's column scans
and its registry walk); a signed electra chain of committee-spanning
aggregates (EIP-7549) across two epoch boundaries on the four routes; the
electra boundary on the columnar and literal routes (pending deposits,
pending consolidations, ejections under the balance-weighted churn,
unbounded activations, hysteresis under the compounding cap) and
``effective_balance_update_hits`` with the cap; deposit receipts
(EIP-6110), withdrawal requests (EIP-7002), a key the registry holds
twice, consolidations (EIP-7251) and electra's withdrawals with pending
partials.
"""

import random

import pytest

import chain_utils
import torch_genesis
from ethereum_consensus_tpu import error as ref_error
from ethereum_consensus_tpu import executor as ref_executor
from ethereum_consensus_tpu.crypto import bls as ref_bls
from ethereum_consensus_tpu.domains import DomainType
from ethereum_consensus_tpu.models import deneb as ref_deneb
from ethereum_consensus_tpu.models import electra as ref_electra
from ethereum_consensus_tpu.models import ops_vector as ref_ops_vector
from ethereum_consensus_tpu.models.phase0 import containers as ref_phase0
from ethereum_consensus_tpu.signing import compute_signing_root
from ethereum_consensus_tpu_torch import error as port_error
from ethereum_consensus_tpu_torch import executor as port_executor
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.fork import Fork
from ethereum_consensus_tpu_torch.models import electra as port_electra
from ethereum_consensus_tpu_torch.models import ops_vector
from ethereum_consensus_tpu_torch.models import phase0 as port_phase0
from ethereum_consensus_tpu_torch.models.electra import block_processing as port_ebp
from ethereum_consensus_tpu_torch.primitives import FAR_FUTURE_EPOCH
from ethereum_consensus_tpu_torch.types import fork_module
from torch_routes import ROUTES, check_kernels, identity, route  # noqa: F401 (fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N_BLOCKS = 17  # slots 1..17 at 8 slots an epoch: boundaries into epochs 1 and 2
GWEI = 10**9


def _port_ctx(reference_ctx=None) -> Context:
    """A port context with the reference context's fork schedule."""
    ctx = Context.for_minimal()
    if reference_ctx is not None:
        for fork in chain_utils.FULL_UPGRADE_FORKS[1:]:
            name = f"{fork}_fork_epoch"
            setattr(ctx, name, getattr(reference_ctx, name))
    return ctx


def _port_type(fork: str, name: str):
    return getattr(fork_module(Fork.from_str(fork)).build(Context.for_minimal().preset), name)


def _ref_ns():
    return ref_electra.build(chain_utils.Context.for_minimal().preset)


def _to_port(state, fork: str = "electra"):
    return _port_type(fork, "BeaconState").deserialize(type(state).serialize(state))


def _same(port_state, ref_state) -> bool:
    return identity(port_state, type(ref_state).serialize(ref_state),
                    type(ref_state).hash_tree_root(ref_state))


def _both(ref_state, port_state, ref_fn, port_fn) -> tuple:
    """Run ``ref_fn(ref_state)`` and ``port_fn(port_state)``: each side's
    error class name, or None when it returned."""
    outs = []
    for state, fn, error in ((ref_state, ref_fn, ref_error.Error),
                             (port_state, port_fn, port_error.Error)):
        try:
            fn(state)
            outs.append(None)
        except error as exc:
            outs.append(type(exc).__name__)
    return tuple(outs)


def _eth1_credentials(address: bytes) -> bytes:
    return b"\x01" + b"\x00" * 11 + address


def _compounding_credentials(address: bytes) -> bytes:
    return b"\x02" + b"\x00" * 11 + address


def _drop_caches(state) -> None:
    for key in ("_active_idx_cache", "_proposer_cache", "_total_active_balance_cache",
                "_pubkey_index_cache"):
        state.__dict__.pop(key, None)


# ---------------------------------------------------------------------------
# the upgrade ladder through Executor, and the upgrade alone
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ladder():
    """The reference's signed chain from phase0 genesis up all six forks,
    one an epoch (tests/chain_utils.py produce_full_upgrade_chain), with
    the reference Executor's (fork, bytes, root) after every block."""
    state, ctx, blocks = torch_genesis.produce_full_upgrade_chain(64)
    ex = ref_executor.Executor(state.copy(), ctx)
    after = []
    for block in blocks:
        ex.apply_block(block)
        after.append((str(ex.state.version()), ex.state.serialize(), ex.state.hash_tree_root()))
    assert after[-1][0] == "electra"
    return (type(state).serialize(state),
            [type(b).serialize(b) for b in blocks], after, ctx)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_upgrade_ladder_to_electra_matches_reference(ladder, route):
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
    assert firsts == set(chain_utils.FULL_UPGRADE_FORKS)
    # the boundaries into epochs 1 to 5 ran under phase0, altair,
    # bellatrix, capella and deneb rules (the upgrade to electra follows
    # the last); the fused kernel runs the altair family's four
    boundaries = 5
    expected = boundaries - 1 if route.name == "device_fused" else boundaries
    assert (route.counter.value() - before[0], route.fused_fallbacks()) == (expected, before[1])
    check_kernels(route, expected)
    if route.name.startswith("device"):
        quotients = ("ALTAIR", "BELLATRIX", "BELLATRIX", "BELLATRIX")
        assert route.denominators == [
            int(ctx.inactivity_score_bias) * int(getattr(ctx, f"INACTIVITY_PENALTY_QUOTIENT_{q}"))
            for q in quotients]


def _deneb_state_for_upgrade():
    """A deneb state at its slot 8 with pending validators in a mixed
    eligibility order (one of them compounding), exits already queued, and
    compounding validators above 32 ETH (one of them pending)."""
    state, ctx = torch_genesis.fresh_genesis_deneb(64, "minimal")
    ref_deneb.slot_processing.process_slots(state, int(ctx.SLOTS_PER_EPOCH), ctx)
    rng = random.Random(0xE1EC)
    for i in rng.sample(range(64), 12):
        v = state.validators[i]
        v.activation_epoch = FAR_FUTURE_EPOCH
        v.activation_eligibility_epoch = rng.choice([0, 1, 3, 2, FAR_FUTURE_EPOCH])
    for i in (5, 17, 40):
        state.validators[i].exit_epoch = 7 + i
        state.validators[i].withdrawable_epoch = 300 + i
    pending = [i for i in range(64) if int(state.validators[i].activation_epoch) == FAR_FUTURE_EPOCH]
    for i in [1, 2, 33, 60, pending[0]]:
        state.validators[i].withdrawal_credentials = _compounding_credentials(bytes([i]) * 20)
        state.balances[i] = int(state.balances[i]) + (i + 1) * 3 * GWEI
    _drop_caches(state)
    return state, ctx


@pytest.mark.parametrize("scan", ["columns", "registry_walk"])
def test_upgrade_to_electra_from_deneb_matches_reference(scan, monkeypatch):
    state, ctx = _deneb_state_for_upgrade()
    port_state = _to_port(state, "deneb")
    if scan == "registry_walk":
        monkeypatch.setattr(ops_vector, "columns_for", lambda state: None)
    upgraded = ref_electra.upgrade_to_electra(state, ctx)
    port_up = port_electra.upgrade_to_electra(port_state, Context.for_minimal())
    assert type(port_up) is _port_type("electra", "BeaconState")
    assert _same(port_up, upgraded)
    # the pending validators' balances queued in (eligibility, index) order,
    # then the active compounding validators' excesses
    pending = sorted((int(v.activation_eligibility_epoch), i)
                     for i, v in enumerate(state.validators)
                     if int(v.activation_epoch) == FAR_FUTURE_EPOCH)
    compounding = [i for i, v in enumerate(state.validators)
                   if bytes(v.withdrawal_credentials)[:1] == b"\x02"
                   and int(v.activation_epoch) != FAR_FUTURE_EPOCH]
    assert [int(d.index) for d in port_up.pending_balance_deposits] == (
        [i for _, i in pending] + compounding)
    assert len(pending) == 12 and len(compounding) >= 3
    assert int(port_up.earliest_exit_epoch) == 7 + 40 + 1


# ---------------------------------------------------------------------------
# a signed electra chain of committee-spanning aggregates
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def electra_chain():
    """The reference's signed electra chain from an electra genesis, one
    committee-spanning aggregate a block; with the reference's (bytes,
    root) after every block."""
    state, ctx = torch_genesis.fresh_genesis_electra(64, "minimal")
    scratch = state.copy()
    transition = ref_electra.state_transition
    blocks, pending = [], []
    for slot in range(1, N_BLOCKS + 1):
        block = chain_utils.produce_block_electra(scratch, slot, ctx, attestations=pending)
        transition.state_transition_block_in_slot(scratch, block, transition.Validation.ENABLED,
                                                  ctx)
        pending = [chain_utils.make_attestation_electra(scratch, slot, ctx)]
        blocks.append(block)
    ns = _ref_ns()
    ex = ref_executor.Executor(ns.BeaconState.deserialize(ns.BeaconState.serialize(state)), ctx)
    after = []
    for block in blocks:
        ex.apply_block(block)
        after.append((ex.state.serialize(), ex.state.hash_tree_root()))
    return (ns.BeaconState.serialize(state), [ns.SignedBeaconBlock.serialize(b) for b in blocks],
            after)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_electra_chain_matches_reference(electra_chain, route):
    state_bytes, block_bytes, after = electra_chain
    ctx = Context.for_minimal()
    ex = port_executor.Executor(_port_type("electra", "BeaconState").deserialize(state_bytes),
                                ctx)
    block_type = _port_type("electra", "SignedBeaconBlock")
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
    assert any(int(f) for f in ex.state.data.previous_epoch_participation)


# ---------------------------------------------------------------------------
# the electra boundary: columnar and literal routes
# ---------------------------------------------------------------------------

BOUNDARY_SLOT = 24  # the boundary into epoch 3, with epoch 2 finalized


def _boundary_state(deposits: str, huge: int = 0):
    """An electra state one slot before the boundary into epoch 3, with
    pending balance deposits beyond or within the activation-exit churn,
    pending consolidations (a slashed source, two ripe, one unripe, one
    ripe behind it), ejections, entrants activated without a churn cap,
    and compounding balances at the 2,048 ETH edge; with ``huge``, an
    exited compounding validator holds that balance (near 2^64)."""
    state, ctx = torch_genesis.fresh_genesis_electra(64, "minimal")
    ns = _ref_ns()
    ref_electra.slot_processing.process_slots(state, BOUNDARY_SLOT - 1, ctx)
    state.finalized_checkpoint.epoch = 2
    inc, max_eb = int(ctx.EFFECTIVE_BALANCE_INCREMENT), int(ctx.MAX_EFFECTIVE_BALANCE_ELECTRA)
    # pending balance deposits
    amounts = [9 * GWEI] * 20 if deposits == "beyond_churn" else [5 * GWEI] * 3
    for k, amount in enumerate(amounts):
        state.pending_balance_deposits.append(ns.PendingBalanceDeposit(index=k % 8,
                                                                       amount=amount))
    state.deposit_balance_to_consume = 3 * GWEI
    # consolidations: (source, target, source state)
    for src, tgt, kind in ((10, 20, "slashed"), (11, 21, "ripe"), (12, 22, "ripe"),
                           (13, 23, "unripe"), (14, 24, "ripe")):
        s = state.validators[src]
        s.withdrawal_credentials = _eth1_credentials(b"\x0c" * 20)
        s.exit_epoch = 1
        s.withdrawable_epoch = 2 if kind != "unripe" else 9
        s.slashed = kind == "slashed"
        state.validators[tgt].withdrawal_credentials = _eth1_credentials(b"\x0c" * 20)
        state.balances[tgt] = 40 * GWEI
        state.pending_consolidations.append(
            ns.PendingConsolidation(source_index=src, target_index=tgt))
    state.validators[12].withdrawal_credentials = _compounding_credentials(b"\x0c" * 20)
    state.balances[12] = 100 * GWEI
    state.validators[22].withdrawal_credentials = _compounding_credentials(b"\x0c" * 20)
    # ejections under the balance-weighted churn
    for i in range(30, 40):
        state.validators[i].effective_balance = int(ctx.ejection_balance)
        state.balances[i] = int(ctx.ejection_balance)
    # entrants: eligible (all activate) and queue entries
    for i in range(40, 50):
        state.validators[i].activation_epoch = FAR_FUTURE_EPOCH
        state.validators[i].activation_eligibility_epoch = 1 + i % 2
    for i in range(50, 53):
        state.validators[i].activation_epoch = FAR_FUTURE_EPOCH
        state.validators[i].activation_eligibility_epoch = FAR_FUTURE_EPOCH
    # hysteresis under the compounding cap
    for i, (eff, balance) in zip(range(55, 60), ((32 * GWEI, max_eb + 3 * inc // 10),
                                                 (32 * GWEI, 2100 * GWEI),
                                                 (max_eb, max_eb - inc // 10),
                                                 (max_eb, max_eb - 3 * inc // 10),
                                                 (32 * GWEI, 40 * GWEI))):
        prefix = _eth1_credentials if i == 59 else _compounding_credentials
        state.validators[i].withdrawal_credentials = prefix(bytes([i]) * 20)
        state.validators[i].effective_balance = eff
        state.balances[i] = balance
    if huge:
        v = state.validators[61]
        v.withdrawal_credentials = _compounding_credentials(b"\x3d" * 20)
        v.exit_epoch, v.withdrawable_epoch = 1, 2
        state.balances[61] = huge
    _drop_caches(state)
    return state, ctx


@pytest.mark.parametrize("route", ["columnar", "literal"], indirect=True)
@pytest.mark.parametrize("deposits,huge", [("beyond_churn", 0), ("within_churn", 0),
                                           ("beyond_churn", (1 << 64) - 5 * GWEI)])
def test_electra_boundary_matches_reference(deposits, huge, route):
    state, ctx = _boundary_state(deposits, huge)
    port_state = _to_port(state)
    port_ctx = Context.for_minimal()
    churn = port_electra.helpers.get_activation_exit_churn_limit(port_state, port_ctx)
    available = churn + 3 * GWEI
    ref_electra.slot_processing.process_slots(state, BOUNDARY_SLOT, ctx)
    guard = ops_vector.metrics.counter("epoch_vector.fallback.u64_guard")
    before = (route.counter.value(), guard.value())
    port_electra.slot_processing.process_slots(port_state, BOUNDARY_SLOT, port_ctx)
    assert _same(port_state, state)
    # the balance near 2^64 sends the columnar route to the literal stages
    declined = huge and route.name == "columnar"
    assert (route.counter.value() - before[0], guard.value() - before[1]) == (
        (0, 1) if declined else (1, 0))
    post = port_state
    queued = 20 if deposits == "beyond_churn" else 3
    consumed = queued - len([d for d in post.pending_balance_deposits if int(d.index) < 8])
    assert consumed == (available // (9 * GWEI) if deposits == "beyond_churn" else 3) < 20
    assert [(int(p.source_index), int(p.target_index)) for p in post.pending_consolidations] == [
        (13, 23), (14, 24)]
    assert {bytes(post.validators[t].withdrawal_credentials)[:1] for t in (21, 22)} == {b"\x02"}
    assert bytes(post.validators[20].withdrawal_credentials)[:1] == b"\x01"
    assert all(int(post.validators[i].activation_epoch) != FAR_FUTURE_EPOCH
               for i in range(40, 50))
    assert [int(post.validators[i].activation_eligibility_epoch) for i in range(50, 53)] == [3] * 3
    # ten ejections of 16 ETH overrun one epoch's churn
    assert len({int(post.validators[i].exit_epoch) for i in range(30, 40)}) > 1
    assert [int(post.validators[i].effective_balance) // GWEI for i in range(55, 60)] == [
        2048, 2048, 2048, 2047, 32]


@pytest.mark.parametrize("huge", [0, (1 << 64) - 5 * GWEI, (1 << 64) - 1])
def test_effective_balance_update_hits_with_the_cap_match_reference(huge):
    state, ctx = _boundary_state("within_churn", huge)
    port_state = _to_port(state)
    port_ctx = Context.for_minimal()
    ref_hits = ref_ops_vector.effective_balance_update_hits(state, ctx, per_validator_limit=True)
    hits = ops_vector.effective_balance_update_hits(port_state, port_ctx,
                                                    per_validator_limit=True)
    assert hits == ref_hits
    if huge == (1 << 64) - 1:
        # balance + the upward threshold would wrap u64: both decline
        assert hits is None
        return
    assert {i for i, _ in hits} >= {55, 56, 58}
    assert dict(hits)[56] == int(ctx.MAX_EFFECTIVE_BALANCE_ELECTRA)
    # a balance near 2^64 is capped like any other
    assert dict(hits).get(61) == (int(ctx.MAX_EFFECTIVE_BALANCE_ELECTRA) if huge else None)
    if not huge:
        # without the cap the compounding validators stop at 32 ETH
        uncapped = dict(ops_vector.effective_balance_update_hits(port_state, port_ctx))
        assert uncapped.get(55, 32 * GWEI) == 32 * GWEI


# ---------------------------------------------------------------------------
# deposit receipts (EIP-6110)
# ---------------------------------------------------------------------------


def _receipt(key: int, ctx, amount: int, index: int, credentials=None, bad_signature=False):
    ns = _ref_ns()
    message = ref_phase0.DepositMessage(
        public_key=chain_utils.public_key_bytes(key),
        withdrawal_credentials=credentials or chain_utils.withdrawal_credentials(key),
        amount=amount)
    domain = ref_electra.helpers.compute_domain(DomainType.DEPOSIT, None, None, ctx)
    root = compute_signing_root(ref_phase0.DepositMessage, message, domain)
    signer = key + 1 if bad_signature else key
    return ns.DepositReceipt(public_key=message.public_key,
                             withdrawal_credentials=message.withdrawal_credentials,
                             amount=amount,
                             signature=chain_utils.secret_key(signer).sign(root).to_bytes(),
                             index=index)


@pytest.mark.parametrize("case", ["top_up", "new_validator", "bad_signature",
                                  "compounding_top_up", "start_index"])
def test_deposit_receipts_match_reference(case):
    state, ctx = torch_genesis.fresh_genesis_electra(64, "minimal")
    addr = b"\x2a" * 20
    if case == "compounding_top_up":
        state.validators[3].withdrawal_credentials = _eth1_credentials(addr)
        state.balances[3] = 36 * GWEI
    receipts = {
        "top_up": [_receipt(3, ctx, 5 * GWEI, 0)],
        "new_validator": [_receipt(100, ctx, 32 * GWEI, 0)],
        "bad_signature": [_receipt(101, ctx, 32 * GWEI, 0, bad_signature=True)],
        "compounding_top_up": [_receipt(3, ctx, GWEI, 0, _compounding_credentials(addr))],
        "start_index": [_receipt(3, ctx, GWEI, 7), _receipt(4, ctx, GWEI, 8)],
    }[case]
    port_state = _to_port(state)
    port_ctx = Context.for_minimal()
    n = len(state.validators)
    for receipt in receipts:
        port_receipt = _port_type("electra", "DepositReceipt").deserialize(
            type(receipt).serialize(receipt))
        assert _both(state, port_state,
                     lambda s: ref_electra.block_processing.process_deposit_receipt(
                         s, receipt, ctx),
                     lambda s: port_ebp.process_deposit_receipt(s, port_receipt, port_ctx)) == (
            None, None)
    assert _same(port_state, state)
    grown = len(port_state.validators) - n
    assert grown == (1 if case == "new_validator" else 0)
    assert int(port_state.deposit_receipts_start_index) == (7 if case == "start_index" else 0)
    assert len(port_state.pending_balance_deposits) == {
        "bad_signature": 0, "start_index": 2, "compounding_top_up": 2}.get(case, 1)


# ---------------------------------------------------------------------------
# withdrawal requests (EIP-7002)
# ---------------------------------------------------------------------------

REQUEST_CASES = ["full_exit", "partial_compounding", "unknown_key", "no_execution_credential",
                 "wrong_address", "inactive", "exiting", "too_young", "pending_blocks_exit",
                 "queue_full", "partial_without_excess", "partial_on_eth1"]


@pytest.mark.parametrize("case", REQUEST_CASES)
def test_withdrawal_requests_match_reference(case):
    state, ctx = torch_genesis.fresh_genesis_electra(64, "minimal")
    ns = _ref_ns()
    addr = b"\x33" * 20
    # past shard_committee_period, so the genesis validators may exit
    state.slot = (int(ctx.shard_committee_period) + 1) * int(ctx.SLOTS_PER_EPOCH)
    if case == "too_young":
        state.slot = 10 * int(ctx.SLOTS_PER_EPOCH)
    index, amount = 4, 0
    v = state.validators[index]
    v.withdrawal_credentials = _eth1_credentials(addr)
    if case in ("partial_compounding", "queue_full", "partial_without_excess"):
        v.withdrawal_credentials = _compounding_credentials(addr)
        state.balances[index] = (32 if case == "partial_without_excess" else 41) * GWEI
        amount = 4 * GWEI
    if case == "partial_on_eth1":
        state.balances[index] = 41 * GWEI
        amount = 4 * GWEI
    if case == "no_execution_credential":
        v.withdrawal_credentials = b"\x00" + bytes(v.withdrawal_credentials)[1:]
    if case == "inactive":
        v.activation_epoch = FAR_FUTURE_EPOCH
    if case == "exiting":
        v.exit_epoch = 200
    if case == "pending_blocks_exit":
        state.pending_partial_withdrawals.append(
            ns.PendingPartialWithdrawal(index=index, amount=GWEI, withdrawable_epoch=90))
    if case == "queue_full":
        for k in range(int(ctx.PENDING_PARTIAL_WITHDRAWALS_LIMIT)):
            state.pending_partial_withdrawals.append(
                ns.PendingPartialWithdrawal(index=5, amount=1, withdrawable_epoch=90))
    key = chain_utils.public_key_bytes(999 if case == "unknown_key" else index)
    request = ns.ExecutionLayerWithdrawalRequest(
        source_address=b"\x44" * 20 if case == "wrong_address" else addr,
        validator_public_key=key, amount=amount)
    _drop_caches(state)
    pre = type(state).serialize(state)
    port_state = _to_port(state)
    port_request = _port_type("electra", "ExecutionLayerWithdrawalRequest").deserialize(
        type(request).serialize(request))
    assert _both(state, port_state,
                 lambda s: ref_electra.block_processing.process_execution_layer_withdrawal_request(
                     s, request, ctx),
                 lambda s: port_ebp.process_execution_layer_withdrawal_request(
                     s, port_request, Context.for_minimal())) == (None, None)
    assert _same(port_state, state)
    changed = type(port_state).serialize(port_state) != pre
    assert changed == (case in ("full_exit", "partial_compounding"))
    if case == "full_exit":
        assert int(port_state.validators[index].exit_epoch) != FAR_FUTURE_EPOCH
    if case == "partial_compounding":
        assert [int(w.amount) for w in port_state.pending_partial_withdrawals] == [4 * GWEI]


@pytest.mark.parametrize("operation", ["receipt", "request"])
def test_repeated_key_resolves_to_its_first_index_as_reference(operation):
    """A registry that holds one key twice (SSZ input; the deposit path
    never appends a known key): a receipt tops up, and a request exits, the
    key's first index, as the spec's ``pubkeys.index``, in both packages."""
    state, ctx = torch_genesis.fresh_genesis_electra(64, "minimal")
    ns = _ref_ns()
    addr = b"\x33" * 20
    state.slot = (int(ctx.shard_committee_period) + 1) * int(ctx.SLOTS_PER_EPOCH)
    first, repeat = 4, 9
    for i in (first, repeat):
        state.validators[i].withdrawal_credentials = _eth1_credentials(addr)
    state.validators[repeat].public_key = state.validators[first].public_key
    _drop_caches(state)
    port_state = _to_port(state)
    port_ctx = Context.for_minimal()
    if operation == "receipt":
        op = _receipt(first, ctx, 5 * GWEI, 0)
        port_op = _port_type("electra", "DepositReceipt").deserialize(type(op).serialize(op))
        ref_fn = ref_electra.block_processing.process_deposit_receipt
        port_fn = port_ebp.process_deposit_receipt
    else:
        op = ns.ExecutionLayerWithdrawalRequest(
            source_address=addr, validator_public_key=chain_utils.public_key_bytes(first),
            amount=0)
        port_op = _port_type("electra", "ExecutionLayerWithdrawalRequest").deserialize(
            type(op).serialize(op))
        ref_fn = ref_electra.block_processing.process_execution_layer_withdrawal_request
        port_fn = port_ebp.process_execution_layer_withdrawal_request
    assert _both(state, port_state, lambda s: ref_fn(s, op, ctx),
                 lambda s: port_fn(s, port_op, port_ctx)) == (None, None)
    assert _same(port_state, state)
    if operation == "receipt":
        assert [int(d.index) for d in port_state.pending_balance_deposits] == [first]
    else:
        assert int(port_state.validators[first].exit_epoch) != FAR_FUTURE_EPOCH
        assert int(port_state.validators[repeat].exit_epoch) == FAR_FUTURE_EPOCH


# ---------------------------------------------------------------------------
# consolidations (EIP-7251)
# ---------------------------------------------------------------------------


def _signed_consolidation(state, ctx, source, target, epoch=0, signers=None):
    ns = _ref_ns()
    consolidation = ns.Consolidation(source_index=source, target_index=target, epoch=epoch)
    domain = ref_electra.helpers.compute_domain(
        DomainType.CONSOLIDATION, None, bytes(state.genesis_validators_root), ctx)
    root = compute_signing_root(ns.Consolidation, consolidation, domain)
    signers = (source, target) if signers is None else signers
    signature = ref_bls.aggregate([chain_utils.secret_key(k).sign(root) for k in signers])
    return ns.SignedConsolidation(message=consolidation, signature=signature.to_bytes())


CONSOLIDATION_CASES = ["queue_full", "low_churn", "same_index", "source_out_of_range",
                       "target_out_of_range", "source_inactive", "target_inactive",
                       "source_exiting", "target_exiting", "future_epoch", "source_no_execution",
                       "target_no_execution", "address_mismatch", "source_signature_only",
                       "undecodable_key"]


def _consolidation_state(inflate: bool = True):
    state, ctx = torch_genesis.fresh_genesis_electra(64, "minimal")
    for i in (7, 8):
        state.validators[i].withdrawal_credentials = _eth1_credentials(b"\x66" * 20)
    if inflate:
        # a consolidation churn above MIN_ACTIVATION_BALANCE needs a total
        # active balance far above the toy registry's
        for v in state.validators:
            v.effective_balance = int(ctx.MIN_ACTIVATION_BALANCE) * 100
    _drop_caches(state)
    return state, ctx


@pytest.mark.parametrize("case", CONSOLIDATION_CASES)
def test_invalid_consolidations_match_reference(case):
    state, ctx = _consolidation_state(inflate=case != "low_churn")
    ns = _ref_ns()
    source, target, epoch, signers = 7, 8, 0, None
    if case == "queue_full":
        for _ in range(int(ctx.PENDING_CONSOLIDATIONS_LIMIT)):
            state.pending_consolidations.append(
                ns.PendingConsolidation(source_index=1, target_index=2))
    source = {"same_index": 8, "source_out_of_range": 64}.get(case, source)
    target = {"target_out_of_range": 64}.get(case, target)
    if case == "source_inactive":
        state.validators[7].activation_epoch = FAR_FUTURE_EPOCH
    if case == "target_inactive":
        state.validators[8].activation_epoch = FAR_FUTURE_EPOCH
    if case == "source_exiting":
        state.validators[7].exit_epoch = 50
    if case == "target_exiting":
        state.validators[8].exit_epoch = 50
    if case == "future_epoch":
        epoch = 3
    if case == "source_no_execution":
        state.validators[7].withdrawal_credentials = chain_utils.withdrawal_credentials(7)
    if case == "target_no_execution":
        state.validators[8].withdrawal_credentials = chain_utils.withdrawal_credentials(8)
    if case == "address_mismatch":
        state.validators[8].withdrawal_credentials = _eth1_credentials(b"\x67" * 20)
    if case == "source_signature_only":
        signers = (7,)
    if case == "undecodable_key":
        state.validators[8].public_key = b"\xff" * 48
    signed = _signed_consolidation(state, ctx, source, target, epoch,
                                   signers if signers else (min(source, 63), min(target, 63)))
    port_state = _to_port(state)
    port_signed = _port_type("electra", "SignedConsolidation").deserialize(
        type(signed).serialize(signed))
    outs = _both(state, port_state,
                 lambda s: ref_electra.block_processing.process_consolidation(s, signed, ctx),
                 lambda s: port_ebp.process_consolidation(s, port_signed,
                                                          Context.for_minimal()))
    assert outs == ("InvalidConsolidation", "InvalidConsolidation")


def test_consolidation_lifecycle_matches_reference():
    state, ctx = _consolidation_state()
    port_state = _to_port(state)
    port_ctx = Context.for_minimal()
    signed = _signed_consolidation(state, ctx, 7, 8)
    port_signed = _port_type("electra", "SignedConsolidation").deserialize(
        type(signed).serialize(signed))
    ref_electra.block_processing.process_consolidation(state, signed, ctx)
    port_ebp.process_consolidation(port_state, port_signed, port_ctx)
    assert _same(port_state, state)
    assert len(port_state.pending_consolidations) == 1
    # once the source is withdrawable, the pending consolidation settles
    slot = int(state.validators[7].withdrawable_epoch) * int(ctx.SLOTS_PER_EPOCH)
    state.slot = port_state.slot = slot
    state.balances[8] = port_state.balances[8] = 40 * GWEI
    ref_electra.epoch_processing.process_pending_consolidations(state, ctx)
    port_electra.epoch_processing.process_pending_consolidations(port_state, port_ctx)
    assert _same(port_state, state)
    assert len(port_state.pending_consolidations) == 0
    assert bytes(port_state.validators[8].withdrawal_credentials)[:1] == b"\x02"
    assert int(port_state.pending_balance_deposits[-1].amount) == 8 * GWEI


# ---------------------------------------------------------------------------
# electra's withdrawals: pending partials first, then the sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sweep", ["registry_walk", "columns"])
def test_withdrawals_with_pending_partials_match_reference(sweep, monkeypatch):
    state, ctx = torch_genesis.fresh_genesis_electra(64, "minimal")
    ns = _ref_ns()
    ref_electra.slot_processing.process_slots(state, 2 * int(ctx.SLOTS_PER_EPOCH), ctx)
    for i in range(10, 16):
        state.validators[i].withdrawal_credentials = _compounding_credentials(bytes([i]) * 20)
        state.validators[i].effective_balance = 40 * GWEI
        state.balances[i] = 45 * GWEI
        state.pending_partial_withdrawals.append(ns.PendingPartialWithdrawal(
            index=i, amount=(i - 8) * GWEI, withdrawable_epoch=1 if i != 15 else 5))
    state.validators[11].exit_epoch = 30  # skipped, and still counted against the cap
    for i in (2, 3, 4):
        state.validators[i].withdrawal_credentials = _eth1_credentials(bytes([i]) * 20)
        state.balances[i] = 33 * GWEI
    _drop_caches(state)
    if sweep == "columns":
        monkeypatch.setattr(port_ebp, "WITHDRAWALS_VECTOR_MIN_VALIDATORS", 0)
    expected, partials = ref_electra.block_processing.get_expected_withdrawals(state, ctx)
    port_state = _to_port(state)
    port_ctx = Context.for_minimal()
    port_expected, port_partials = port_ebp.get_expected_withdrawals(port_state, port_ctx)
    assert partials == port_partials
    assert [type(w).serialize(w) for w in expected] == [type(w).serialize(w)
                                                      for w in port_expected]
    # 10 and 12 fill the cap of two (11 is exiting); the sweep follows
    assert partials == int(ctx.MAX_PENDING_PARTIALS_PER_WITHDRAWALS_SWEEP) == 2
    assert [int(w.validator_index) for w in expected] == [10, 12, 2, 3, 4][
        : int(ctx.MAX_WITHDRAWALS_PER_PAYLOAD)]
    payload = ns.ExecutionPayload(withdrawals=expected)
    port_payload = _port_type("electra", "ExecutionPayload").deserialize(
        ns.ExecutionPayload.serialize(payload))
    ref_electra.block_processing.process_withdrawals(state, payload, ctx)
    port_ebp.process_withdrawals(port_state, port_payload, port_ctx)
    assert _same(port_state, state)
    assert len(port_state.pending_partial_withdrawals) == 6 - partials
    # a changed withdrawal is refused on both
    payload.withdrawals[0].amount += 1
    port_payload.withdrawals[0].amount += 1
    assert _both(state, port_state,
                 lambda s: ref_electra.block_processing.process_withdrawals(s, payload, ctx),
                 lambda s: port_ebp.process_withdrawals(s, port_payload, port_ctx)) == (
        "InvalidWithdrawals", "InvalidWithdrawals")


# ---------------------------------------------------------------------------
# a signed block carrying every electra operation, through Executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tamper", [False, True])
def test_block_with_electra_operations_matches_reference(tamper):
    state, ctx = torch_genesis.fresh_genesis_electra(64, "minimal")
    ctx.shard_committee_period = 0  # the genesis validators may exit at once
    port_ctx = Context.for_minimal()
    port_ctx.shard_committee_period = 0
    ns = _ref_ns()
    addr = b"\x71" * 20
    for i in (7, 8, 9):
        state.validators[i].withdrawal_credentials = _eth1_credentials(addr)
    for v in state.validators:
        v.effective_balance = int(ctx.MIN_ACTIVATION_BALANCE) * 100
    _drop_caches(state)
    pre = type(state).serialize(state)
    scratch = state.copy()
    ref_electra.slot_processing.process_slots(scratch, 1, ctx)
    receipts = [_receipt(3, ctx, GWEI, 0), _receipt(100, ctx, 32 * GWEI, 1)]
    requests = [ns.ExecutionLayerWithdrawalRequest(
        source_address=addr, validator_public_key=chain_utils.public_key_bytes(9), amount=0)]
    consolidation = _signed_consolidation(scratch, ctx, 7, 8,
                                          signers=(7,) if tamper else None)
    if tamper:
        good = _signed_consolidation(scratch, ctx, 7, 8)
        block = chain_utils.produce_block_electra(scratch.copy(), 1, ctx, deposit_receipts=receipts,
                                                  withdrawal_requests=requests,
                                                  consolidations=[good])
        block.message.body.consolidations[0] = consolidation
        block.signature = chain_utils.sign_block(scratch, block.message, ctx)
    else:
        block = chain_utils.produce_block_electra(scratch.copy(), 1, ctx, deposit_receipts=receipts,
                                                  withdrawal_requests=requests,
                                                  consolidations=[consolidation])
    data = ns.SignedBeaconBlock.serialize(block)
    outs = []
    for executor, typ, bctx, error in (
            (ref_executor, ns, ctx, ref_error.Error),
            (port_executor, None, port_ctx, port_error.Error)):
        state_type = typ.BeaconState if typ else _port_type("electra", "BeaconState")
        block_type = typ.SignedBeaconBlock if typ else _port_type("electra", "SignedBeaconBlock")
        ex = executor.Executor(state_type.deserialize(pre), bctx)
        try:
            ex.apply_block(block_type.deserialize(data))
            outs.append((ex.state.serialize(), ex.state.hash_tree_root()))
        except error as exc:
            outs.append(type(exc).__name__)
    assert outs[1] == outs[0]
    if tamper:
        assert outs[1] == "InvalidConsolidation"
    else:
        post = _port_type("electra", "BeaconState").deserialize(outs[1][0])
        assert len(post.validators) == 65
        assert int(post.validators[9].exit_epoch) != FAR_FUTURE_EPOCH
        assert len(post.pending_consolidations) == 1
