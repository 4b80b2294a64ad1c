"""The port's operation pool (pool/) against the reference.

The same serialized messages go to the reference's engines and the port's,
RLC and scalar, on heads both packages read from the same bytes
(``tests/torch_pool.py``): identical ``(status, reason)`` lists,
``pool.rejected.*`` counter deltas, served views, selections, surfaced
slashings and produced blocks' bytes. The store's bitfield rows and the
selection are held against the reference's on randomized traffic.
"""

import json
import random

import numpy as np
import pytest

import chain_utils as cu
from ethereum_consensus_tpu.domains import DomainType as RefDomainType
from ethereum_consensus_tpu.models.phase0 import helpers as ref_h
from ethereum_consensus_tpu.pool import AggregateGroup as RefGroup
from ethereum_consensus_tpu.pool import select_aggregates as ref_select
from ethereum_consensus_tpu.pool.store import bits_to_int as ref_bits_to_int
from ethereum_consensus_tpu.pool.store import pack_bits as ref_pack_bits
from ethereum_consensus_tpu.signing import compute_signing_root as ref_signing_root
from ethereum_consensus_tpu_torch.domains import DomainType
from ethereum_consensus_tpu_torch.models.phase0 import helpers as port_h
from ethereum_consensus_tpu_torch.pool import AggregateGroup, OperationPool, produce_block
from ethereum_consensus_tpu_torch.pool import admission as port_admission
from ethereum_consensus_tpu_torch.pool import select_aggregates
from ethereum_consensus_tpu_torch.pool.store import bits_to_int, pack_bits
from ethereum_consensus_tpu_torch.signing import compute_signing_root
from torch_pool import admit, chain, port_randao, port_sign, ser, sides, view_doc
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ENGINES = (True, False)  # rlc, then the scalar twin


def _traffic(side, slots=(2, 3), participations=(0.5, 1.0)) -> list:
    """Gossip-shaped aggregates on the reference head, serialized."""
    head = side.executor.state.data
    return [ser(cu.make_attestation(head, slot, 0, side.ctx, participation=p))
            for slot in slots for p in participations]


def _both(ref, port, kind, messages, window=64) -> dict:
    """Every engine of both packages on ``messages``: (side, rlc) ->
    (tickets, rejection deltas, view, engine)."""
    out = {}
    for side in (ref, port):
        for rlc in ENGINES:
            engine, tickets, deltas = admit(side, kind, messages, rlc, window)
            assert engine.rlc is rlc
            out[side.name, rlc] = (tickets, deltas, view_doc(engine.pool), engine)
    return out


def _same(out: dict, what: int = 0):
    values = {key: value[what] for key, value in out.items()}
    first = values[("ref", True)]
    assert all(v == first for v in values.values()), values
    return first


# ---------------------------------------------------------------------------
# the bitfield store and the selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 7, 64, 65, 130, 513])
def test_pack_bits_matches_int_masks(width):
    bits = [random.Random(width).random() < 0.4 for _ in range(width)]
    packed = pack_bits(bits)
    assert packed.dtype == np.uint64
    assert packed.tobytes() == ref_pack_bits(bits).tobytes()
    as_int = sum(int(word) << (64 * w) for w, word in enumerate(packed.tolist()))
    assert as_int == bits_to_int(bits) == ref_bits_to_int(bits)


@pytest.mark.parametrize("width", [8, 64, 100])
def test_group_classify_against_the_reference(width):
    rng = random.Random(0x5E1 + width)
    group, twin, ref = (AggregateGroup(1, 0, b"\x00" * 32, width),
                        AggregateGroup(1, 0, b"\x00" * 32, width),
                        RefGroup(1, 0, b"\x00" * 32, width))
    for step in range(40):
        bits = [rng.random() < 0.5 for _ in range(width)]
        bits[0] = bits[0] or not any(bits)
        if step % 7 == 6 and group.n:  # a held row, and a subset of one
            bits = list(group.attestations[group.n - 1])
            if step % 14 == 13:
                bits[bits.index(True)] = False
        verdict = group.classify(bits)
        assert verdict == twin.classify(bits, scalar=True) == ref.classify(bits), step
        if verdict == "new":
            for g in (group, twin, ref):
                g.insert(bits, b"\xaa", list(bits))
    assert group.n == twin.n == ref.n
    assert group.bits[: group.n].tobytes() == ref.bits[: ref.n].tobytes()


def _random_groups(seed: int, make) -> list:
    rng = random.Random(seed)
    groups = []
    for g in range(rng.randint(2, 6)):
        width = rng.choice((8, 63, 64, 65, 120))
        group = make(g + 1, g % 3, bytes([g]) * 32, width)
        for _ in range(rng.randint(1, 12)):
            bits = [rng.random() < rng.uniform(0.2, 0.9) for _ in range(width)]
            bits[0] = bits[0] or not any(bits)
            if group.classify(bits) == "new":
                group.insert(bits, b"\xbb", None)
        groups.append(group)
    return groups


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_selection_differential_randomized(seed):
    """Vectorized and scalar greedy packing pick the same rows in the same
    order as the reference's, over random multi-group pools."""
    groups = _random_groups(seed, AggregateGroup)
    ref_groups = _random_groups(seed, RefGroup)
    for cap in (1, 3, 128):
        picks = [(groups.index(g), r) for g, r in select_aggregates(groups, cap)]
        scalar = [(groups.index(g), r) for g, r in select_aggregates(groups, cap, scalar=True)]
        ref = [(ref_groups.index(g), r) for g, r in ref_select(ref_groups, cap)]
        assert picks == scalar == ref, (seed, cap)


def test_selection_greedy_skips_redundant_rows():
    group = AggregateGroup(1, 0, b"\x01" * 32, 8)
    for bits in ([1, 1, 0, 0, 0, 0, 0, 0], [1, 1, 1, 1, 1, 0, 0, 0], [0, 0, 0, 0, 0, 1, 1, 1]):
        group.insert([bool(b) for b in bits], b"s", None)
    assert [r for _, r in select_aggregates([group], 10)] == [1, 2]
    assert [r for _, r in select_aggregates([group], 10, scalar=True)] == [1, 2]


# ---------------------------------------------------------------------------
# admission: window geometries, blame, the fast path, no head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [1, 3, 64])
def test_admission_window_geometry(window):
    """One flush per full window and one for the rest, in both packages;
    every engine admits everything and serves the same view."""
    ref, port = sides("altair")
    traffic = _traffic(ref)
    flushes = {}
    out = {}
    for side in (ref, port):
        for rlc in ENGINES:
            before = side.metrics.counter("pool.flushes").value()
            engine, tickets, deltas = admit(side, "attestation", traffic, rlc, window)
            flushes[side.name, rlc] = side.metrics.counter("pool.flushes").value() - before
            out[side.name, rlc] = (tickets, deltas, view_doc(engine.pool))
    expected = len(traffic) // window + (1 if len(traffic) % window else 0)
    assert flushes == {("ref", True): expected, ("port", True): expected,
                       ("ref", False): 0, ("port", False): 0}
    assert _same(out) == [("admitted", None)] * len(traffic)
    assert _same(out, 1) == {}
    assert len(json.loads(_same(out, 2))) == len(traffic)


def test_rlc_split_blames_only_the_bad_signature():
    """A valid point over the wrong message in a window of good aggregates:
    the fused set fails, the split re-verifies its members, only the
    offender rejects — in both packages, as the scalar twins."""
    ref, port = sides("altair")
    _ctx, blocks, _data = chain("altair")
    head = ref.executor.state.data
    bad = cu.make_attestation(head, 2, 0, ref.ctx)
    bad.signature = bytes(blocks[-1].signature)
    traffic = [ser(cu.make_attestation(head, 3, 0, ref.ctx, participation=0.5)), ser(bad),
               ser(cu.make_attestation(head, 3, 0, ref.ctx, participation=1.0))]
    splits = {s.name: s.metrics.counter("pool.flush_splits").value() for s in (ref, port)}
    out = _both(ref, port, "attestation", traffic, window=3)
    assert _same(out) == [("admitted", None), ("rejected", "signature"), ("admitted", None)]
    assert _same(out, 1) == {"pool.rejected.signature": 1}
    _same(out, 2)
    for side in (ref, port):
        assert side.metrics.counter("pool.flush_splits").value() == splits[side.name] + 1


def test_signing_root_fast_path_matches_spec():
    """hash(data_root || domain) is compute_signing_root over SigningData,
    in the port as in the reference."""
    ref, port = sides("altair")
    att = cu.make_attestation(ref.executor.state.data, 3, 0, ref.ctx)
    port_att = port.load("Attestation", ser(att))
    raw = port.executor.state.data
    data = port_att.data
    domain = bytes(port_h.get_domain(raw, DomainType.BEACON_ATTESTER,
                                     int(data.target.epoch), port.ctx))
    fast = port_admission._sha256(bytes(type(data).hash_tree_root(data)) + domain)
    ref_domain = bytes(ref_h.get_domain(ref.executor.state.data, RefDomainType.BEACON_ATTESTER,
                                        int(att.data.target.epoch), ref.ctx))
    assert domain == ref_domain
    assert fast == bytes(compute_signing_root(type(data), data, domain)) == bytes(
        ref_signing_root(type(att.data), att.data, ref_domain))


def test_rlc_off_selects_the_scalar_twin(monkeypatch):
    """``ECT_POOL_RLC=off`` makes the default engine the scalar twin and
    an explicit RLC request fall back, counted, in both packages."""
    ref, port = sides("altair")
    monkeypatch.setenv("ECT_POOL_RLC", "off")
    for side in (ref, port):
        fallback = side.metrics.counter("pool.fallback.no_native")
        before = fallback.value()
        default = side.pool.AdmissionEngine(side.pool.OperationPool(), side.store, side.ctx)
        asked = side.engine(True)
        assert (default.rlc, asked.rlc, fallback.value() - before) == (False, False, 1)
        assert asked.snapshot() == {"rlc": False, "window_size": 64, "window_pending": 0,
                                    "inflight_windows": 0}


@pytest.mark.parametrize("rlc", ENGINES)
def test_no_head_rejection(rlc):
    ref, port = sides("altair")
    message = _traffic(ref, slots=(2,), participations=(1.0,))[0]
    outcomes = []
    for side in (ref, port):
        engine = side.pool.AdmissionEngine(side.pool.OperationPool(),
                                           side.serving.HeadStore(), side.ctx, rlc=rlc)
        _engine, tickets, deltas = admit(side, "attestation", [message], rlc, engine=engine)
        outcomes.append((tickets, deltas))
    assert outcomes[0] == outcomes[1] == ([("rejected", "no_head")],
                                          {"pool.rejected.no_head": 1})


# ---------------------------------------------------------------------------
# singleton ops: exits, proposer and attester slashings, BLS changes
# ---------------------------------------------------------------------------


def _sign(head, ctx, domain_type, epoch, typ, message, index) -> bytes:
    domain = ref_h.get_domain(head, domain_type, epoch, ctx)
    return cu.secret_key(index).sign(ref_signing_root(typ, message, domain)).to_bytes()


def _ops_both(ref, port, kind, messages, then=(), window=4) -> dict:
    """``messages`` in one window, then ``then`` on the same engine after
    the settle (a duplicate in the same window meets the scratch the first
    copy already changed, so it reads ``invalid`` on the RLC engine, in
    both packages)."""
    out = _both(ref, port, kind, messages, window)
    by_name = {"ref": ref, "port": port}
    result = {}
    for (name, rlc), (tickets, deltas, _view, engine) in out.items():
        _engine, more, more_deltas = admit(by_name[name], kind, list(then), rlc, engine=engine)
        for k, v in more_deltas.items():
            deltas[k] = deltas.get(k, 0) + v
        result[name, rlc] = (tickets + more, deltas, _held(kind, engine.pool))
    return result


def _held(kind: str, pool) -> list:
    reader = {"voluntary_exit": pool.voluntary_exits,
              "proposer_slashing": pool.proposer_slashings,
              "attester_slashing": pool.attester_slashings,
              "bls_change": pool.bls_changes}[kind]
    return [ser(op) for op in reader()]


def test_voluntary_exits_valid_refused_and_duplicate():
    ref, port = sides("altair")
    head, ctx, ns = ref.executor.state.data, ref.ctx, ref.ns
    saved = (ctx.shard_committee_period, port.ctx.shard_committee_period)
    ctx.shard_committee_period = port.ctx.shard_committee_period = 0
    try:
        message = ns.VoluntaryExit(epoch=0, validator_index=7)
        signed = ns.SignedVoluntaryExit(message=message, signature=_sign(
            head, ctx, RefDomainType.VOLUNTARY_EXIT, 0, ns.VoluntaryExit, message, 7))
        bogus = ns.SignedVoluntaryExit(message=ns.VoluntaryExit(epoch=0, validator_index=2**31),
                                       signature=signed.signature)
        forged = ns.SignedVoluntaryExit(message=ns.VoluntaryExit(epoch=0, validator_index=8),
                                        signature=signed.signature)
        out = _ops_both(ref, port, "voluntary_exit", [ser(signed), ser(bogus), ser(forged)],
                        then=[ser(signed)])
    finally:
        ctx.shard_committee_period, port.ctx.shard_committee_period = saved
    assert _same(out) == [("admitted", None), ("rejected", "invalid"),
                          ("rejected", "signature"), ("rejected", "duplicate")]
    assert _same(out, 1) == {"pool.rejected.invalid": 1, "pool.rejected.signature": 1,
                             "pool.rejected.duplicate": 1}
    assert _same(out, 2) == [ser(signed)]


def _proposer_slashing(ref, index: int, root_a: bytes, root_b: bytes, signer=None):
    head, ctx, ns = ref.executor.state.data, ref.ctx, ref.ns
    halves = []
    for root in (root_a, root_b):
        header = ns.BeaconBlockHeader(slot=1, proposer_index=index, parent_root=b"\x01" * 32,
                                      state_root=b"\x02" * 32, body_root=root)
        halves.append(ns.SignedBeaconBlockHeader(message=header, signature=_sign(
            head, ctx, RefDomainType.BEACON_PROPOSER, 0, ns.BeaconBlockHeader, header,
            index if signer is None else signer)))
    return ns.ProposerSlashing(signed_header_1=halves[0], signed_header_2=halves[1])


def test_proposer_slashings_valid_refused_and_duplicate():
    ref, port = sides("altair")
    valid = _proposer_slashing(ref, 5, b"\x0a" * 32, b"\x0b" * 32)
    same_headers = _proposer_slashing(ref, 6, b"\x0a" * 32, b"\x0a" * 32)
    wrong_key = _proposer_slashing(ref, 9, b"\x0a" * 32, b"\x0b" * 32, signer=10)
    out = _ops_both(ref, port, "proposer_slashing",
                    [ser(valid), ser(same_headers), ser(wrong_key)], then=[ser(valid)])
    assert _same(out) == [("admitted", None), ("rejected", "invalid"),
                          ("rejected", "signature"), ("rejected", "duplicate")]
    assert _same(out, 2) == [ser(valid)]


def test_double_votes_surface_slashings_that_admit():
    """An honest aggregate and a signed equivocation of the same committee:
    both admit and the ledger surfaces one AttesterSlashing, the same bytes
    and ledger digest in every engine; posted again it is a duplicate, a
    fresh pool admits it, and a tampered copy fails its signature."""
    ref, port = sides("altair")
    head = ref.executor.state.data
    honest = cu.make_attestation(head, 3, 0, ref.ctx)
    evil = cu.make_attestation(head, 3, 0, ref.ctx, beacon_block_root=b"\x61" * 32)
    out = _both(ref, port, "attestation", [ser(honest), ser(evil)], window=2)
    assert _same(out) == [("admitted", None)] * 2
    surfaced = {key: [ser(s) for s in engine.pool.attester_slashings()]
                for key, (*_, engine) in out.items()}
    digests = {key: engine.pool.vote_ledger_digest() for key, (*_, engine) in out.items()}
    assert len(set(map(tuple, surfaced.values()))) == 1 and len(surfaced["ref", True]) == 1
    assert all(d == digests["ref", True] for d in digests.values())
    slashing = ref.load("AttesterSlashing", surfaced["ref", True][0])
    tampered = slashing.copy()
    tampered.attestation_2.signature = bytes(slashing.attestation_1.signature)
    not_slashable = slashing.copy()
    not_slashable.attestation_2 = slashing.attestation_1.copy()
    for side in (ref, port):
        engine = out[side.name, True][3]
        _engine, tickets, _deltas = admit(side, "attester_slashing", [ser(slashing)], True,
                                          engine=engine)
        assert tickets == [("rejected", "duplicate")]
    fresh = _ops_both(ref, port, "attester_slashing", [ser(slashing), ser(not_slashable)])
    assert _same(fresh) == [("admitted", None), ("rejected", "invalid")]
    assert _same(fresh, 2) == [ser(slashing)]
    # the scratch slashes whatever the verdict, so the forgery gets a pool
    # of its own
    forged = _ops_both(ref, port, "attester_slashing", [ser(tampered)])
    assert _same(forged) == [("rejected", "signature")]
    assert _same(forged, 2) == []


def _bls_change(ref, index: int, key_of=None, sign_with=None):
    head, ctx, ns = ref.executor.state.data, ref.ctx, ref.ns
    message = ns.BlsToExecutionChange(
        validator_index=index,
        from_bls_public_key=cu.public_key_bytes(index if key_of is None else key_of),
        to_execution_address=bytes([index]) * 20)
    domain = ref_h.compute_domain(RefDomainType.BLS_TO_EXECUTION_CHANGE, None,
                                  bytes(head.genesis_validators_root), ctx)
    key = cu.secret_key(index if sign_with is None else sign_with)
    return ns.SignedBlsToExecutionChange(
        message=message, signature=key.sign(ref_signing_root(type(message), message,
                                                              domain)).to_bytes())


def test_bls_changes_valid_refused_and_duplicate():
    ref, port = sides("deneb", n_blocks=2)
    valid = _bls_change(ref, 3)
    other_key = _bls_change(ref, 4, key_of=5, sign_with=5)
    bad_signature = _bls_change(ref, 6, sign_with=7)
    out = _ops_both(ref, port, "bls_change",
                    [ser(valid), ser(other_key), ser(bad_signature)], then=[ser(valid)])
    assert _same(out) == [("admitted", None), ("rejected", "invalid"),
                          ("rejected", "signature"), ("rejected", "duplicate")]
    assert _same(out, 2) == [ser(valid)]


def test_bls_change_before_capella_is_invalid():
    """An altair head has no processor for the change: ``invalid``."""
    deneb, _ = sides("deneb", n_blocks=2)
    message = ser(_bls_change(deneb, 3))
    ref, port = sides("altair")
    outcomes = []
    for side in (ref, port):
        engine = side.engine(True, 4)
        before = side.counters()
        ticket = engine.admit_bls_change(deneb.ns.SignedBlsToExecutionChange.deserialize(message))
        engine.settle()
        outcomes.append(((ticket.status, ticket.reason),
                         {k: v - before[k] for k, v in side.counters().items() if v != before[k]}))
    assert outcomes[0] == outcomes[1] == (("rejected", "invalid"), {"pool.rejected.invalid": 1})


def test_electra_committee_bits_attestation():
    """EIP-7549 aggregates admit through every engine with one view."""
    ref, port = sides("electra", n_blocks=2, atts_per_block=0)
    att = cu.make_attestation_electra(ref.executor.state.data, 2, ref.ctx)
    out = _both(ref, port, "attestation", [ser(att)], window=2)
    assert _same(out) == [("admitted", None)]
    assert json.loads(_same(out, 2)) == [type(att).to_json(att)]


# ---------------------------------------------------------------------------
# the equivocation ledger
# ---------------------------------------------------------------------------


def _votes(side):
    spe = int(side.ctx.SLOTS_PER_EPOCH)

    def vote(source_epoch: int, target_epoch: int, tag: int):
        data = side.ns.AttestationData(
            slot=target_epoch * spe, index=0, beacon_block_root=bytes([tag]) * 32,
            source=side.ns.Checkpoint(epoch=source_epoch, root=b"\x01" * 32),
            target=side.ns.Checkpoint(epoch=target_epoch, root=b"\x02" * 32))
        return data, bytes(type(data).hash_tree_root(data))
    return vote


@pytest.mark.parametrize("order", ["outer_first", "inner_first"])
def test_surround_votes_surface_slashings(order):
    """Either surround direction surfaces one AttesterSlashing with the
    surrounding vote as attestation_1, the same bytes in both packages."""
    ref, port = sides("altair")
    found = []
    for side in (ref, port):
        vote = _votes(side)
        pool = side.pool.OperationPool()
        outer, inner = vote(0, 3, 0x11), vote(1, 2, 0x22)
        first, second = (outer, inner) if order == "outer_first" else (inner, outer)
        assert pool.note_votes([1, 2, 3], *first, b"\x0a" * 96, side.ns) == []
        surfaced = pool.note_votes([2, 3, 4], *second, b"\x0b" * 96, side.ns)
        assert len(surfaced) == 1 and int(surfaced[0].attestation_1.data.target.epoch) == 3
        assert pool.note_votes([2, 3, 4], *second, b"\x0b" * 96, side.ns) == []
        found.append((ser(surfaced[0]), pool.vote_ledger_digest()))
    assert found[0] == found[1]
    slashing = port.load("AttesterSlashing", found[1][0])
    assert port_h.is_slashable_attestation_data(slashing.attestation_1.data,
                                                slashing.attestation_2.data)


def test_non_overlapping_votes_and_the_digest():
    """Chained spans and other validators surface nothing; the digest does
    not depend on the order the votes came in."""
    ref, port = sides("altair")
    digests = []
    for side in (ref, port):
        vote = _votes(side)
        pool = side.pool.OperationPool()
        assert pool.note_votes([1, 2], *vote(0, 2, 0x31), b"\x0c" * 96, side.ns) == []
        assert pool.note_votes([1, 2], *vote(2, 3, 0x32), b"\x0d" * 96, side.ns) == []
        assert pool.note_votes([8, 9], *vote(0, 3, 0x33), b"\x0e" * 96, side.ns) == []
        assert pool.attester_slashings() == [] and len(pool.vote_ledger_digest()) == 6
        reordered = side.pool.OperationPool()
        reordered.note_votes([9, 8], *vote(0, 3, 0x33), b"\x0e" * 96, side.ns)
        reordered.note_votes([2, 1], *vote(2, 3, 0x32), b"\x0d" * 96, side.ns)
        reordered.note_votes([1, 2], *vote(0, 2, 0x31), b"\x0c" * 96, side.ns)
        assert reordered.vote_ledger_digest() == pool.vote_ledger_digest()
        digests.append(pool.vote_ledger_digest())
    assert digests[0] == digests[1]


# ---------------------------------------------------------------------------
# production and pruning
# ---------------------------------------------------------------------------


def _produce(side, pool, scalar: bool, **kwargs):
    """``side``'s produce_block on its head with its package's key callbacks."""
    randao, sign = ((cu.make_randao_reveal, cu.sign_block) if side.name == "ref"
                    else (port_randao, port_sign))
    return side.pool.produce_block(side.store.head, pool, side.ctx, randao=randao, sign=sign,
                                   scalar_selection=scalar, **kwargs)


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_produce_block_identical_bytes(fork):
    """Each package's pool drains into the same signed block, vectorized
    and scalar, and the port's Executor applies it."""
    ref, port = sides(fork)
    out = _both(ref, port, "attestation", _traffic(ref), window=4)
    by_name = {"ref": ref, "port": port}
    produced = {(name, rlc): ser(_produce(by_name[name], engine.pool, scalar=not rlc))
                for (name, rlc), (*_, engine) in out.items()}
    assert len(set(produced.values())) == 1
    block = port.load("SignedBeaconBlock", produced["port", True])
    assert len(block.message.body.attestations) >= 2
    port.executor_mod.Executor(port.executor.state.data.copy(), port.ctx).apply_block(block)


def test_produce_block_deneb_with_payload_extras():
    ref, port = sides("deneb", n_blocks=2)
    captured = {}

    def ref_extras(state, slot, context):
        payload = cu.make_execution_payload_fork("deneb", state, context, block_number=slot)
        sync = cu.make_sync_aggregate(state, context)
        captured.update(payload=ser(payload), sync=ser(sync))
        return {"execution_payload": payload, "sync_aggregate": sync}

    def port_extras(state, slot, context):
        return {"execution_payload": port.load("ExecutionPayload", captured["payload"]),
                "sync_aggregate": port.load("SyncAggregate", captured["sync"])}

    message = _traffic(ref, slots=(2,), participations=(1.0,))
    blocks = []
    for side, extras in ((ref, ref_extras), (port, port_extras)):
        engine, tickets, _ = admit(side, "attestation", message, True, 2)
        assert tickets == [("admitted", None)]
        blocks.append(ser(_produce(side, engine.pool, False, body_extras=extras)))
    assert blocks[0] == blocks[1]
    block = port.load("SignedBeaconBlock", blocks[1])
    assert len(block.message.body.attestations) == 1
    port.executor_mod.Executor(port.executor.state.data.copy(), port.ctx).apply_block(block)


def test_prune_included_and_expired():
    ref, port = sides("altair")
    counts = []
    for side in (ref, port):
        engine, _tickets, _ = admit(side, "attestation", _traffic(ref), True, 2)
        pool = engine.pool
        assert pool.counts()["attestation_groups"] == 2
        pool.prune_included(_produce(side, pool, False).message.body)
        after_included = pool.counts()
        admit(side, "attestation", _traffic(ref, slots=(2,)), True, 2, engine=engine)
        spe = int(side.ctx.SLOTS_PER_EPOCH)
        counts.append((after_included, pool.prune_expired(2 + spe + 1, spe), pool.counts()))
    assert counts[0] == counts[1]
    assert counts[1][0]["attestation_groups"] == 0 and counts[1][1] == 1
    assert counts[1][2]["attestation_groups"] == 0


def test_memory_census_of_the_pool():
    """The store's own census: the packed rows' full capacity, signatures,
    scalar rows and the ledger's records, as the reference counts them."""
    ref, port = sides("altair")
    census = []
    for side in (ref, port):
        engine, _tickets, _ = admit(side, "attestation", _traffic(ref), True, 4)
        census.append(engine.pool.memory_census())
    assert census[0] == census[1] and census[1][1] == 4
    assert OperationPool().memory_census() == (0, 0)

