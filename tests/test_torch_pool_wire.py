"""The port's write plane over HTTP (pool/handlers.py) against the reference.

Each package mounts ``BeaconDataPlane`` and ``PoolDataPlane`` on its own
``IntrospectionServer`` on localhost over the same head
(``tests/torch_pool.py``); every route of ``PoolDataPlane.ROUTES`` is asked
the same request of both, and the statuses and JSON documents (after
``sort_keys``) must be the same: the per-index failure envelope, the pool
views, ``GET /pool``'s counts and a block produced from the port's pool and
published through ``submit``. Then the reference's six spam lanes
(``scenarios/families.py build_pool_spam``) against every engine.
"""

import json
import urllib.error
import urllib.request

import pytest

import chain_utils as cu
from ethereum_consensus_tpu.domains import DomainType as RefDomainType
from ethereum_consensus_tpu.models.phase0 import helpers as ref_h
from ethereum_consensus_tpu.scenarios.families import POOL_SPAM_LANES, build_pool_spam
from ethereum_consensus_tpu.signing import compute_signing_root as ref_signing_root
from torch_pool import admit, chain, port_randao, port_sign, ser, sides
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

POOL = "/eth/v1/beacon/pool"


def _request(base: str, method: str, path: str, body=None) -> tuple:
    data = None if body is None else json.dumps(body).encode()
    request = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(request, timeout=60) as response:
            return response.status, json.loads(response.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


@pytest.fixture(params=[True, False], ids=["rlc", "scalar"])
def served(request):
    """(reference side, port side, their base URLs, engines) with both
    planes mounted on a server of each package; ``submit`` applies a block
    on a copy of the head and publishes it."""
    ref, port = sides("altair")
    saved = (ref.ctx.shard_committee_period, port.ctx.shard_committee_period)
    ref.ctx.shard_committee_period = port.ctx.shard_committee_period = 0
    servers, bases, engines = [], [], []
    try:
        for side in (ref, port):
            engine = side.engine(request.param, 4)
            publisher = side.executor_mod.Executor(side.executor.state.data.copy(), side.ctx)

            def submit(block, side=side, publisher=publisher):
                publisher.apply_block(block)
                side.store.publish(publisher.state, side.ctx)

            server = side.server.IntrospectionServer(port=0).start(start_flight=False)
            servers.append(server)
            server.mount(side.serving.BeaconDataPlane(side.store))
            server.mount(side.pool.PoolDataPlane(engine, submit=submit))
            bases.append(server.url("").rstrip("/"))
            engines.append(engine)
        yield ref, port, bases, engines
    finally:
        for server in servers:
            server.stop()
        ref.ctx.shard_committee_period, port.ctx.shard_committee_period = saved


def _ask_both(bases: list, method: str, path: str, body=None) -> tuple:
    answers = [_request(base, method, path, body) for base in bases]
    docs = [(status, json.dumps(doc, sort_keys=True)) for status, doc in answers]
    assert docs[0] == docs[1], (method, path, docs)
    return answers[1]


def _ops(ref) -> dict:
    """A valid exit (validator 7), proposer slashing (validator 5) and BLS
    change (refused on altair) as JSON."""
    head, ctx, ns = ref.executor.state.data, ref.ctx, ref.ns

    def sign(domain_type, epoch, typ, message, index):
        domain = ref_h.get_domain(head, domain_type, epoch, ctx)
        return cu.secret_key(index).sign(ref_signing_root(typ, message, domain)).to_bytes()

    exit_message = ns.VoluntaryExit(epoch=0, validator_index=7)
    signed_exit = ns.SignedVoluntaryExit(message=exit_message, signature=sign(
        RefDomainType.VOLUNTARY_EXIT, 0, ns.VoluntaryExit, exit_message, 7))
    headers = []
    for root in (b"\x0a" * 32, b"\x0b" * 32):
        header = ns.BeaconBlockHeader(slot=1, proposer_index=5, parent_root=b"\x01" * 32,
                                      state_root=b"\x02" * 32, body_root=root)
        headers.append(ns.SignedBeaconBlockHeader(message=header, signature=sign(
            RefDomainType.BEACON_PROPOSER, 0, ns.BeaconBlockHeader, header, 5)))
    slashing = ns.ProposerSlashing(signed_header_1=headers[0], signed_header_2=headers[1])
    change = {"message": {"validator_index": "3", "from_bls_public_key":
                          "0x" + cu.public_key_bytes(3).hex(),
                          "to_execution_address": "0x" + "03" * 20},
              "signature": "0x" + "00" * 96}
    return {"exit": type(signed_exit).to_json(signed_exit),
            "proposer_slashing": type(slashing).to_json(slashing), "bls_change": change}


def test_every_route_answers_alike(served):
    ref, port, bases, engines = served
    head = ref.executor.state.data
    traffic = [cu.make_attestation(head, slot, 0, ref.ctx, participation=p)
               for slot in (2, 3) for p in (0.5, 1.0)]
    as_json = [type(a).to_json(a) for a in traffic]
    evil = cu.make_attestation(head, 3, 0, ref.ctx, beacon_block_root=b"\x61" * 32)
    ops = _ops(ref)

    assert _ask_both(bases, "POST", f"{POOL}/attestations", as_json) == (
        200, {"data": {"admitted": "4"}})
    status, doc = _ask_both(bases, "GET", f"{POOL}/attestations")
    assert status == 200 and doc["data"] == [type(a).to_json(a) for a in
                                             engines[1].pool.attestations_view()]
    assert len(_ask_both(bases, "GET", f"{POOL}/attestations?slot=3&committee_index=0")[1][
        "data"]) == 2
    assert _ask_both(bases, "GET", f"{POOL}/attestations?committee_index=1")[1] == {"data": []}
    status, doc = _ask_both(bases, "POST", f"{POOL}/attestations",
                            [as_json[0], {"nonsense": "1"}])
    assert status == 400 and [f["message"] for f in doc["failures"]] == ["duplicate",
                                                                          "malformed"]
    assert _ask_both(bases, "POST", f"{POOL}/attestations", {"not": "a list"})[0] == 400
    assert _ask_both(bases, "POST", f"{POOL}/attestations", [type(evil).to_json(evil)])[0] == 200
    # the equivocation contradicts the votes of both slot-3 aggregates
    status, doc = _ask_both(bases, "GET", f"{POOL}/attester_slashings")
    assert status == 200 and len(doc["data"]) == 2
    status, doc = _ask_both(bases, "POST", f"{POOL}/attester_slashings", doc["data"][0])
    assert status == 400 and doc["failures"] == [{"index": "0", "message": "duplicate"}]

    assert _ask_both(bases, "POST", f"{POOL}/voluntary_exits", ops["exit"])[0] == 200
    assert _ask_both(bases, "POST", f"{POOL}/voluntary_exits", {"message": 1})[1][
        "failures"] == [{"index": "0", "message": "malformed"}]
    assert _ask_both(bases, "GET", f"{POOL}/voluntary_exits")[1] == {"data": [ops["exit"]]}
    assert _ask_both(bases, "POST", f"{POOL}/proposer_slashings",
                     ops["proposer_slashing"])[0] == 200
    assert _ask_both(bases, "GET", f"{POOL}/proposer_slashings")[1] == {
        "data": [ops["proposer_slashing"]]}
    status, doc = _ask_both(bases, "POST", f"{POOL}/bls_to_execution_changes",
                            [ops["bls_change"]])
    assert status == 400 and "not a altair type" in doc["message"]
    assert _ask_both(bases, "GET", f"{POOL}/bls_to_execution_changes") == (200, {"data": []})
    assert _ask_both(bases, "GET", f"{POOL}/unknown")[0] == 404
    assert _ask_both(bases, "GET", "/eth/v2/beacon/blocks")[0] == 404

    introspected = [_request(base, "GET", "/pool")[1] for base in bases]
    assert [(d["counts"], d["admission"]) for d in introspected] == [
        (introspected[0]["counts"], introspected[0]["admission"])] * 2
    assert introspected[1]["counts"]["attestation_rows"] == 5
    assert introspected[1]["counts"]["attester_slashings"] == 2

    # a block produced from the port's pool, published to both
    produced = port.pool.produce_block(port.store.head, engines[1].pool, port.ctx,
                                       randao=port_randao, sign=port_sign)
    body = produced.message.body
    assert (len(body.attester_slashings), len(body.proposer_slashings),
            len(body.voluntary_exits)) == (2, 1, 1) and len(body.attestations) >= 2
    block_json = type(produced).to_json(produced)
    assert _ask_both(bases, "POST", "/eth/v1/beacon/blocks", [1])[0] == 400
    assert _ask_both(bases, "POST", "/eth/v2/beacon/blocks", block_json) == (
        200, {"data": {"slot": str(int(produced.message.slot))}})
    root = "0x" + bytes(produced.message.state_root).hex()
    assert _ask_both(bases, "GET", "/eth/v1/beacon/states/head/root")[1]["data"]["root"] == root
    # a refused block leaves the head where it was (the refusals' texts are
    # each package's own)
    tampered = json.loads(json.dumps(block_json))
    tampered["message"]["state_root"] = "0x" + "13" * 32
    statuses = [_request(base, "POST", "/eth/v2/beacon/blocks", tampered)[0] for base in bases]
    assert statuses == [400, 400]
    assert _ask_both(bases, "GET", "/eth/v1/beacon/states/head/root")[1]["data"]["root"] == root


def test_spam_lanes_reject_with_their_reasons():
    """One message a lane after the honest twin, through every engine of
    both packages, then as one HTTP batch: each lane's declared reason."""
    ref, port = sides("altair")
    _ctx, blocks, _data = chain("altair")
    honest = cu.make_attestation(ref.executor.state.data, 3, 0, ref.ctx, participation=0.5)
    spam = build_pool_spam(honest, bytes(blocks[-1].signature))
    messages = [ser(honest)] + [ser(message) for _lane, _reason, message in spam]
    expected = [("admitted", None)] + [("rejected", reason) for _lane, reason in POOL_SPAM_LANES]
    deltas = {}
    for side in (ref, port):
        for rlc in (True, False):
            engine, tickets, deltas[side.name, rlc] = admit(side, "attestation", messages, rlc, 3)
            assert tickets == expected, (side.name, rlc)
    assert len({json.dumps(d, sort_keys=True) for d in deltas.values()}) == 1
    assert sum(deltas["port", True].values()) == len(POOL_SPAM_LANES)

    docs = []
    for side in (ref, port):
        server = side.server.IntrospectionServer(port=0).start(start_flight=False)
        try:
            server.mount(side.pool.PoolDataPlane(side.engine(True, 64)))
            docs.append(_request(server.url("").rstrip("/"), "POST", f"{POOL}/attestations",
                                 [type(honest).to_json(honest)]
                                 + [type(m).to_json(m) for _l, _r, m in spam]))
        finally:
            server.stop()
    assert docs[0] == docs[1]
    assert docs[1][0] == 400 and [f["message"] for f in docs[1][1]["failures"]] == [
        reason for _lane, reason in POOL_SPAM_LANES]
