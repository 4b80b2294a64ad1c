"""Spans, phases and the trace plane of the port (telemetry/spans.py,
telemetry/phases.py, utils/trace.py) against the reference.

A minimal phase0 chain across an epoch boundary is built with the reference
and applied by both packages' ``Executor`` with spans recording and the
device observatories on: the same span names with the same nesting, the
same ``phases.attribution`` keys (whose buckets add up to the applies), and
the same routing journal wherever both take the same route. The port's
device route (``ops.install(device="cpu")``) journals what the reference's
host route does, with its deliberate divergences named. Then the Chrome
export's shape, the ``device`` lane, ring drops, the causal handoff, and the
off path's cost counted as calls into the recorder.
"""

import collections
import json

import pytest

import chain_utils
import torch_genesis
from ethereum_consensus_tpu import executor as ref_executor
from ethereum_consensus_tpu.models.phase0 import containers as ref_containers
from ethereum_consensus_tpu.telemetry import device as ref_device
from ethereum_consensus_tpu.telemetry import phases as ref_phases
from ethereum_consensus_tpu.telemetry import spans as ref_spans
from ethereum_consensus_tpu_torch import executor as port_executor
from ethereum_consensus_tpu_torch import ops
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.models.phase0 import containers as port_containers
from ethereum_consensus_tpu_torch.telemetry import device, memory, phases, spans
from ethereum_consensus_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N_BLOCKS = 9  # minimal SLOTS_PER_EPOCH = 8: the last block crosses a boundary


@pytest.fixture(scope="module")
def chain():
    state, ctx = torch_genesis.fresh_genesis(64, "minimal")
    blocks = chain_utils.produce_chain(state, ctx, N_BLOCKS, "phase0", atts_per_block=2)
    ns = ref_containers.build(ctx.preset)
    return ns.BeaconState.serialize(state), [ns.SignedBeaconBlock.serialize(b) for b in blocks]


@pytest.fixture(autouse=True)
def _telemetry_off_between_tests():
    yield
    for rec in (spans.RECORDER, ref_spans.RECORDER):
        if rec.enabled:
            rec.stop()
    device.stop()
    ref_device.stop()
    memory.stop()
    ops.uninstall()


def _ref_run(chain):
    state_bytes, block_bytes = chain
    ctx = chain_utils.Context.for_minimal()
    ns = ref_containers.build(ctx.preset)
    ex = ref_executor.Executor(ns.BeaconState.deserialize(state_bytes), ctx)
    blocks = [ns.SignedBeaconBlock.deserialize(b) for b in block_bytes]
    with ref_spans.recording() as rec, ref_device.observing() as obs:
        for block in blocks:
            ex.apply_block(block)
    return ex.state.hash_tree_root(), rec.records(), obs.routes()


def _port_run(chain):
    state_bytes, block_bytes = chain
    ctx = Context.for_minimal()
    ns = port_containers.build(ctx.preset)
    ex = port_executor.Executor(ns.BeaconState.deserialize(state_bytes), ctx)
    blocks = [ns.SignedBeaconBlock.deserialize(b) for b in block_bytes]
    with spans.recording() as rec, device.observing() as obs:
        for block in blocks:
            ex.apply_block(block)
    return ex.state.hash_tree_root(), rec.records(), obs.routes()


@pytest.fixture(scope="module")
def runs(chain):
    ops.uninstall()
    return _ref_run(chain), _port_run(chain)


def _nesting(records) -> collections.Counter:
    by_id = {r.span_id: r for r in records}
    return collections.Counter(
        (r.name, by_id[r.parent_id].name if r.parent_id in by_id else None) for r in records
    )


def _journal(routes) -> list:
    return [(r["kind"], r["choice"], r["reason"], r["inputs"]) for r in routes]


def test_same_root_span_names_and_nesting(runs):
    (ref_root, ref_records, _), (port_root, port_records, _) = runs
    assert port_root == ref_root
    assert _nesting(port_records) == _nesting(ref_records)
    names = {r.name for r in port_records}
    assert {"executor.apply_block", "transition.slot_advance", "transition.block",
            "transition.state_htr", "transition.committees", "transition.sig_batch",
            "transition.operations", "transition.process_epoch"} <= names


def test_phase_attribution_keys_and_buckets_add_up(runs):
    (_, ref_records, _), (_, port_records, _) = runs
    got = phases.attribution(port_records)
    assert set(got) == set(ref_phases.attribution(ref_records))
    total = got["slot_advance_s"] + got["block_apply_s"]
    parts = got["sig_batch_s"] + got["state_htr_s"] + got["committee_s"] + got["operations_s"]
    assert total > 0 and abs(total - parts) <= 5e-4  # four roundings of 1e-4
    assert 0 < got["state_htr_in_slot_advance_s"] <= got["state_htr_s"]
    report = phases.hot_sweep_report(port_records)
    assert report == ref_phases.hot_sweep_report(ref_records)


def test_route_journal_equals_reference_on_the_host_route(runs):
    (_, _, ref_routes), (_, _, port_routes) = runs
    assert _journal(port_routes) == _journal(ref_routes)
    kinds = {r["kind"] for r in port_routes}
    assert {"pairing", "pairing_gate", "bls_agg", "shuffle", "sweeps", "epoch_vector"} <= kinds


def test_port_device_route_journal(chain, monkeypatch):
    """On the port's device route (the kernels' plain versions on the CPU,
    every gate installed) against the reference's host route: the engine's
    declines are the same entries, and the routed gates see the same
    inputs in the same order, journaled ``device``/``routed`` (the
    shuffle's consults are the cache misses of each route, so only their
    verdict is held). The port's one divergence, a failing kernel raising
    where the reference declines to the host, shows as no ``bls_device``
    entry here (see test_torch_device_observatory)."""
    from ethereum_consensus_tpu_torch.ssz import hash as port_hash

    ref_root, _, ref_routes = _ref_run(chain)
    monkeypatch.setattr(port_hash, "DEVICE_MIN_NODES", 256)
    monkeypatch.setattr(port_hash, "_device_hasher", None)
    ops.install(device="cpu", shuffle_min_n=1, bls_agg_min_n=1)
    port_root, _, port_routes = _port_run(chain)
    assert port_root == ref_root

    def of(routes, kinds):
        return [e for e in _journal(routes) if e[0] in kinds]

    engine = {"epoch_vector", "committees", "ops_vector"}
    assert of(port_routes, engine) == of(ref_routes, engine)
    for kind in ("bls_agg", "pairing", "pairing_gate", "sweeps"):
        inputs = [{k: v for k, v in e[3].items() if k != "threshold"}
                  for e in of(port_routes, {kind})]
        assert inputs == [{k: v for k, v in e[3].items() if k != "threshold"}
                          for e in of(ref_routes, {kind})], kind
    assert {e[1:3] for e in of(port_routes, {"bls_agg", "shuffle"})} == {("device", "routed")}
    assert {e[1:3] for e in of(port_routes, {"pairing", "pairing_gate", "sweeps"})} == {
        ("host", "below_threshold")}
    assert not any(r["kind"] == "bls_device" for r in port_routes)


def test_chrome_trace_shape_device_lane_and_drops():
    spans.start_recording(capacity=8)
    device.start()
    try:
        for i in range(12):
            with trace.span("test.outer", i=i):
                with trace.span("test.inner"):
                    pass
        trace.event("test.point", k=1)
        import numpy as np

        device.d2h("test.site", device.h2d("test.site", np.arange(4, dtype=np.uint64),
                                           device="cpu"))
        doc = spans.RECORDER.chrome_trace()
        audit = spans.RECORDER.audit()
    finally:
        device.stop()
        spans.stop_recording()
    json.dumps(doc)
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    events = doc["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    assert meta[0]["args"]["name"] == "ethereum_consensus_tpu_torch"
    lanes = {e["args"]["name"]: e["tid"] for e in meta if e["name"] == "thread_name"}
    assert "device" in lanes
    complete = [e for e in events if e["ph"] == "X"]
    assert len(complete) == 8  # the ring keeps the newest 8 spans
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in complete)
    assert {e["name"] for e in complete if e["tid"] == lanes["device"]} == {"device.h2d",
                                                                          "device.d2h"}
    # 24 thread spans and 2 device spans went into an 8-slot ring
    assert audit["dropped"] == spans.RECORDER.dropped == 18
    assert [e["name"] for e in events if e["ph"] == "i"] == ["test.point"]


def test_causal_handoff_links_across_threads():
    import threading

    spans.start_recording()
    try:
        with trace.span("test.sender"):
            ctx = trace.context()

        def worker():
            with trace.adopt(ctx):
                with trace.span("test.receiver"):
                    pass

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        tree = spans.RECORDER.trace_tree(ctx.trace_id)
        doc = spans.RECORDER.chrome_trace()
    finally:
        spans.stop_recording()
    assert tree["connected"] and tree["span_count"] == 2 and len(tree["lanes"]) == 2
    assert [e["ph"] for e in doc["traceEvents"] if e.get("cat") == "flow"] == ["s", "f"]


def test_off_path_calls_no_sink(monkeypatch):
    """Recording and the memory observatory off: a span and an event call
    nothing of the recorder or the observatory (counted through patched
    methods, not timed)."""
    calls = []

    def count(name):
        def record(*args, **kwargs):
            calls.append(name)
        return record

    for name in ("begin", "end", "event", "add_complete", "add_instant"):
        monkeypatch.setattr(spans.RECORDER, name, count(name))
    for name in ("phase_begin", "phase_end", "record_copy"):
        monkeypatch.setattr(memory.OBSERVATORY, name, count(name))
    assert not spans.is_recording() and not memory.is_observing()
    for _ in range(100):
        with trace.span("transition.block", slot=1):
            trace.event("test.point")
    assert calls == []
    with pytest.raises(ValueError):
        with trace.span("transition.block"):
            raise ValueError("the body's error passes through")
    assert calls == []


def test_failing_span_records_its_error():
    spans.start_recording()
    try:
        with pytest.raises(KeyError):
            with trace.span("test.fails"):
                raise KeyError("x")
        records = spans.RECORDER.records()
    finally:
        spans.stop_recording()
    assert [(r.name, r.error) for r in records] == [("test.fails", "KeyError('x')")]
