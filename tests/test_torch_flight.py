"""The flight recorder in both packages: per-block lineage off the chain
pipeline's commit hook.

The same minimal-preset phase0 chain (built with the reference's
``tests/chain_utils.py``, handed to the port as SSZ bytes) streams through
each package's pipeline with its recorder on. The lineage records must
agree field by field but for the wall-clock fields; a rollback's lineage
must blame the same block; the ring, its JSONL export (read back by either
package) and the query API must behave alike; with the hook off nothing is
recorded. These follow the reference's tests/test_flight_server.py
(:181-230, :353, :534) without its introspection server, which the port
does not have yet.
"""

import time

import pytest

import chain_utils
import torch_genesis
from ethereum_consensus_tpu import executor as ref_executor
from ethereum_consensus_tpu import pipeline as ref_pipeline
from ethereum_consensus_tpu.models.phase0 import containers as ref_containers
from ethereum_consensus_tpu.telemetry import flight as ref_flight
from ethereum_consensus_tpu_torch import executor as port_executor
from ethereum_consensus_tpu_torch import pipeline as port_pipeline
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.models.phase0 import containers as port_containers
from ethereum_consensus_tpu_torch.telemetry import flight as port_flight
from ethereum_consensus_tpu_torch.telemetry import memory as port_memory
from ethereum_consensus_tpu_torch.telemetry import metrics as port_metrics
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N_BLOCKS = 6
# the fields a run's clocks set; every other field must agree exactly
WALL_CLOCK = {"stage_a_s", "phases", "queue_wait_s", "verify_s", "settle_s", "total_s",
              "recovery_s", "finished_at"}

PACKAGES = {
    "ref": (ref_executor, ref_pipeline, ref_flight, chain_utils.Context.for_minimal,
            ref_containers),
    "port": (port_executor, port_pipeline, port_flight, Context.for_minimal, port_containers),
}


@pytest.fixture(scope="module")
def chain():
    state, ctx = torch_genesis.fresh_genesis(64, "minimal")
    blocks = chain_utils.produce_chain(state, ctx, N_BLOCKS, "phase0", atts_per_block=1)
    return state, blocks


def _bytes(state, blocks):
    ns = ref_containers.build(chain_utils.Context.for_minimal().preset)
    return ns.BeaconState.serialize(state), [ns.SignedBeaconBlock.serialize(b) for b in blocks]


def _recorded(package, state_bytes, block_bytes, window_size=3, fault=None):
    """Stream the blocks through ``package``'s pipeline with its recorder
    on; returns (records, the error raised or None)."""
    executor, pipeline, flight, make_ctx, containers = PACKAGES[package]
    ctx = make_ctx()
    ns = containers.build(ctx.preset)
    ex = executor.Executor(ns.BeaconState.deserialize(state_bytes), ctx)
    injector = None
    if fault is not None:
        injector = pipeline.FaultInjector()
        fault(injector)
    pipe = pipeline.ChainPipeline(
        ex, policy=pipeline.FlushPolicy(window_size=window_size, max_in_flight=2,
                                        verify_lanes=1, retry_backoff_s=0.0),
        fault_injector=injector)
    rec = flight.start()
    error = None
    try:
        for data in block_bytes:
            pipe.submit(ns.SignedBeaconBlock.deserialize(data))
        pipe.close()
    except Exception as exc:  # noqa: BLE001 — the caller compares it
        error = exc
    finally:
        flight.stop()
    records = rec.records()
    rec.clear()
    return records, error


def _comparable(record) -> dict:
    return {k: v for k, v in record.to_dict().items() if k not in WALL_CLOCK}


def _both(state_bytes, block_bytes, **kw):
    ref, ref_err = _recorded("ref", state_bytes, block_bytes, **kw)
    port, port_err = _recorded("port", state_bytes, block_bytes, **kw)
    assert [_comparable(r) for r in port] == [_comparable(r) for r in ref]
    assert (type(port_err).__name__, str(port_err)) == (type(ref_err).__name__, str(ref_err))
    return port, port_err


def test_lineage_of_a_pipelined_replay_matches_the_reference(chain):
    sb, bb = _bytes(*chain)
    port, err = _both(sb, bb)
    assert err is None
    assert [r.slot for r in port] == list(range(1, N_BLOCKS + 1))
    assert {r.disposition for r in port} == {"committed"}
    assert [r.flush_seq for r in port] == [0, 0, 0, 1, 1, 1]
    assert [r.flush_slots for r in port] == [(1, 2, 3)] * 3 + [(4, 5, 6)] * 3
    assert {r.verify_route for r in port} == {"host"}
    for r in port:
        assert r.stage_a_s > 0 and r.total_s >= r.stage_a_s
        assert r.verify_s > 0 and r.settle_s is not None
        assert r.root == bytes(chain[1][r.slot - 1].message.state_root).hex()


def test_rollback_lineage_blames_the_failing_block(chain):
    state, blocks = chain
    bad = blocks[3].copy()
    bad.signature = bytes(blocks[0].signature)
    sb, bb = _bytes(state, blocks[:3] + [bad] + blocks[4:])
    port, err = _both(sb, bb)
    assert type(err).__name__ == "InvalidBlock"
    by = {}
    for r in port:
        by.setdefault(r.outcome, []).append(r.slot)
    assert by["rolled-back"] == [4]
    assert sorted(by["committed"]) == [1, 2, 3]
    assert sorted(by["discarded"]) == [5, 6]
    (blamed,) = [r for r in port if r.outcome == "rolled-back"]
    assert blamed.blame["error"] == "InvalidBlock" and blamed.flush_seq is not None


def test_structural_rollback_lineage_matches_the_reference(chain):
    state, blocks = chain
    structural = blocks[3].copy()
    structural.message.state_root = b"\x66" * 32
    sb, bb = _bytes(state, blocks[:4])
    bb[3] = _bytes(state, [structural])[1][0]
    port, err = _both(sb, bb, window_size=8)
    assert type(err).__name__ == "InvalidBlock"
    assert [r.disposition for r in port] == ["rolled-back", "degraded-inline",
                                             "degraded-inline", "degraded-inline"]


def test_retried_window_lineage_matches_the_reference(chain):
    sb, bb = _bytes(*chain)
    port, err = _both(sb, bb, fault=lambda inj: inj.fail_flush(0, times=1))
    assert err is None
    assert [r.disposition for r in port] == ["retried-1"] * 3 + ["committed"] * 3


def _fake(flight, slot, outcome="committed", **kw):
    return flight.BlockLineage(slot=slot, root=f"{slot:064x}", fork="phase0", outcome=outcome,
                               **kw)


def test_ring_eviction_and_jsonl_round_trip(tmp_path):
    dropped = port_metrics.counter("flight.ring_dropped")
    before = dropped.value()
    rec = port_flight.FlightRecorder(capacity=4)
    for slot in range(10):
        rec.handle("block", _fake(port_flight, slot, total_s=float(slot)))
    assert len(rec) == 4 and [r.slot for r in rec.records()] == [6, 7, 8, 9]
    assert dropped.value() == before + 6
    path = str(tmp_path / "flight.jsonl")
    assert rec.write_jsonl(path) == 4
    want = [r.to_dict() for r in rec.records()]
    assert [r.to_dict() for r in port_flight.read_jsonl(path)] == want
    # the export is the reference's format: each package reads the other's
    assert [r.to_dict() for r in ref_flight.read_jsonl(path)] == want
    ref_rec = ref_flight.FlightRecorder(capacity=4)
    for slot in range(10):
        ref_rec.handle("block", _fake(ref_flight, slot, total_s=float(slot)))
    ref_path = str(tmp_path / "ref.jsonl")
    ref_rec.write_jsonl(ref_path)
    strip = [{k: v for k, v in d.items() if k != "finished_at"} for d in want]
    assert [{k: v for k, v in r.to_dict().items() if k != "finished_at"}
            for r in port_flight.read_jsonl(ref_path)] == strip


def test_query_api_slot_range_outcome_worst():
    for flight in (port_flight, ref_flight):
        rec = flight.FlightRecorder(capacity=64)
        rec.handle("block", _fake(flight, 1, total_s=0.5))
        rec.handle("block", _fake(flight, 2, outcome="rolled-back", total_s=2.0,
                                  blame={"error": "InvalidBlock", "detail": "x"}))
        rec.handle("block", _fake(flight, 3, total_s=1.0, degraded=True))
        rec.handle("block", _fake(flight, 4, outcome="discarded", trace_id=7))
        rec.handle("block", _fake(flight, 5, total_s=0.1, retries=2))
        assert [r.slot for r in rec.by_slot_range(2, 3)] == [2, 3]
        assert [r.slot for r in rec.by_outcome("rolled-back")] == [2]
        assert [r.slot for r in rec.by_outcome("degraded-inline")] == [3]
        assert [r.slot for r in rec.by_outcome("retried-2")] == [5]
        assert [r.slot for r in rec.by_trace(7)] == [4]
        assert [r.slot for r in rec.for_slot(5)] == [5]
        assert [r.slot for r in rec.worst(2, field="total_s")] == [2, 3]
        with pytest.raises(ValueError):
            rec.worst(1, field="not_a_latency")
        with pytest.raises(ValueError):
            flight.BlockLineage(slot=1, root="00", outcome="lost")
        assert rec.annotate_recovery(2, 0.25)
        assert rec.by_outcome("rolled-back")[0].recovery_s == 0.25
        assert not rec.annotate_recovery(999, 1.0)
        rec.handle("broken", {"window_seq": 3, "slots": [7]})
        assert rec.last_broken == {"window_seq": 3, "slots": [7]}


def test_hook_off_records_nothing_and_stays_cheap(chain):
    assert not port_flight.HOOK.active and not port_flight.is_recording()
    sb, bb = _bytes(*chain)
    before = len(port_flight.RECORDER)
    ctx = Context.for_minimal()
    ns = port_containers.build(ctx.preset)
    ex = port_executor.Executor(ns.BeaconState.deserialize(sb), ctx)
    ex.stream([ns.SignedBeaconBlock.deserialize(b) for b in bb],
              policy=port_pipeline.FlushPolicy(window_size=2, verify_lanes=1))
    assert len(port_flight.RECORDER) == before
    hook = port_flight.HOOK
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        if hook.active:  # pragma: no cover - never true here
            raise AssertionError
    assert (time.perf_counter() - t0) / n < 5e-6


def test_the_hook_fans_out_and_drops_a_raising_subscriber():
    hook = port_flight.CommitHook()
    errors = port_metrics.counter("flight.hook_errors")
    before = errors.value()
    seen = []

    def broken(kind, payload):
        raise RuntimeError("subscriber bug")

    hook.subscribe(broken)
    hook.subscribe(lambda kind, payload: seen.append((kind, payload)))
    assert hook.active and not hook.state_active
    hook.emit("head", {"slot": 1})
    assert seen == [("head", {"slot": 1})] and errors.value() == before + 1
    hook.unsubscribe(broken)
    states = []
    hook.subscribe_states(states.append)
    assert hook.state_active
    hook.emit_state({"slot": 2})
    assert states == [{"slot": 2}]
    hook.unsubscribe_states(states.append)
    assert not hook.state_active


def test_the_memory_census_sees_the_flight_ring():
    rec = port_flight.start(capacity=16)
    try:
        for slot in range(5):
            rec.handle("block", _fake(port_flight, slot))
        census = port_memory.OBSERVATORY.census()
    finally:
        port_flight.stop()
        rec.clear()
        port_flight.RECORDER.resize(port_flight.DEFAULT_CAPACITY)
    assert census["flight.ring"]["entries"] == 5 and census["flight.ring"]["bytes"] > 0
