"""The chain pipeline in both packages: ``Executor.stream`` and
``ChainPipeline`` on the same minimal-preset phase0 chains.

Chains are built with the reference's ``tests/chain_utils.py`` and handed
to the port as SSZ bytes. Every test runs the reference's pipeline and the
port's on the same blocks and compares them exactly: final state bytes and
roots (also against a loop of ``apply_block``), the exception class and
message of a failure, the committed state after it, and the stats' counts.

Two routes. The host route verifies every window with the native batch.
The device route installs the pairing from 2 sets on: the port with
``ops.install(device="cpu", pairing_min_sets=2)`` (B6's and B7's plain
versions on the verifier's thread), the reference with
``ops.install(pairing_min_sets=2)`` (its device programs on JAX's CPU). A
plain-version batch costs about a second a set on the CPU, so the device
route runs on a three-block chain (one window of 8 sets); the geometry grid
and the failure cases run on the host route as well.

The port's divergence is held here too: a device failure on the verifier's
thread breaks the pipeline (``PipelineBrokenError`` chained from it, the
state at the committed position) where the reference degrades the window.
"""

import json
import os
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import pytest
import torch

import chain_utils
import torch_genesis
from ethereum_consensus_tpu import executor as ref_executor
from ethereum_consensus_tpu import ops as ref_ops
from ethereum_consensus_tpu import pipeline as ref_pipeline
from ethereum_consensus_tpu.models.phase0 import containers as ref_containers
from ethereum_consensus_tpu.models.signature_batch import collect_signatures
from ethereum_consensus_tpu.telemetry import flight as ref_flight
from ethereum_consensus_tpu.telemetry import metrics as ref_metrics
from ethereum_consensus_tpu_torch import _kernels
from ethereum_consensus_tpu_torch import executor as port_executor
from ethereum_consensus_tpu_torch import ops
from ethereum_consensus_tpu_torch import pipeline as port_pipeline
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.crypto import bls as port_bls
from ethereum_consensus_tpu_torch.models.phase0 import containers as port_containers
from ethereum_consensus_tpu_torch.ops import g1, pairing
from ethereum_consensus_tpu_torch.pipeline.faults import FaultInjector
from ethereum_consensus_tpu_torch.telemetry import device as port_device_obs
from ethereum_consensus_tpu_torch.telemetry import flight as port_flight
from ethereum_consensus_tpu_torch.telemetry import metrics as port_metrics
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
N_BLOCKS = 6
DEVICE_BLOCKS = 3  # 2 + 3 + 3 sets: one window of 8 on the device route

GEOMETRIES = [(w, m, lanes) for w in (1, 3, 8) for m in (1, 2) for lanes in (1, 3)]


def _serialize(state, blocks):
    ns = ref_containers.build(state_ctx().preset)
    return ns.BeaconState.serialize(state), [ns.SignedBeaconBlock.serialize(b) for b in blocks]


def state_ctx():
    return chain_utils.Context.for_minimal()


@pytest.fixture(scope="module")
def genesis():
    return torch_genesis.fresh_genesis(64, "minimal")


@pytest.fixture(scope="module")
def chain(genesis):
    state, ctx = genesis
    blocks = chain_utils.produce_chain(state, ctx, N_BLOCKS, "phase0", atts_per_block=1)
    return state, blocks


class Side:
    """One package's view of a chain: its executor module, pipeline
    package, containers and context."""

    def __init__(self, name):
        self.name = name
        if name == "ref":
            self.executor, self.pipeline = ref_executor, ref_pipeline
            self.ctx = chain_utils.Context.for_minimal()
            self.ns = ref_containers.build(self.ctx.preset)
        else:
            self.executor, self.pipeline = port_executor, port_pipeline
            self.ctx = Context.for_minimal()
            self.ns = port_containers.build(self.ctx.preset)

    def state(self, state_bytes):
        return self.ns.BeaconState.deserialize(state_bytes)

    def blocks(self, block_bytes):
        return [self.ns.SignedBeaconBlock.deserialize(b) for b in block_bytes]

    def executor_at(self, state_bytes):
        return self.executor.Executor(self.state(state_bytes), self.ctx)

    def policy(self, window_size=8, max_in_flight=2, lanes=1, **kw):
        return self.pipeline.FlushPolicy(window_size=window_size, max_in_flight=max_in_flight,
                                         verify_lanes=lanes, **kw)

    def looped(self, state_bytes, block_bytes):
        ex = self.executor_at(state_bytes)
        for block in self.blocks(block_bytes):
            ex.apply_block(block)
        return ex.state


REF, PORT = Side("ref"), Side("port")


def _root(state):
    return state.hash_tree_root()


@contextmanager
def _route(name):
    """Both packages on the host route, or both on the device route."""
    if name == "device":
        ops.install(device="cpu", pairing_min_sets=2)
        ref_ops.install(pairing_min_sets=2)
    try:
        yield
    finally:
        ops.uninstall()
        ref_ops.uninstall()


def _stream(side, state_bytes, block_bytes, **policy):
    ex = side.executor_at(state_bytes)
    stats = ex.stream(side.blocks(block_bytes), policy=side.policy(**policy))
    return ex, stats


def _failing_stream(side, state_bytes, block_bytes, **policy):
    """Submit every block and close; return (error, executor, pipeline)."""
    ex = side.executor_at(state_bytes)
    pipe = side.pipeline.ChainPipeline(ex, policy=side.policy(**policy))
    with pytest.raises(Exception) as info:
        for block in side.blocks(block_bytes):
            pipe.submit(block)
        pipe.close()
    return info.value, ex, pipe


def _same_failure(state_bytes, block_bytes, committed_bytes, route="host", **policy):
    """Both packages fail the stream on ``route`` with the same error; each
    executor is at the state of ``committed_bytes`` applied by the port's
    loop (on the host route)."""
    expect = PORT.looped(state_bytes, committed_bytes)
    with _route(route):
        ref_err, ref_ex, ref_pipe = _failing_stream(REF, state_bytes, block_bytes, **policy)
        port_err, port_ex, port_pipe = _failing_stream(PORT, state_bytes, block_bytes, **policy)
    assert (type(port_err).__name__, str(port_err)) == (type(ref_err).__name__, str(ref_err))
    assert _root(port_ex.state) == _root(ref_ex.state) == _root(expect)
    assert port_ex.state.serialize() == ref_ex.state.serialize()
    with pytest.raises(port_pipeline.PipelineBrokenError):
        port_pipe.submit(PORT.blocks(block_bytes)[0])
    return port_err, port_pipe, ref_pipe


def _tamper_proposer(block, donor):
    """A valid G2 point over the wrong message: it parses, and fails only
    at the pairing (the rollback path, not the structural one)."""
    bad = block.copy()
    bad.signature = bytes(donor.signature)
    return bad


# ---------------------------------------------------------------------------
# bit-identical replay: every geometry on the host route, one on the device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "route,window_size,max_in_flight,lanes",
    [("host", *g) for g in GEOMETRIES] + [("device", 8, 2, 1)],
    ids=lambda v: str(v),
)
def test_stream_matches_the_loop_and_the_reference(chain, route, window_size, max_in_flight,
                                                   lanes):
    state, blocks = chain
    if route == "device":
        blocks = blocks[:DEVICE_BLOCKS]
    sb, bb = _serialize(state, blocks)
    expect = PORT.looped(sb, bb)
    geometry = dict(window_size=window_size, max_in_flight=max_in_flight, lanes=lanes)
    with _route(route):
        route_before = port_bls._ROUTE_DEVICE.value()
        port_ex, port_stats = _stream(PORT, sb, bb, **geometry)
        port_device_batches = port_bls._ROUTE_DEVICE.value() - route_before
        ref_ex, ref_stats = _stream(REF, sb, bb, **geometry)
    assert port_ex.state.serialize() == expect.serialize() == ref_ex.state.serialize()
    assert _root(port_ex.state) == _root(expect) == _root(ref_ex.state)
    counts = ("blocks_submitted", "blocks_committed", "flushes", "sets_flushed", "flush_sizes",
              "rollbacks", "sequential_reverifies", "checkpoints", "fault_retries",
              "degraded_flushes", "queue_high_watermark")
    port_snap, ref_snap = port_stats.snapshot(), ref_stats.snapshot()
    assert {k: port_snap[k] for k in counts} == {k: ref_snap[k] for k in counts}
    assert port_stats.blocks_committed == len(blocks)
    if window_size > 1:
        assert port_stats.flushes < len(blocks)
    assert port_device_batches == (port_stats.flushes if route == "device" else 0)


# ---------------------------------------------------------------------------
# failure semantics (the reference's tests/test_pipeline.py:107-260)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["host", "device"])
def test_invalid_signature_mid_stream_rolls_back_to_committed(chain, route):
    state, blocks = chain
    bad_at, window = (4, 3) if route == "host" else (1, 8)
    blocks = blocks if route == "host" else blocks[:DEVICE_BLOCKS]
    stream = blocks[:bad_at] + [_tamper_proposer(blocks[bad_at], blocks[0])] + blocks[bad_at + 1:]
    sb, bb = _serialize(state, stream)
    committed = _serialize(state, blocks[:bad_at])[1]
    port_rec, ref_rec = port_flight.start(), ref_flight.start()
    try:
        err, port_pipe, ref_pipe = _same_failure(sb, bb, committed, route, window_size=window)
    finally:
        port_flight.stop()
        ref_flight.stop()
    assert type(err).__name__ == "InvalidBlock"
    assert port_pipe.stats.rollbacks == ref_pipe.stats.rollbacks == 1
    assert port_pipe.stats.blocks_committed == ref_pipe.stats.blocks_committed == bad_at
    # the failed window went to the route's batch, then the blame named the set
    for rec in (port_rec, ref_rec):
        (blamed,) = rec.by_outcome("rolled-back")
        assert blamed.slot == bad_at + 1 and blamed.verify_route == route
        assert blamed.blame["error"] == "InvalidBlock"


def test_invalid_first_block_rolls_back_to_genesis(chain):
    state, blocks = chain
    sb, bb = _serialize(state, [_tamper_proposer(blocks[0], blocks[1])])
    err, port_pipe, _ = _same_failure(sb, bb, [], window_size=4)
    assert type(err).__name__ == "InvalidBlock"
    assert port_pipe.stats.blocks_committed == 0


def _blamed_attestation_chain(genesis):
    """b1, then b2 carrying an attestation whose signature is a valid point
    over other data: its proposer signature is fine."""
    from ethereum_consensus_tpu.models.phase0.state_transition import (
        Validation,
        state_transition_block_in_slot,
    )

    state, ctx = genesis
    scratch = state.copy()
    b1 = chain_utils.produce_block(scratch, 1, ctx)
    state_transition_block_in_slot(scratch, b1, Validation.ENABLED, ctx)
    att = chain_utils.make_attestation(scratch, 1, 0, ctx)
    att.data.beacon_block_root = b"\x13" * 32
    with collect_signatures():
        b2 = chain_utils.produce_block(scratch.copy(), 2, ctx, attestations=[att])
    return b1, b2


def test_invalid_attestation_attributed_not_proposer(genesis):
    b1, b2 = _blamed_attestation_chain(genesis)
    sb, bb = _serialize(genesis[0], [b1, b2])
    err, _, _ = _same_failure(sb, bb, bb[:1], window_size=4)
    assert type(err).__name__ == "InvalidAttestation"


def test_structural_error_settles_earlier_blocks_first(chain):
    state, blocks = chain
    bad_sig = _tamper_proposer(blocks[2], blocks[0])
    structural = blocks[3].copy()
    structural.message.state_root = b"\x66" * 32
    structural.signature = bytes(blocks[3].signature)
    sb, bb = _serialize(state, blocks[:2] + [bad_sig, structural])
    err, _, _ = _same_failure(sb, bb, bb[:2], window_size=8)
    assert type(err).__name__ == "InvalidBlock"
    assert "block signature" in str(err)


def test_call_site_order_signature_error_preempts_later_structural(genesis):
    """A bad attestation signature EARLIER in a block wins over a
    structurally invalid exit LATER in it, in a pipelined stream as in the
    sequential path."""
    from ethereum_consensus_tpu.models.phase0 import build
    from ethereum_consensus_tpu.models.phase0.slot_processing import process_slots
    from ethereum_consensus_tpu.models.phase0.state_transition import state_transition

    state, ctx = genesis
    b1, b2 = _blamed_attestation_chain(genesis)
    ns = build(ctx.preset)
    b2.message.body.voluntary_exits = [ns.SignedVoluntaryExit(
        message=ns.VoluntaryExit(epoch=0, validator_index=2**32),
        signature=bytes(b1.signature),
    )]
    target = state.copy()
    state_transition(target, b1, ctx)
    process_slots(target, 2, ctx)
    b2.signature = chain_utils.sign_block(target, b2.message, ctx)
    sb, bb = _serialize(state, [b1, b2])
    for window in (1, 8):
        err, _, _ = _same_failure(sb, bb, bb[:1], window_size=window)
        assert type(err).__name__ == "InvalidAttestation"


# ---------------------------------------------------------------------------
# backpressure and the policy's validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [1, 2])
def test_backpressure_queue_never_exceeds_cap(chain, cap):
    sb, bb = _serialize(*chain)
    for side in (REF, PORT):
        pipe = side.pipeline.ChainPipeline(side.executor_at(sb),
                                           policy=side.policy(window_size=1, max_in_flight=cap))
        observed = []
        original = pipe._sched.dispatch

        def spying_dispatch(window, _orig=original, _sched=pipe._sched):
            _orig(window)
            observed.append(_sched.in_flight)

        pipe._sched.dispatch = spying_dispatch
        for block in side.blocks(bb):
            pipe.submit(block)
        stats = pipe.close()
        assert max(observed) <= cap
        assert stats.queue_high_watermark == cap
        assert stats.flushes == N_BLOCKS


@pytest.mark.parametrize("kwargs", [
    {"window_size": 0}, {"max_in_flight": 0}, {"checkpoint_interval": 0},
    {"settle_timeout_s": 0}, {"settle_timeout_s": -1.0}, {"flush_retries": -1},
    {"verify_lanes": 0},
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_flush_policy_validation(kwargs):
    with pytest.raises(ValueError) as ref_info:
        ref_pipeline.FlushPolicy(**kwargs)
    with pytest.raises(ValueError) as port_info:
        port_pipeline.FlushPolicy(**kwargs)
    assert str(port_info.value) == str(ref_info.value)


def test_auto_verify_lanes_matches_the_reference(monkeypatch):
    monkeypatch.delenv("ECT_MESH", raising=False)
    assert port_pipeline.auto_verify_lanes() == ref_pipeline.auto_verify_lanes()
    assert 1 <= port_pipeline.FlushPolicy().verify_lanes <= 8


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


def _faulted(side, sb, bb, plan, **policy):
    injector = (FaultInjector() if side is PORT else ref_pipeline.FaultInjector())
    plan(injector)
    ex = side.executor_at(sb)
    pipe = side.pipeline.ChainPipeline(ex, policy=side.policy(**policy),
                                       fault_injector=injector)
    for block in side.blocks(bb):
        pipe.submit(block)
    return ex, pipe.close(), injector


def test_fail_flush_retries_then_succeeds(chain):
    sb, bb = _serialize(*chain)
    out = {}
    for side in (REF, PORT):
        out[side.name] = _faulted(side, sb, bb, lambda inj: inj.fail_flush(0, times=1),
                                  window_size=3, retry_backoff_s=0.0)
    (ref_ex, ref_stats, ref_inj), (port_ex, port_stats, port_inj) = out["ref"], out["port"]
    assert _root(port_ex.state) == _root(ref_ex.state) == _root(PORT.looped(sb, bb))
    assert port_stats.fault_retries == ref_stats.fault_retries == 1
    assert port_stats.degraded_flushes == ref_stats.degraded_flushes == 0
    assert port_inj.injected == ref_inj.injected == [(0, 0, "transient")]


def test_kill_worker_degrades_on_the_worker_route(chain):
    """A dead worker: the window re-verifies in-line on the route the worker
    took (the device route here), with exact verdicts."""
    state, blocks = chain
    sb, bb = _serialize(state, blocks[:DEVICE_BLOCKS])
    deaths = port_metrics.counter("pipeline.fault.worker_death")
    before = deaths.value()
    rec = port_flight.start()
    try:
        with _route("device"):
            port_ex, port_stats, _ = _faulted(PORT, sb, bb, lambda inj: inj.kill_worker(0),
                                              window_size=8)
    finally:
        port_flight.stop()
    ref_ex, ref_stats, _ = _faulted(REF, sb, bb, lambda inj: inj.kill_worker(0), window_size=8)
    assert _root(port_ex.state) == _root(ref_ex.state) == _root(PORT.looped(sb, bb))
    assert port_stats.degraded_flushes == ref_stats.degraded_flushes == 1
    assert deaths.value() == before + 1
    lineage = rec.records()
    assert [r.disposition for r in lineage] == ["degraded-inline"] * DEVICE_BLOCKS
    assert {r.verify_route for r in lineage} == {"device"}


def test_delay_beyond_the_settle_timeout_breaks_with_the_window_slots(chain):
    sb, bb = _serialize(*chain)
    for side in (REF, PORT):
        injector = (FaultInjector() if side is PORT else ref_pipeline.FaultInjector())
        injector.delay_flush(0, 1.0)
        ex = side.executor_at(sb)
        pipe = side.pipeline.ChainPipeline(
            ex, policy=side.policy(window_size=3, settle_timeout_s=0.2, lanes=1),
            fault_injector=injector)
        with pytest.raises(side.pipeline.PipelineBrokenError) as info:
            for block in side.blocks(bb):
                pipe.submit(block)
            pipe.close()
        assert info.value.window_seq == 0
        assert info.value.slots == (1, 2, 3)
        assert _root(ex.state) == _root(side.executor_at(sb).state)
    time.sleep(1.0)  # let the stalled workers drain before the next test


# ---------------------------------------------------------------------------
# the divergence: a device failure raises, it is never a worker death
# ---------------------------------------------------------------------------


def test_a_failing_kernel_on_the_verifier_breaks_the_pipeline(chain, monkeypatch):
    """B6's plain version raises inside the worker on the second window
    (the first, of 8 sets, stays on the host below pairing_min_sets=9):
    the failure propagates out of ``stream`` as PipelineBrokenError chained
    from it, the state is at the committed position (the first window's
    three blocks), no worker death is counted and no window degrades."""
    state, blocks = chain
    sb, bb = _serialize(state, blocks)
    threads = []

    def failing(points, offsets):
        threads.append(threading.current_thread().name)
        raise RuntimeError("g1_sum_sets kernel launch failed: CUDA error 719")

    monkeypatch.setattr(g1, "g1_sum_sets_plain", failing)
    deaths = port_metrics.counter("pipeline.fault.worker_death")
    errors = port_metrics.counter("pipeline.fault.verifier_error")
    before = (deaths.value(), errors.value())
    ops.install(device="cpu", pairing_min_sets=9)
    try:
        ex = PORT.executor_at(sb)
        with pytest.raises(port_pipeline.PipelineBrokenError) as info:
            ex.stream(PORT.blocks(bb), policy=PORT.policy(window_size=3))
    finally:
        ops.uninstall()
    assert isinstance(info.value.__cause__, RuntimeError)
    assert "CUDA error 719" in str(info.value.__cause__)
    assert info.value.window_seq == 1 and info.value.slots == (4, 5, 6)
    assert threads and all(t.startswith("bls-verify-") for t in threads)
    assert ex.state.serialize() == PORT.looped(sb, bb[:3]).serialize()
    assert (deaths.value(), errors.value()) == (before[0], before[1] + 1)
    assert port_metrics.gauge("pipeline.broken").value() == 1
    port_metrics.gauge("pipeline.broken").set(0)


def test_a_failing_kernel_in_stage_a_restores_the_committed_state(chain, monkeypatch):
    """A non-consensus exception under the transition (a device kernel on
    stage A's thread) restores the committed state and breaks the
    pipeline before it propagates."""
    state, blocks = chain
    sb, bb = _serialize(state, blocks)
    ex = PORT.executor_at(sb)
    pipe = port_pipeline.ChainPipeline(ex, policy=PORT.policy(window_size=1, max_in_flight=1))
    port_blocks = PORT.blocks(bb)
    for block in port_blocks[:3]:  # blocks 1 and 2 commit, block 3 is in flight
        pipe.submit(block)
    original = ex.apply_block_with_validation
    calls = []

    def failing_once(signed_block, validation):
        calls.append(int(signed_block.message.slot))
        if len(calls) == 1:
            raise RuntimeError("sha256_64b kernel launch failed: CUDA error 719")
        original(signed_block, validation)

    ex.apply_block_with_validation = failing_once
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        pipe.submit(port_blocks[3])
    assert calls == [4, 1, 2]  # the failure, then the committed blocks replayed
    assert ex.state.serialize() == PORT.looped(sb, bb[:2]).serialize()
    with pytest.raises(port_pipeline.PipelineBrokenError):
        pipe.submit(port_blocks[3])
    port_metrics.gauge("pipeline.broken").set(0)


# ---------------------------------------------------------------------------
# the kernel libraries under threads
# ---------------------------------------------------------------------------


class _FakeCuda(torch.Tensor):
    """A host tensor that reports a CUDA device, so that a wrapper's launch
    path runs against a stand-in library."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_two_threads_build_once_and_count_exactly(monkeypatch, tmp_path):
    """Two threads that first use the pairing library at once: one build
    and one compile-ledger entry; then two threads launching through it
    together keep ``launch_counts`` and the launch ledger exact."""
    builds = []

    def slow_build(names=None):
        builds.append(threading.current_thread().name)
        time.sleep(0.2)
        return 0.2

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                time.sleep(0)
                return 1
            object.__setattr__(self, name, entry)
            return entry

    monkeypatch.setattr(_kernels, "_LOADED", {})
    monkeypatch.setattr(_kernels, "_paths", lambda name: (str(tmp_path / f"{name}.so"),
                                                          str(tmp_path / f"{name}.log")))
    monkeypatch.setattr(_kernels, "build_all", slow_build)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda device: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    port_device_obs.start()
    try:
        barrier = threading.Barrier(2)
        loaded = []

        def first_use():
            barrier.wait()
            loaded.append(_kernels.load("pairing"))

        workers = [threading.Thread(target=first_use) for _ in range(2)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        assert len(builds) == 1 and loaded[0] is loaded[1]
        assert [c["fn"] for c in port_device_obs.OBSERVATORY.compiles()] == ["pairing"]

        t = torch.zeros(4, dtype=torch.int32).as_subclass(_FakeCuda)
        for name in pairing.launch_counts:
            monkeypatch.setitem(pairing.launch_counts, name, 0)
        per_thread = 3000

        def launches():
            barrier.wait()
            for _ in range(per_thread):
                pairing._launch("miller_loop", "miller_loop_launch", t, 1, t)

        workers = [threading.Thread(target=launches) for _ in range(2)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
    finally:
        sys.setswitchinterval(old_interval)
        port_device_obs.stop()
    assert pairing.launch_counts["miller_loop"] == 2 * per_thread
    assert port_device_obs.OBSERVATORY.launches() == {"miller_loop": 2 * per_thread}

    # the increment waits for LAUNCH_LOCK: held here, a launch cannot count
    _kernels.LAUNCH_LOCK.acquire()
    try:
        worker = threading.Thread(
            target=pairing._launch, args=("miller_loop", "miller_loop_launch", t, 1, t))
        worker.start()
        worker.join(0.3)
        assert worker.is_alive() and pairing.launch_counts["miller_loop"] == 2 * per_thread
    finally:
        _kernels.LAUNCH_LOCK.release()
    worker.join()
    assert pairing.launch_counts["miller_loop"] == 2 * per_thread + 1


def test_every_launch_count_increment_holds_the_launch_lock():
    """Each ``launch_count`` / ``launch_counts[...]`` increment in ops/*.py
    sits inside ``with _kernels.LAUNCH_LOCK:``."""
    import ast

    found = 0
    for path in sorted((REPO / "ethereum_consensus_tpu_torch" / "ops").glob("*.py")):
        tree = ast.parse(path.read_text())
        locked = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.With) and any(
                    ast.unparse(item.context_expr) == "_kernels.LAUNCH_LOCK"
                    for item in node.items):
                locked.update(id(n) for n in ast.walk(node))
        for node in ast.walk(tree):
            if isinstance(node, ast.AugAssign):
                target = ast.unparse(node.target)
                if target.startswith("launch_count"):
                    found += 1
                    assert id(node) in locked, f"{path.name}:{node.lineno} {target}"
    assert found >= 20


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Stream:
    cuda_stream = 0


# ---------------------------------------------------------------------------
# the trace and the entry point
# ---------------------------------------------------------------------------


def test_trace_shows_stage_a_and_the_verifier_on_distinct_lanes(chain):
    from ethereum_consensus_tpu_torch.telemetry import spans

    sb, bb = _serialize(*chain)
    ex = PORT.executor_at(sb)
    with spans.recording():
        stats = ex.stream(PORT.blocks(bb), policy=PORT.policy(window_size=3))
        doc = spans.RECORDER.chrome_trace()
    assert stats.rollbacks == 0
    complete = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    stage_a = {e["tid"] for e in complete if e["name"] == "pipeline.stage_a"}
    verify = {e["tid"] for e in complete if e["name"] == "pipeline.flush.verify"}
    assert stage_a and verify and stage_a.isdisjoint(verify)
    assert any(e["name"] == "pipeline.flush.settle" for e in complete)
    assert {"transition.sig_batch", "transition.state_htr", "transition.committees",
            "transition.operations"} <= {e["name"] for e in complete}


def test_selfcheck_entry_point_on_the_cpu(tmp_path):
    trace_path = tmp_path / "pipe.json"
    metrics_path = tmp_path / "metrics.json"
    proc = subprocess.run(
        [sys.executable, "-m", "ethereum_consensus_tpu_torch.pipeline", "--selfcheck",
         "--device", "cpu", "--trace-out", str(trace_path), "--metrics-out", str(metrics_path)],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "selfcheck OK" in proc.stdout
    doc = json.loads(trace_path.read_text())
    complete = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    names = {}
    for e in complete:
        names.setdefault(e["name"], set()).add(e["tid"])
    assert names["pipeline.stage_a"].isdisjoint(names["pipeline.flush.verify"])
    assert "pipeline.flush.settle" in names
    snap = json.loads(metrics_path.read_text())
    assert snap["pipeline.flushes"] > 0


@pytest.mark.parametrize("flag", ["--serve", "--serve-data", "--hold"])
def test_selfcheck_flags_of_later_slices_exit_2(flag, monkeypatch):
    """The flags that exited 2 until the read plane was ported: each now
    runs the selfcheck (its two tiers stubbed here; tests/test_torch_server.py
    runs them whole in a subprocess) and leaves no server, store or flight
    recording behind; ``--serve-data`` without ``--serve`` is refused; and
    without ``--selfcheck`` the entry prints its usage and exits 2."""
    from ethereum_consensus_tpu_torch.pipeline import __main__ as entry

    monkeypatch.setattr(entry, "_selfcheck_chain", lambda lanes=1: None)
    monkeypatch.setattr(entry, "_selfcheck_window", lambda: None)
    argv = {"--serve": ["--serve", "0"], "--serve-data": ["--serve", "0", "--serve-data"],
            "--hold": ["--serve", "0", "--hold", "0.1"]}[flag]
    assert entry.main(["--selfcheck", "--device", "cpu", *argv]) == 0
    assert not port_flight.HOOK.active and not port_flight.HOOK.state_active
    if flag == "--serve-data":
        with pytest.raises(SystemExit, match="requires --serve"):
            entry.main(["--selfcheck", "--device", "cpu", flag])
    assert entry.main([flag, "0"]) == 2
    assert entry.main([]) == 2


def test_the_hook_metrics_of_a_clean_stream(chain):
    """The registry's ``pipeline.*`` counters move by the run's counts in
    both packages."""
    sb, bb = _serialize(*chain)
    names = ("pipeline.blocks_submitted", "pipeline.blocks_committed", "pipeline.flushes",
             "pipeline.sets_flushed")
    before = {n: (port_metrics.counter(n).value(), ref_metrics.counter(n).value())
              for n in names}
    _stream(PORT, sb, bb, window_size=3)
    _stream(REF, sb, bb, window_size=3)
    for n in names:
        port_delta = port_metrics.counter(n).value() - before[n][0]
        ref_delta = ref_metrics.counter(n).value() - before[n][1]
        assert port_delta == ref_delta > 0, n
    assert not port_flight.HOOK.active and not ref_flight.HOOK.active


def test_fail_mesh_reaches_the_port_seam_and_raises():
    """The injector's mesh lane arms the port's ``runtime.fault_point``:
    a planned fault raises ``MeshFaultInjected`` (the reference's host
    fallback recovers it) and is audited; with the plan spent, or the
    injector uninstalled, the seam is quiet."""
    from ethereum_consensus_tpu_torch.parallel import runtime

    injector = FaultInjector().fail_mesh("pairing", times=1)
    declines = port_metrics.counter("mesh.decline.injected_fault")
    before = declines.value()
    injector.install_mesh()
    try:
        runtime.fault_point("epoch")  # no plan for this route
        with pytest.raises(runtime.MeshFaultInjected):
            runtime.fault_point("pairing", n_sets=528)
        runtime.fault_point("pairing")  # the plan is spent
    finally:
        injector.uninstall_mesh()
    injector.fail_mesh("pairing")
    runtime.fault_point("pairing")  # uninstalled: quiet
    assert injector.injected == [(None, None, "mesh_pairing")]
    assert declines.value() == before + 1
