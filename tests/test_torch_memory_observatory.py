"""The memory observatory (telemetry/memory.py) of the port.

The census is held exact, as deltas over the objects a test makes: SSZ
column caches, Bitlist bitpacks, the phase0 shuffle cache, the committee
mask bundles and the epoch engine's kernel entries. The copy ledger's bytes
are exact at ``ssz.bulk_store``, ``ssz.column_serialize`` and
``ssz.state_copy``; the phase ledger's structure follows the trace
facade's prefixes. RSS growth is asserted only in a fresh subprocess: a
worker that ran other files holds freed heap that hides it.
"""

import gc
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chain_utils
import torch_genesis
from ethereum_consensus_tpu_torch.config import Context
from ethereum_consensus_tpu_torch.models import committees, epoch_vector, ops_vector
from ethereum_consensus_tpu_torch.models.phase0 import containers, helpers
from ethereum_consensus_tpu_torch.ssz import core
from ethereum_consensus_tpu_torch.telemetry import device, memory, spans
from ethereum_consensus_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _observatory_off_between_tests():
    yield
    memory.stop()
    device.stop()
    if spans.RECORDER.enabled:
        spans.stop_recording()


def _census() -> dict:
    gc.collect()
    return memory.census()


def _delta(after: dict, before: dict, owner: str) -> tuple:
    return (after[owner]["bytes"] - before[owner]["bytes"],
            after[owner]["entries"] - before[owner]["entries"])


def test_census_columns_and_bitpacks_exact():
    memory.start()
    before = _census()
    words = core.CachedRootList([0] * 100)
    ops_vector.install_zero_column(words, 100, vmax=(1 << 64) - 1)
    flags = core.CachedRootList([0] * 37)
    ops_vector.install_zero_column(flags, 37)
    bits = core.CachedRootList([True, False, True] * 300)
    core.Bitlist(2048).hash_tree_root(bits)
    after = _census()
    assert _delta(after, before, "ssz.columns") == (800 + 37, 2)
    # 900 bits: 113 bytes packed without the delimiter
    assert _delta(after, before, "ssz.bitpack") == (113, 1)
    assert after["ssz.root_cache"]["entries"] >= before["ssz.root_cache"]["entries"]
    rows = memory.OBSERVATORY.worst(50, after)
    assert rows == sorted(rows, key=lambda r: r["bytes"], reverse=True)
    del words, flags, bits


def test_census_is_empty_rows_before_arming(monkeypatch):
    monkeypatch.setattr(memory, "TRACKED_LISTS", None)
    doc = memory.census()
    assert all(doc[name] == {"bytes": 0, "entries": 0} for name in memory._SSZ_OWNERS)


def test_copy_ledger_exact_bytes():
    with memory.observing() as obs:
        lst = core.CachedRootList(list(range(50)))
        core.bulk_store(lst, np.arange(50, dtype=np.uint64))
        core.bulk_store(lst, list(range(1, 51)))
        summary = obs.copy_summary()
    assert summary["sites"]["ssz.bulk_store"] == {"count": 2, "bytes": 400 + 50 * 8}
    assert summary["totals"] == {"count": 2, "bytes": 800}


def test_state_copy_and_column_serialize_bytes(chain_state):
    state, ctx = chain_state
    with memory.observing() as obs:
        copied = state.copy()
        summary = obs.copy_summary()
    site = summary["sites"]["ssz.state_copy"]
    # each copied list counts 8 bytes a slot: the registry-sized lists among them
    assert site["bytes"] >= 8 * (len(state.balances) + len(state.validators))
    with memory.observing() as obs:
        copied.balances[0] = int(copied.balances[0]) + 1
        type(copied).hash_tree_root(copied)
        sites = obs.copy_summary()["sites"]
    serialized = sites.get("ssz.column_serialize", {"bytes": 0})["bytes"]
    spliced = sites.get("ssz.packed_splice", {"bytes": 0})["bytes"]
    assert serialized + spliced > 0


@pytest.fixture(scope="module")
def chain_state():
    ref_state, ref_ctx = torch_genesis.fresh_genesis(64, "minimal")
    blocks = chain_utils.produce_chain(ref_state, ref_ctx, 3, "phase0", atts_per_block=2)
    from ethereum_consensus_tpu.executor import Executor as RefExecutor

    ex = RefExecutor(ref_state, ref_ctx)
    for block in blocks:
        ex.apply_block(block)
    data = ex.state.serialize()
    ctx = Context.for_minimal()
    return containers.build(ctx.preset).BeaconState.deserialize(data), ctx


def test_shuffle_cache_and_mask_bundle_probes(chain_state, monkeypatch):
    state, ctx = chain_state
    state = state.copy()
    monkeypatch.setattr(committees, "MASKS_MIN_VALIDATORS", 0)
    memory.start()
    before = _census()
    helpers._SHUFFLE_CACHE.clear()
    helpers.get_beacon_committee(state, int(state.slot) - 1, 0, ctx)
    epoch = helpers.get_current_epoch(state, ctx)
    bundle = committees.pending_masks_for(state, epoch, ctx)
    assert bundle is not None
    after = _census()
    shuffle = after["phase0.shuffle_cache"]
    assert shuffle["entries"] == len(helpers._SHUFFLE_CACHE) >= 1 and shuffle["bytes"] > 0
    arrays = [getattr(bundle, f) for f in ("source", "target", "head", "covered",
                                           "inclusion_delay", "inclusion_proposer")]
    want = sum({id(a): a.nbytes for a in arrays if a is not None}.values())
    assert _delta(after, before, "committees.mask_bundles") == (want, 1)
    assert bundle in committees.registered_bundles()


def test_pool_store_owner_against_the_reference():
    """The ``pool.store`` owner counts a live pool's packed rows (full
    capacity), signatures, scalar rows and vote records: the same bytes
    and entries as the reference's census of the same admissions."""
    from ethereum_consensus_tpu.telemetry import memory as ref_memory
    from torch_pool import admit, ser, sides

    ref, port = sides("altair")
    head = ref.executor.state.data
    traffic = [ser(chain_utils.make_attestation(head, slot, 0, ref.ctx, participation=p))
               for slot in (2, 3) for p in (0.5, 1.0)]
    deltas, pools = [], []
    for side, census in ((ref, ref_memory.census), (port, memory.census)):
        gc.collect()
        before = census()["pool.store"]
        engine, tickets, _ = admit(side, "attestation", traffic, True, 4)
        assert tickets == [("admitted", None)] * 4
        after = census()["pool.store"]
        pools.append(engine.pool)
        deltas.append((after["bytes"] - before["bytes"], after["entries"] - before["entries"]))
    assert deltas[0] == deltas[1] == (pools[1].memory_census()[0], 4)
    assert deltas[1][0] > 0


def test_jit_kernel_entries_census():
    kernels = epoch_vector.jitted_kernels()
    device.start()
    assert memory.census()["epoch_vector.jit_kernels"] == {"bytes": 0, "entries": 4}
    for n in (8, 9):
        kernels["inactivity_scores"](np.zeros(n, np.uint64), np.ones(n, bool),
                                     np.ones(n, bool), 4, 16, False, device="cpu")
    # the second signature of one entry is one more entry
    assert memory.census()["epoch_vector.jit_kernels"]["entries"] == 5


def test_phase_ledger_brackets_phase_spans_only():
    with memory.observing() as obs:
        with trace.span("transition.block", slot=1):
            with trace.span("epoch_vector.pass"):
                pass
            with trace.span("helpers.active_indices_sweep"):
                pass
        with memory.phase("mem.state_build"):
            pass
        with memory.phase("unprefixed"):
            pass
        ledger = obs.phase_ledger()
    assert set(ledger) == {"transition.block", "epoch_vector.pass", "mem.state_build"}
    keys = {"count", "rss_delta_mb", "rss_end_mb", "peak_mb", "peak_growth_mb",
            "transient_mb", "seconds", "traced_delta_mb"}
    assert all(set(rec) == keys and rec["count"] == 1 for rec in ledger.values())
    snap = memory.snapshot()
    assert set(snap) >= {"census", "worst", "phase_ledger", "bandwidth", "rss_mb"}
    json.dumps(snap)


def test_memory_lane_in_the_chrome_trace():
    spans.start_recording()
    with memory.observing():
        with trace.span("transition.block"):
            pass
        memory.copy("test.site", 64, spans.RECORDER.origin, spans.RECORDER.origin)
    doc = spans.RECORDER.chrome_trace()
    spans.stop_recording()
    lanes = {e["args"]["name"]: e["tid"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    on_lane = {e["name"] for e in doc["traceEvents"]
               if e.get("tid") == lanes["memory"] and e["ph"] in "Xi"}
    assert on_lane == {"memory.phase", "memory.copy"}


def test_rss_growth_in_a_fresh_process():
    """A 64 MiB bytearray touched inside a phase raises that phase's RSS
    delta by at least 32 MiB, in a process that ran nothing else."""
    code = (
        "import json\n"
        "from ethereum_consensus_tpu_torch.telemetry import memory\n"
        "memory.start()\n"
        "with memory.phase('mem.alloc'):\n"
        "    buf = bytearray(64 << 20)\n"
        "    buf[::4096] = b'\\x01' * len(range(0, 64 << 20, 4096))\n"
        "print(json.dumps(memory.OBSERVATORY.phase_ledger()['mem.alloc']))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["count"] == 1 and rec["rss_delta_mb"] >= 32
