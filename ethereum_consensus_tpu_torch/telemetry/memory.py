"""Memory & bandwidth observatory: attribute the resident bytes and the
bytes moved on the million-validator paths.

One process-wide ``MemoryObservatory`` behind the same one-read ``active``
guard as the span recorder and the device observatory, recording three
ledgers:

* a **resident-set census** — a registry of the port's byte owners,
  probed on demand (never sampled in a hot path): the SSZ list-resident
  caches (column arrays, ``_root_cache`` roots and Bitlist ``bitpack``
  rows, pack/tree memos and their retained raw buffers — ``ssz/core.py``),
  the operation pools' bitfield matrices (``pool/store.py``), the
  committee mask bundles (``models/committees.py``), the phase0
  shuffle-cache slots, and the epoch engine's kernel entries
  (``models/epoch_vector.py kernel_cache_census``). Exposed as
  ``census()`` / ``worst(n)`` and as ``memory.owner.{name}.bytes``
  gauges.

* a **phase RSS/allocation ledger** — every ``transition.*`` /
  ``epoch_vector.*`` / ``committees.mask*`` span (through the
  ``utils/trace.py`` facade) and every explicit ``memory.phase(...)``
  bracket records the RSS delta across its body plus the process
  high-water-mark movement. With ``ECT_TRACEMALLOC=1`` the ledger also
  records tracemalloc traced-bytes deltas per phase and ``top_sites(n)``
  serves the top allocation sites (opt-in: tracemalloc roughly doubles
  allocation cost).

* a **bandwidth ledger** — byte counters at the bulk-copy chokepoints,
  aggregated per call site like the device observatory's transfer
  ledger: ``ssz.bulk_store`` adoption splices, ``ssz.packed_splice``
  dirty-group re-serialization, ``ssz.column_serialize`` wire-width
  ``tobytes()`` packing, ``ssz.state_copy`` structural list copies
  (pointer-width bytes — element payloads are shared structurally), and
  ``ops_vector.working_copies`` (the batched attestations' participation
  columns). Sites with a timed window render as
  complete events on a ``memory`` virtual lane of the Chrome trace.

Cost discipline: ``OBSERVATORY.active`` is a plain bool read — every
instrumented call site checks it first and pays nothing else while the
observatory is off. RSS reads go through ``/proc/self/statm`` with the
``getrusage`` peak beside it; census probes run only when census() is
called. Everything here is stdlib-only; numpy objects are only ever
*measured* (``nbytes``), never created.

Lock discipline: every write to the observatory's shared structures
holds ``self._lock``; the hot ``active`` read and the metrics-registry
increments (locked per metric) stay outside it.

Reference parity: ethereum_consensus_tpu/telemetry/memory.py.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from contextlib import contextmanager

from .. import _env
from . import metrics as _metrics
from . import spans as _spans

__all__ = [
    "MemoryObservatory",
    "OBSERVATORY",
    "TRACKED_LISTS",
    "PHASE_PREFIXES",
    "rss_mb",
    "peak_rss_mb",
    "copy",
    "phase",
    "register_owner",
    "census",
    "worst",
    "owner_entries",
    "owner_bytes",
    "start",
    "stop",
    "is_observing",
    "observing",
    "snapshot",
    "top_sites",
]

_MEMORY_LANE = "memory"
_TRACEMALLOC_ENV = "ECT_TRACEMALLOC"

# span names the trace facade brackets into the phase ledger while the
# observatory is active (the transition phase split + the epoch engine's
# stage spans + the committee-mask build); explicit memory.phase(...)
# brackets take any name
PHASE_PREFIXES = ("transition.", "epoch_vector.", "committees.mask", "mem.")

# the SSZ list census: ssz/core.py's CachedRootList.__init__ adds every
# new instance here while tracking is armed (one module-attribute read +
# None check on the off path — the list-creation hot path pays nothing
# else). A WeakValueDictionary keyed by id() because lists are
# unhashable (a dead entry's id may be reused — the weak callback
# removed the old entry first, so the slot just rebinds). None =
# tracking off; armed by start(), left in place by stop() so the census
# stays readable after an observation ends.
TRACKED_LISTS: "weakref.WeakValueDictionary | None" = None

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096

# guards the one-time arming of TRACKED_LISTS (module global): writes
# hold this module lock; the hot read in CachedRootList.__init__ stays
# lock-free (a torn read can only see None or the armed dict)
_TRACK_LOCK = threading.Lock()


def rss_mb() -> float:
    """Current resident set in MiB: ``/proc/self/statm`` (one short
    read — fast enough to bracket phase spans), ``getrusage`` peak as
    the degraded non-Linux fallback."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE / (1024.0 * 1024.0)
    except (OSError, IndexError, ValueError):
        return peak_rss_mb()


def peak_rss_mb() -> float:
    """Process high-water mark in MiB (``ru_maxrss`` — monotonic for
    the process lifetime)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _nbytes(obj) -> int:
    """Resident bytes of a measurable buffer: numpy ``nbytes``,
    ``len()`` for bytes-likes, 0 otherwise."""
    n = getattr(obj, "nbytes", None)
    if n is not None:
        return int(n)
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return len(obj)
    return 0


class MemoryObservatory:
    """Process-wide memory ledgers; one instance (``OBSERVATORY``)
    serves the whole process, started/stopped like the span recorder."""

    def __init__(self):
        self._lock = threading.Lock()
        self._owners: dict = {}        # name -> probe() -> (bytes, entries)
        self._phases: dict = {}        # name -> aggregate dict
        self._copies: dict = {}        # site -> {count, bytes}
        self._peak_phase: "str | None" = None  # last bracket that raised peak
        self._tracemalloc_started = False
        self.active = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Begin a fresh observation: drop the phase/bandwidth ledgers,
        arm the SSZ list census, and (``ECT_TRACEMALLOC=1``) start
        tracemalloc. Registered owners persist — they describe where
        structures LIVE, not one observation."""
        global TRACKED_LISTS
        with _TRACK_LOCK:
            if TRACKED_LISTS is None:
                TRACKED_LISTS = weakref.WeakValueDictionary()
        with self._lock:
            self._phases.clear()
            self._copies.clear()
            self._peak_phase = None
            if _env.flag_on(_TRACEMALLOC_ENV):
                import tracemalloc

                if not tracemalloc.is_tracing():
                    tracemalloc.start()
                    self._tracemalloc_started = True
            self.active = True

    def stop(self) -> None:
        """Stop observing (ledgers and the census stay readable; a
        tracemalloc WE started stops with us)."""
        with self._lock:
            if self._tracemalloc_started:
                import tracemalloc

                tracemalloc.stop()
                self._tracemalloc_started = False
            self.active = False

    # -- resident-set census -------------------------------------------------
    def register_owner(self, name: str, probe) -> None:
        """Register a byte owner: ``probe()`` returns ``(bytes,
        entries)``. Probes run only on census() — never in any hot
        path — and may raise (reported as an errored owner, never a
        silent pass)."""
        with self._lock:
            self._owners[name] = probe

    def unregister_owner(self, name: str) -> None:
        with self._lock:
            self._owners.pop(name, None)

    def census(self) -> dict:
        """``{owner: {"bytes": int, "entries": int}}`` over every
        registered owner plus the SSZ list walk (one pass distributed
        over its per-structure owners), probed now. Sets the
        ``memory.owner.{name}.bytes`` gauges as a side effect."""
        with self._lock:
            probes = list(self._owners.items())
        out = dict(_ssz_census())
        for name, probe in probes:
            try:
                nbytes, entries = probe()
                out[name] = {"bytes": int(nbytes), "entries": int(entries)}
            except Exception as exc:  # noqa: BLE001 — a probe must not kill a census
                out[name] = {"bytes": -1, "entries": -1,
                             "error": repr(exc)[:160]}
        for name, rec in out.items():
            _metrics.gauge(f"memory.owner.{name}.bytes").set(rec["bytes"])
            _metrics.gauge(f"memory.owner.{name}.entries").set(rec["entries"])
        return out

    def worst(self, n: int = 8, census_doc: "dict | None" = None) -> list:
        """The attribution table: top-``n`` owners by resident bytes,
        ``[{"owner", "bytes", "mb", "entries"}, ...]`` largest first.
        Pass an existing ``census()`` result to avoid a second probe
        walk."""
        if census_doc is None:
            census_doc = self.census()
        rows = [
            {
                "owner": name,
                "bytes": rec["bytes"],
                "mb": round(rec["bytes"] / (1024.0 * 1024.0), 1),
                "entries": rec["entries"],
            }
            for name, rec in census_doc.items()
            if rec["bytes"] > 0
        ]
        rows.sort(key=lambda r: r["bytes"], reverse=True)
        return rows[:n]

    def owner_entries(self, name: str) -> int:
        """One owner's entry count; -1 on an unknown owner or a failing
        probe (a bound check on it fails closed on negatives)."""
        with self._lock:
            probe = self._owners.get(name)
        if probe is None:
            rec = _ssz_census().get(name)
            return int(rec["entries"]) if rec else -1
        try:
            _nb, entries = probe()
            return int(entries)
        except Exception:  # noqa: BLE001 — fail closed, never raise into a gate
            return -1

    def owner_bytes(self, name: str) -> int:
        with self._lock:
            probe = self._owners.get(name)
        if probe is None:
            rec = _ssz_census().get(name)
            return int(rec["bytes"]) if rec else -1
        try:
            nbytes, _entries = probe()
            return int(nbytes)
        except Exception:  # noqa: BLE001
            return -1

    # -- phase RSS ledger ----------------------------------------------------
    def phase_begin(self, name: str) -> "tuple | None":
        """Open one phase bracket; returns the begin token the matching
        ``phase_end`` consumes, or None when ``name`` is not a phase
        span. Caller pre-guards with ``active``."""
        if not name.startswith(PHASE_PREFIXES):
            return None
        traced = 0
        if self._tracemalloc_started:
            import tracemalloc

            traced = tracemalloc.get_traced_memory()[0]
        return (rss_mb(), peak_rss_mb(), traced, time.perf_counter())

    def phase_end(self, name: str, token: tuple) -> None:
        rss0, peak0, traced0, t0 = token
        rss1 = rss_mb()
        peak1 = peak_rss_mb()
        traced_delta = 0
        if self._tracemalloc_started:
            import tracemalloc

            traced_delta = tracemalloc.get_traced_memory()[0] - traced0
        delta = rss1 - rss0
        # the bracket's transient headroom: only meaningful when the
        # process high-water mark MOVED inside this bracket (a stale
        # peak from an earlier, bigger phase must not be attributed
        # here) — then the watermark moment was inside this bracket and
        # sat (peak1 - rss0) above the bracket's floor, of which
        # max(0, delta) was retained
        transient = 0.0
        if peak1 > peak0:
            transient = max(0.0, (peak1 - rss0) - max(0.0, delta))
        with self._lock:
            agg = self._phases.get(name)
            if agg is None:
                agg = self._phases[name] = {
                    "count": 0,
                    "rss_delta_mb": 0.0,
                    "rss_end_mb": 0.0,
                    "peak_mb": 0.0,
                    "peak_growth_mb": 0.0,
                    "transient_mb": 0.0,
                    "seconds": 0.0,
                    "traced_delta_mb": 0.0,
                }
            agg["count"] += 1
            agg["rss_delta_mb"] += delta
            agg["rss_end_mb"] = rss1
            agg["peak_mb"] = max(agg["peak_mb"], peak1)
            agg["peak_growth_mb"] += max(0.0, peak1 - peak0)
            agg["transient_mb"] = max(agg["transient_mb"], transient)
            agg["seconds"] += time.perf_counter() - t0
            agg["traced_delta_mb"] += traced_delta / (1024.0 * 1024.0)
            if peak1 > peak0:
                self._peak_phase = name
        rec = _spans.RECORDER
        if rec.enabled:
            rec.add_instant(
                "memory.phase",
                time.perf_counter(),
                {"phase": name, "rss_mb": round(rss1, 1),
                 "delta_mb": round(delta, 2)},
                lane=rec.named_lane(_MEMORY_LANE),
            )

    def phase_ledger(self) -> dict:
        """Per-phase aggregates (consistent copy), rounded for JSON."""
        with self._lock:
            out = {
                name: {
                    key: (round(value, 3) if isinstance(value, float)
                          else value)
                    for key, value in agg.items()
                }
                for name, agg in self._phases.items()
            }
        return out

    def peak_phase(self) -> "str | None":
        """The last phase bracket that raised the process high-water
        mark — the peak's home."""
        with self._lock:
            return self._peak_phase

    # -- bandwidth ledger ----------------------------------------------------
    def record_copy(self, site: str, nbytes: int,
                    t0: "float | None" = None,
                    t1: "float | None" = None) -> None:
        """One bulk copy of ``nbytes`` at ``site``. Call sites
        pre-guard with ``active``. A timed window (t0/t1) additionally
        renders on the Chrome-trace ``memory`` lane."""
        with self._lock:
            agg = self._copies.get(site)
            if agg is None:
                agg = self._copies[site] = {"count": 0, "bytes": 0}
            agg["count"] += 1
            agg["bytes"] += nbytes
        _metrics.counter("memory.copies").inc()
        _metrics.counter("memory.copy_bytes").inc(nbytes)
        if t0 is not None and t1 is not None:
            rec = _spans.RECORDER
            if rec.enabled:
                rec.add_complete(
                    "memory.copy",
                    t0,
                    t1,
                    {"site": site, "bytes": nbytes},
                    lane=rec.named_lane(_MEMORY_LANE),
                )

    def copy_summary(self) -> dict:
        """Per-site copy aggregates plus process totals (the transfer-
        ledger shape)."""
        with self._lock:
            sites = {site: dict(agg) for site, agg in self._copies.items()}
        totals = {"count": 0, "bytes": 0}
        for agg in sites.values():
            totals["count"] += agg["count"]
            totals["bytes"] += agg["bytes"]
        return {"sites": sites, "totals": totals}

    # -- the /memory document ------------------------------------------------
    def snapshot(self, worst_n: int = 12) -> dict:
        tracked = TRACKED_LISTS
        census_doc = self.census()
        doc = {
            "observing": self.active,
            "rss_mb": round(rss_mb(), 1),
            "peak_rss_mb": round(peak_rss_mb(), 1),
            "tracked_lists": len(tracked) if tracked is not None else None,
            "census": census_doc,
            "worst": self.worst(worst_n, census_doc),
            "phase_ledger": self.phase_ledger(),
            "peak_phase": self.peak_phase(),
            "bandwidth": self.copy_summary(),
            "tracemalloc": {"tracing": self._tracemalloc_started},
        }
        if self._tracemalloc_started:
            doc["tracemalloc"]["top_sites"] = top_sites(8)
        return doc


OBSERVATORY = MemoryObservatory()


# ---------------------------------------------------------------------------
# the SSZ list walk: one pass over the tracked CachedRootList instances,
# distributed over per-structure owners. Shared buffers (column arrays /
# memos travel structurally across state copies) dedup by id().
# ---------------------------------------------------------------------------

_SSZ_OWNERS = (
    "ssz.columns",
    "ssz.bitpack",
    "ssz.root_cache",
    "ssz.pack_tree",
    "ssz.tree_memo",
    "ssz.pack_memo",
)


def _tree_bytes(tree) -> int:
    """Resident bytes of an IncrementalPaddedTree: its stored levels."""
    levels = getattr(tree, "levels", None)
    if not isinstance(levels, list):
        return 0
    return sum(len(level) for level in levels)


def _ssz_census() -> dict:
    """The per-structure byte census over every tracked list (see
    TRACKED_LISTS). Zero rows (not an error) while tracking has never
    been armed."""
    out = {name: {"bytes": 0, "entries": 0} for name in _SSZ_OWNERS}
    tracked = TRACKED_LISTS
    if tracked is None:
        return out
    lists = [ref() for ref in tracked.valuerefs()]  # snapshot, GC-safe
    seen: set = set()

    def add(owner: str, obj, nbytes: "int | None" = None) -> None:
        key = id(obj)
        if key in seen:
            return
        seen.add(key)
        rec = out[owner]
        rec["bytes"] += _nbytes(obj) if nbytes is None else nbytes
        rec["entries"] += 1

    for lst in lists:
        if lst is None:
            continue
        cc = getattr(lst, "_col_cache", None)
        if isinstance(cc, tuple):
            if cc[0] == "validators" and isinstance(cc[1], dict):
                for arr in cc[1].values():
                    add("ssz.columns", arr)
            elif cc[0] == "list":
                add("ssz.columns", cc[1])
        rc = getattr(lst, "_root_cache", None)
        if isinstance(rc, dict):
            for key, value in rc.items():
                if key == "bitpack":
                    add("ssz.bitpack", value)
                elif isinstance(value, tuple):
                    # ("tree", elem, limit) -> (chunks, root)
                    for part in value:
                        if isinstance(part, (bytes, bytearray)):
                            add("ssz.root_cache", part)
                elif isinstance(value, (bytes, bytearray)):
                    add("ssz.root_cache", value)
        pt = getattr(lst, "_pack_tree", None)
        if isinstance(pt, list) and len(pt) >= 3:
            add("ssz.pack_tree", pt[1])
            add("ssz.pack_tree", pt[2], _tree_bytes(pt[2]))
        tm = getattr(lst, "_tree_memo", None)
        if isinstance(tm, (list, tuple)) and len(tm) >= 3:
            add("ssz.tree_memo", tm[1])
            add("ssz.tree_memo", tm[2], _tree_bytes(tm[2]))
        pm = getattr(lst, "_pack_memo", None)
        if isinstance(pm, tuple):
            for part in pm[1:]:
                if isinstance(part, (bytes, bytearray)):
                    add("ssz.pack_memo", part)
    return out


# ---------------------------------------------------------------------------
# built-in owners: probes over the process-wide structures. Registered at
# import (probes are lazy — they import their subject module only when
# census() runs).
# ---------------------------------------------------------------------------


def _flight_ring_probe() -> "tuple[int, int]":
    """The flight recorder's ring (reference telemetry/memory.py:520): a
    size sample of up to 64 lineage records, extrapolated to the ring."""
    import sys

    from . import flight as _flight

    records = _flight.RECORDER.records()
    nbytes = 0
    for rec in records[:64]:  # bounded size sample; extrapolated below
        nbytes += sys.getsizeof(rec)
        for slot_name in getattr(type(rec), "__slots__", ()):
            value = getattr(rec, slot_name, None)
            if isinstance(value, (str, bytes, dict, list, tuple)):
                nbytes += sys.getsizeof(value)
    if records:
        nbytes = nbytes * len(records) // min(len(records), 64)
    return nbytes, len(records)


def _headstore_probe() -> "tuple[int, int]":
    """Every live ``serving.HeadStore`` (reference telemetry/memory.py:538):
    the frozen column bundles' bytes and the retained snapshots. A process
    that never imported ``serving/`` holds no store."""
    import sys

    _hs = sys.modules.get("ethereum_consensus_tpu_torch.serving.headstore")
    if _hs is None:
        return 0, 0
    nbytes = 0
    entries = 0
    for store in _hs.registered_stores():
        b, e = store.memory_census()
        nbytes += b
        entries += e
    return nbytes, entries


def _pool_probe() -> "tuple[int, int]":
    from ..pool import store as _pool_store

    nbytes = 0
    entries = 0
    for pool in list(_pool_store.registered_pools()):
        b, e = pool.memory_census()
        nbytes += b
        entries += e
    return nbytes, entries


def _shuffle_cache_probe() -> "tuple[int, int]":
    from ..models.phase0 import helpers as _h

    nbytes = 0
    entries = 0
    for entry in list(_h._SHUFFLE_CACHE.values()):
        entries += 1
        for part in entry:
            n = _nbytes(part)
            if n:
                nbytes += n
            elif isinstance(part, (list, tuple)):
                nbytes += len(part) * 8  # pointer-width estimate
    return nbytes, entries


def _mask_bundle_probe() -> "tuple[int, int]":
    from ..models import committees as _committees

    nbytes = 0
    entries = 0
    seen: set = set()
    for bundle in list(_committees.registered_bundles()):
        entries += 1
        for field in ("source", "target", "head", "covered",
                      "inclusion_delay", "inclusion_proposer"):
            arr = getattr(bundle, field, None)
            if arr is not None and id(arr) not in seen:
                seen.add(id(arr))
                nbytes += _nbytes(arr)
    return nbytes, entries


def _jit_cache_probe() -> "tuple[int, int]":
    """The epoch engine's kernel entries (the census delegates to
    ``epoch_vector.kernel_cache_census``). ``sys.modules`` gate: a census
    never imports the models."""
    import sys

    ev = sys.modules.get("ethereum_consensus_tpu_torch.models.epoch_vector")
    if ev is None:
        return 0, 0
    return ev.kernel_cache_census()


_BUILTIN_OWNERS = (
    ("flight.ring", _flight_ring_probe),
    ("serving.snapshots", _headstore_probe),
    ("pool.store", _pool_probe),
    ("phase0.shuffle_cache", _shuffle_cache_probe),
    ("committees.mask_bundles", _mask_bundle_probe),
    ("epoch_vector.jit_kernels", _jit_cache_probe),
)

for _name, _probe in _BUILTIN_OWNERS:
    OBSERVATORY.register_owner(_name, _probe)
del _name, _probe


# ---------------------------------------------------------------------------
# module-level conveniences (the device.py idiom)
# ---------------------------------------------------------------------------


def copy(site: str, nbytes: int, t0: "float | None" = None,
         t1: "float | None" = None) -> None:
    """Record one bulk copy (no-op while not observing; hot call sites
    pre-guard with ``OBSERVATORY.active`` so the off path is a single
    bool read)."""
    obs = OBSERVATORY
    if not obs.active:
        return
    obs.record_copy(site, nbytes, t0, t1)


@contextmanager
def phase(name: str):
    """Explicitly bracket a phase into the RSS ledger (a run's
    state-build/cold/warm brackets — names outside ``PHASE_PREFIXES``
    should use the ``mem.`` prefix so the facade filter admits them)."""
    obs = OBSERVATORY
    if not obs.active:
        yield
        return
    token = obs.phase_begin(name)
    try:
        yield
    finally:
        if token is not None:
            obs.phase_end(name, token)


def register_owner(name: str, probe) -> None:
    OBSERVATORY.register_owner(name, probe)


def census() -> dict:
    return OBSERVATORY.census()


def worst(n: int = 8) -> list:
    return OBSERVATORY.worst(n)


def owner_entries(name: str) -> int:
    return OBSERVATORY.owner_entries(name)


def owner_bytes(name: str) -> int:
    return OBSERVATORY.owner_bytes(name)


def top_sites(n: int = 8) -> list:
    """tracemalloc's top allocation sites (grouped by file) while
    tracing — empty when tracing is off."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        return []
    stats = tracemalloc.take_snapshot().statistics("filename")[:n]
    return [
        {
            "site": str(stat.traceback),
            "bytes": int(stat.size),
            "mb": round(stat.size / (1024.0 * 1024.0), 2),
            "count": int(stat.count),
        }
        for stat in stats
    ]


def start() -> MemoryObservatory:
    OBSERVATORY.start()
    return OBSERVATORY


def stop() -> None:
    OBSERVATORY.stop()


def is_observing() -> bool:
    return OBSERVATORY.active


@contextmanager
def observing():
    """Observe for the duration of the block; yields ``OBSERVATORY``."""
    start()
    try:
        yield OBSERVATORY
    finally:
        stop()


def snapshot(worst_n: int = 12) -> dict:
    return OBSERVATORY.snapshot(worst_n)
