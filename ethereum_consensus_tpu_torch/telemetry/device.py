"""Device execution observatory: kernel-library, launch, transfer and
routing telemetry of the port's CUDA kernels.

One process-wide ``DeviceObservatory`` records

* a **compile ledger** — in the port only ``_kernels.load`` compiles:
  nvcc at first use, or the load of a library an earlier process built.
  Each library is recorded once, with its seconds and whether it was
  ``built`` or ``reused`` (``device.compiles``, ``device.compile_s``);
* a **call ledger** — every call through a callable wrapped by
  ``observe_jit`` (the ``models/epoch_vector.py jitted_kernels()``
  entries and the ``ops/`` dispatchers), with its shape signature in the
  reference's ``signature_of`` format and logical dtypes (a u64 column
  the port stores as int64 bit patterns reads ``uint64[64]``). A
  signature the callable has seen is a ``device.jit_cache.hits``; a
  first sighting a ``device.jit_cache.misses``; a first sighting by a
  callable that had seen another signature is a ``device.recompiles``
  (the drift sentinel: the counter counts every drift, the
  ``device.recompile`` trace event names the first drift of each
  callable once);
* a **launch ledger** — every kernel launch, by the name of its count in
  ``ops/*.py``, recorded where the wrapper adds to its count
  (``device.launches``);
* a **transfer ledger** — host→device and device→host copies counted and
  their logical bytes summed per call site (``device.transfer.{h2d,d2h}_
  {count,bytes}``; a u64 word is 8 bytes, a flag 1);
* a **routing journal** — every device-vs-host decision (the
  ``_device_flags`` threshold gates, the BLS pairing route, the
  ``epoch_vector`` engage/decline, the committee masks) with its choice,
  reason and threshold inputs (``device.route.{kind}.{choice}``).

Library loads, launches, transfers and routes render on a ``device``
virtual lane of the Chrome trace (``telemetry/spans.py named_lane``)
while spans record.

Cost discipline: ``OBSERVATORY.active`` is a plain bool read — the
instrumented call sites check it first and pay nothing else while the
observatory is off. Nothing here catches an exception of the code it
watches. This module imports only the standard library at import time;
``h2d``/``d2h`` import numpy and torch when called.

Reference parity: ethereum_consensus_tpu/telemetry/device.py, with the
XLA compile cache replaced by the kernel libraries and the launch ledger
added (ROADMAP Queue C names the counters' meaning here).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager

from .. import _env
from . import metrics as _metrics
from . import spans as _spans

__all__ = [
    "DeviceObservatory",
    "OBSERVATORY",
    "DEFAULT_CAPACITY",
    "observe_jit",
    "h2d",
    "d2h",
    "route",
    "launch",
    "library",
    "signature_of",
    "start",
    "stop",
    "is_observing",
    "observing",
    "snapshot",
]

DEFAULT_CAPACITY = 1 << 12

_DEVICE_LANE = "device"

# the signed dtype each numpy unsigned word type travels as (the port's
# word columns are signed bit patterns: torch's unsigned types lack the
# arithmetic)
_SIGNED_VIEW = {"uint64": "int64", "uint32": "int32", "uint16": "int16"}


def _dtype_name(a, hint: "str | None") -> "str | None":
    dtype = getattr(a, "dtype", None)
    if dtype is None:
        return None
    name = str(dtype)
    if name.startswith("torch."):
        name = name[len("torch."):]
        if hint is not None:
            return hint
    return name


def _render(a, hint: "str | None") -> str:
    shape = getattr(a, "shape", None)
    dtype = _dtype_name(a, hint)
    if shape is not None and dtype is not None:
        return f"{dtype}[{','.join(str(int(d)) for d in shape)}]"
    if isinstance(a, (bool, int, float, str, bytes)):
        return repr(a)
    return type(a).__name__


def signature_of(args: tuple, kwargs: dict, logical: tuple = ()) -> str:
    """A stable shape/dtype signature for one call: arrays render as
    ``dtype[d0,d1]``, static scalars by value, everything else by type
    name. ``logical[i]``, where given and not None, names the logical
    dtype of positional tensor ``i`` (``"uint64"`` for an int64 tensor of
    u64 words); numpy arrays carry their own."""
    parts = []
    for i, a in enumerate(args):
        parts.append(_render(a, logical[i] if i < len(logical) else None))
    for k in sorted(kwargs):
        parts.append(f"{k}={_render(kwargs[k], None)}")
    return "(" + ", ".join(parts) + ")"


class DeviceObservatory:
    """Process-wide ledger of device-side execution facts; one instance
    (``OBSERVATORY``) serves the whole process, started/stopped like the
    span recorder."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._compiles: deque = deque(maxlen=capacity)
        self._routes: deque = deque(maxlen=capacity)
        self._route_tally: dict = {}      # (kind, choice) -> count
        self._transfers: dict = {}        # site -> {h2d/d2h count/bytes}
        self._signatures: dict = {}       # fn -> set of seen signatures
        self._calls: dict = {}            # fn -> calls
        self._launches: dict = {}         # kernel -> launches
        self._sentinel_seen: set = set()  # fn names whose sentinel fired
        self.active = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Begin a fresh observation (drops previous ledgers)."""
        with self._lock:
            self._compiles.clear()
            self._routes.clear()
            self._route_tally.clear()
            self._transfers.clear()
            self._signatures.clear()
            self._calls.clear()
            self._launches.clear()
            self._sentinel_seen.clear()
            self.active = True

    def stop(self) -> None:
        """Stop observing (ledgers stay readable)."""
        with self._lock:
            self.active = False

    # -- compile ledger (kernel libraries) -----------------------------------
    def record_library(self, name: str, t0: float, t1: float,
                       built: bool) -> None:
        """One kernel library made ready by ``_kernels.load``: compiled by
        nvcc (``built``) or loaded from an earlier build."""
        seconds = max(0.0, t1 - t0)
        with self._lock:
            self._compiles.append(
                {
                    "fn": name,
                    "signature": "built" if built else "reused",
                    "compile_s": seconds,
                    "built": built,
                    "recompile": False,
                    "at": time.time(),
                }
            )
        _metrics.counter("device.compiles").inc()
        _metrics.histogram("device.compile_s").observe(seconds)
        rec = _spans.RECORDER
        if rec.enabled:
            rec.add_complete(
                "device.compile", t0, t1,
                {"library": name, "built": built},
                lane=rec.named_lane(_DEVICE_LANE),
            )

    # -- call ledger (observe_jit) -------------------------------------------
    def record_call(self, name: str, signature: str, t0: float,
                    t1: float) -> None:
        """One observed call: a hit when ``name`` had seen ``signature``,
        else a miss, and a recompile when it had seen another."""
        recompile_from = None
        with self._lock:
            known = self._signatures.get(name)
            if known is None:
                known = self._signatures[name] = set()
            self._calls[name] = self._calls.get(name, 0) + 1
            miss = signature not in known
            if miss:
                if known:
                    recompile_from = sorted(known)[-1]
                known.add(signature)
            fire_sentinel = (
                recompile_from is not None
                and name not in self._sentinel_seen
            )
            if fire_sentinel:
                self._sentinel_seen.add(name)
        if miss:
            _metrics.counter("device.jit_cache.misses").inc()
        else:
            _metrics.counter("device.jit_cache.hits").inc()
        if recompile_from is not None:
            _metrics.counter("device.recompiles").inc()
        if fire_sentinel:
            # one-shot per callable per observation: the counter counts
            # every drift, the event names the first
            from ..utils import trace

            trace.event(
                "device.recompile",
                fn=name,
                old_signature=recompile_from,
                new_signature=signature,
            )
        rec = _spans.RECORDER
        if rec.enabled:
            rec.add_complete(
                "device.call", t0, t1,
                {"fn": name, "signature": signature,
                 "recompile": recompile_from is not None},
                lane=rec.named_lane(_DEVICE_LANE),
            )

    # -- launch ledger -------------------------------------------------------
    def record_launch(self, kernel: str, count: int) -> None:
        """``count`` launches of ``kernel`` (the name of its count in
        ``ops/*.py``)."""
        with self._lock:
            self._launches[kernel] = self._launches.get(kernel, 0) + count
        _metrics.counter("device.launches").inc(count)
        rec = _spans.RECORDER
        if rec.enabled:
            rec.add_instant(
                "device.launch", time.perf_counter(),
                {"kernel": kernel, "count": count},
                lane=rec.named_lane(_DEVICE_LANE),
            )

    # -- transfer ledger -----------------------------------------------------
    def record_transfer(self, site: str, direction: str, count: int,
                        nbytes: int, t0: float, t1: float) -> None:
        """One host<->device transfer at ``site`` (``direction`` is
        ``h2d`` or ``d2h``)."""
        with self._lock:
            agg = self._transfers.get(site)
            if agg is None:
                agg = self._transfers[site] = {
                    "h2d_count": 0, "h2d_bytes": 0,
                    "d2h_count": 0, "d2h_bytes": 0,
                }
            agg[f"{direction}_count"] += count
            agg[f"{direction}_bytes"] += nbytes
        _metrics.counter(f"device.transfer.{direction}_count").inc(count)
        _metrics.counter(f"device.transfer.{direction}_bytes").inc(nbytes)
        rec = _spans.RECORDER
        if rec.enabled:
            rec.add_complete(
                f"device.{direction}",
                t0,
                t1,
                {"site": site, "bytes": nbytes, "count": count},
                lane=rec.named_lane(_DEVICE_LANE),
            )

    # -- routing journal -----------------------------------------------------
    def record_route(self, kind: str, choice: str, reason: str,
                     inputs: dict) -> None:
        """One device-vs-host decision: ``kind`` names the gate
        (``pairing``, ``sweeps``, ``shuffle``, ``bls_agg``,
        ``epoch_vector``, ...), ``choice`` where it went, ``reason`` why,
        and ``inputs`` the threshold arithmetic behind it."""
        with self._lock:
            key = (kind, choice)
            self._route_tally[key] = self._route_tally.get(key, 0) + 1
            self._routes.append(
                {
                    "kind": kind,
                    "choice": choice,
                    "reason": reason,
                    "inputs": dict(inputs),
                    "at": time.time(),
                }
            )
        _metrics.counter(f"device.route.{kind}.{choice}").inc()
        rec = _spans.RECORDER
        if rec.enabled:
            rec.add_instant(
                "device.route",
                time.perf_counter(),
                {"kind": kind, "choice": choice, "reason": reason},
                lane=rec.named_lane(_DEVICE_LANE),
            )

    # -- reading -------------------------------------------------------------
    def compiles(self) -> list:
        """Compile-ledger records (library loads), oldest first."""
        with self._lock:
            return [dict(r) for r in self._compiles]

    def routes(self, n: "int | None" = None) -> list:
        """Routing-journal records, oldest first; newest ``n`` if
        given."""
        with self._lock:
            records = [dict(r) for r in self._routes]
        return records if n is None else records[-n:]

    def route_tallies(self) -> dict:
        """Cumulative ``{kind: {choice: count}}`` over the whole
        observation (unbounded, unlike the journal ring)."""
        with self._lock:
            items = list(self._route_tally.items())
        out: dict = {}
        for (kind, choice), count in items:
            out.setdefault(kind, {})[choice] = count
        return out

    def transfer_summary(self) -> dict:
        """Per-site transfer aggregates plus process totals."""
        with self._lock:
            sites = {site: dict(agg) for site, agg in self._transfers.items()}
        totals = {"h2d_count": 0, "h2d_bytes": 0, "d2h_count": 0,
                  "d2h_bytes": 0}
        for agg in sites.values():
            for key in totals:
                totals[key] += agg[key]
        return {"sites": sites, "totals": totals}

    def signatures(self) -> dict:
        """``{fn: sorted seen signatures}`` — the shape census."""
        with self._lock:
            return {name: sorted(sigs)
                    for name, sigs in self._signatures.items()}

    def calls(self) -> dict:
        """``{fn: observed calls}``."""
        with self._lock:
            return dict(self._calls)

    def launches(self) -> dict:
        """``{kernel: launches}`` over the observation."""
        with self._lock:
            return dict(self._launches)

    def snapshot(self, journal_n: int = 128) -> dict:
        """Every ledger, JSON-ready."""
        mesh_env = _env.mode("ECT_MESH")
        compiles = self.compiles()
        return {
            "observing": self.active,
            "compile_ledger": {
                "compiles": len(compiles),
                "built": sum(1 for c in compiles if c["built"]),
                "total_compile_s": sum(c["compile_s"] for c in compiles),
                "recent": compiles[-journal_n:],
            },
            "call_ledger": {
                "calls": self.calls(),
                "signatures": self.signatures(),
            },
            "launch_ledger": self.launches(),
            "transfer_ledger": self.transfer_summary(),
            "routing_journal": {
                "tallies": self.route_tallies(),
                "recent": self.routes(journal_n),
            },
            "jit_cache": {
                "hits": _metrics.counter("device.jit_cache.hits").value(),
                "misses": _metrics.counter("device.jit_cache.misses").value(),
                "recompiles": _metrics.counter("device.recompiles").value(),
            },
            "mesh": {"env": mesh_env or "off"},
        }


OBSERVATORY = DeviceObservatory()


# ---------------------------------------------------------------------------
# the instrumentation seams (called from _kernels, ops/, models/, crypto/)
# ---------------------------------------------------------------------------


def observe_jit(fn, name: str, logical: tuple = ()):
    """Wrap a port callable so every call through it feeds the call
    ledger while the observatory is active (the reference's name, kept so
    a reader finds the counterpart). The inactive path is one bool read
    and one indirection. ``logical`` names the logical dtypes of
    positional tensors (see ``signature_of``)."""

    def observed(*args, **kwargs):
        obs = OBSERVATORY
        if not obs.active:
            return fn(*args, **kwargs)
        signature = signature_of(args, kwargs, logical)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        obs.record_call(name, signature, t0, time.perf_counter())
        return out

    observed.__name__ = name.rsplit(".", 1)[-1]
    observed.__qualname__ = name
    observed.__doc__ = fn.__doc__
    observed.__wrapped__ = fn
    return observed


def launch(kernel: str, count: int = 1) -> None:
    """Record ``count`` launches of ``kernel`` (no-op while not
    observing). Called where a wrapper adds to its launch count."""
    obs = OBSERVATORY
    if obs.active:
        obs.record_launch(kernel, count)


def library(name: str, t0: float, t1: float, built: bool) -> None:
    """Record one kernel library load (no-op while not observing)."""
    obs = OBSERVATORY
    if obs.active:
        obs.record_library(name, t0, t1, built)


def _host_array(a):
    """``a`` as a C-contiguous, writable numpy array whose unsigned words
    are viewed as their signed bit patterns."""
    import numpy as np

    arr = np.asarray(a)
    if not arr.flags.c_contiguous or not arr.flags.writeable:
        arr = np.array(arr, copy=True, order="C")
    signed = _SIGNED_VIEW.get(arr.dtype.name)
    return arr.view(signed) if signed is not None else arr


def _to_device(a, device):
    import torch

    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(_host_array(a)).to(device)


def h2d(site: str, *arrays, device="cuda"):
    """Every argument as a tensor on ``device`` (the host→device seam),
    recording count, logical bytes and seconds against ``site`` while
    observing. numpy unsigned words travel as their signed bit patterns
    (a u64 column counts 8 bytes a word). Returns a single tensor for a
    single argument, a tuple otherwise."""
    obs = OBSERVATORY
    if not obs.active:
        out = tuple(_to_device(a, device) for a in arrays)
        return out[0] if len(out) == 1 else out
    nbytes = sum(int(a.nbytes) for a in arrays)  # a u64 word and its int64 pattern: 8
    t0 = time.perf_counter()
    out = tuple(_to_device(a, device) for a in arrays)
    t1 = time.perf_counter()
    obs.record_transfer(site, "h2d", len(out), nbytes, t0, t1)
    return out[0] if len(out) == 1 else out


def d2h(site: str, tensor, dtype=None):
    """``tensor`` as a numpy array on the host (the device→host seam),
    viewed as ``dtype`` where given (``numpy.uint64`` for a column of u64
    words), recording against ``site`` while observing."""
    obs = OBSERVATORY
    if not obs.active:
        out = tensor.cpu().numpy()
        return out if dtype is None else out.view(dtype)
    t0 = time.perf_counter()
    out = tensor.cpu().numpy()
    if dtype is not None:
        out = out.view(dtype)
    t1 = time.perf_counter()
    obs.record_transfer(site, "d2h", 1, int(out.nbytes), t0, t1)
    return out


def route(kind: str, choice: str, reason: str, **inputs) -> None:
    """Journal one device-vs-host decision (no-op while not observing;
    hot call sites pre-guard with ``OBSERVATORY.active`` so the off
    path is a single bool read)."""
    obs = OBSERVATORY
    if not obs.active:
        return
    obs.record_route(kind, choice, reason, inputs)


# -- module-level lifecycle ---------------------------------------------------


def start() -> DeviceObservatory:
    OBSERVATORY.start()
    return OBSERVATORY


def stop() -> None:
    OBSERVATORY.stop()


def is_observing() -> bool:
    return OBSERVATORY.active


@contextmanager
def observing():
    """Observe for the duration of the block; yields ``OBSERVATORY``
    (the ``spans.recording`` idiom)."""
    start()
    try:
        yield OBSERVATORY
    finally:
        stop()


def snapshot(journal_n: int = 128) -> dict:
    return OBSERVATORY.snapshot(journal_n)
