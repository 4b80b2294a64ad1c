"""Process-wide metrics registry: counters, gauges, histograms.

One lock-disciplined home for every operational counter the codebase
used to keep as ad-hoc module globals — the ``ssz/hash.py`` digest
count (previously an unlocked ``global`` incremented from both pipeline
threads), the ``crypto/bls.py`` pubkey-cache hits/misses/evictions and
bulk-decompress counts, the pairing-route decisions, and the
``pipeline.*`` counters ``PipelineStats`` views.

Semantics:

* **get-or-create by name** — ``counter(name)`` / ``gauge(name)`` /
  ``histogram(name)`` return the one process-wide instance for that
  name (double-checked under the registry lock); asking for an existing
  name with a different kind raises.
* **lock discipline** (speclint-checked) — every mutation holds the
  metric's own lock; reads are lock-free (a Python int/float load is
  atomic under the GIL). Counters are monotonic, so readers see a value
  that was true at some instant — exactly what delta arithmetic needs.
* **snapshot/delta** — ``snapshot()`` is a JSON-ready plain dict of
  every registered metric; ``delta(before, after)`` subtracts two
  snapshots (counters and histogram count/sum subtract; gauges report
  the ``after`` value — they are levels, not totals).

Naming convention (docs/OBSERVABILITY.md): dotted lowercase paths,
``<subsystem>.<object>.<what>`` — e.g. ``ssz.digests``,
``bls.pubkey_cache.hits``, ``pipeline.flushes``. Seconds-valued
counters end in ``_s``.
"""

from __future__ import annotations

import random
import threading
import zlib

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "counter",
    "gauge",
    "histogram",
    "registered",
    "registered_metrics",
    "snapshot",
    "delta",
]


class Counter:
    """Monotonic total (int or float increments)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def value(self):
        return self._value

    def __repr__(self) -> str:
        return f"Counter({self.name}={self._value})"


class Gauge:
    """A level: last-set value, plus a high-watermark helper."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def update_max(self, v) -> None:
        """Raise the gauge to ``v`` if larger (queue-depth high-watermark
        semantics)."""
        with self._lock:
            if v > self._value:
                self._value = v

    def value(self):
        return self._value

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self._value})"


class Histogram:
    """Counted observations with exact streaming count/sum/min/max and a
    FIXED-SIZE uniform reservoir of raw values (Vitter's algorithm R):
    after ``sample_limit`` observations, each new value replaces a
    random slot with probability ``sample_limit / count``, so the sample
    stays a uniform draw over the whole stream and memory is bounded no
    matter how many observations arrive (a 2^17 replay can't grow it
    linearly the way an append-only sample would). The exact aggregates
    are never sampled — ``summary()``/``snapshot()``/``delta()`` keep
    their semantics; only ``values()``/``quantiles()`` read the
    reservoir. The per-histogram RNG is seeded from the metric name, so
    a replay's reservoir is reproducible.

    **Exemplars** (the causal trace plane, docs/OBSERVABILITY.md):
    ``observe(v, trace_id=..., fields=...)`` additionally retains the
    observation in a bounded worst-N ``(value, trace_id, fields)``
    exemplar table beside the reservoir, so a p99 SLO gate can name
    *which* trace was the tail, not just how slow it was. The table is
    value-ordered and deterministic — insertion never touches the RNG,
    so the seeded-reservoir reproducibility contract is unchanged
    whether or not call sites pass trace ids. Observations carrying a
    trace_id that don't displace a retained exemplar are counted (the
    no-silent-caps rule; ``exemplar_dropped`` per table, summed
    process-wide into the ``metrics.exemplars_dropped`` counter)."""

    __slots__ = ("name", "_lock", "_count", "_sum", "_min", "_max", "_values",
                 "_rng", "sample_limit", "_exemplars", "_exemplar_dropped",
                 "exemplar_limit")

    def __init__(self, name: str, sample_limit: int = 1 << 12,
                 exemplar_limit: int = 8):
        self.name = name
        self.sample_limit = sample_limit
        self.exemplar_limit = exemplar_limit
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0
        self._min = None
        self._max = None
        self._values: list = []
        self._exemplars: list = []   # (value, trace_id, fields), ascending
        self._exemplar_dropped = 0
        self._rng = random.Random(zlib.crc32(name.encode("utf-8")))

    def observe(self, v, trace_id=None, fields=None) -> None:
        dropped = False
        with self._lock:
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if len(self._values) < self.sample_limit:
                self._values.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < self.sample_limit:
                    self._values[j] = v
            if trace_id is not None:
                ex = self._exemplars
                if len(ex) < self.exemplar_limit:
                    ex.append((v, trace_id, fields))
                    ex.sort(key=lambda e: e[0])
                elif v > ex[0][0]:
                    dropped = True  # the displaced smallest
                    ex[0] = (v, trace_id, fields)
                    ex.sort(key=lambda e: e[0])
                else:
                    dropped = True
                if dropped:
                    self._exemplar_dropped += 1
        # mirror into the process-wide drop counter outside self._lock
        # (never nest the registry lock under a metric lock)
        if dropped:
            counter("metrics.exemplars_dropped").inc()

    def exemplars(self) -> "list[dict]":
        """The worst-N exemplar table, largest value first: JSON-ready
        ``{"value", "trace_id", "fields"}`` dicts (``fields`` omitted
        when the call site passed none)."""
        with self._lock:
            ex = list(self._exemplars)
        out = []
        for v, trace_id, fields in reversed(ex):
            d = {"value": v, "trace_id": trace_id}
            if fields:
                d["fields"] = dict(fields)
            out.append(d)
        return out

    @property
    def exemplar_dropped(self) -> int:
        """Trace-carrying observations not retained in the bounded
        exemplar table (evicted smallest, or arrived below the current
        floor)."""
        return self._exemplar_dropped

    def reset_exemplars(self) -> None:
        """Clear the exemplar table (the drop tally survives — it is an
        accounting total, not a window statistic). The soak calls this
        at run start so every exemplar it reports resolves against the
        span recording it just began; the reservoir is untouched."""
        with self._lock:
            self._exemplars = []

    def summary(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
            lo, hi = self._min, self._max
        return {
            "count": count,
            "sum": total,
            "min": lo,
            "max": hi,
            "mean": (total / count) if count else None,
        }

    def values(self) -> list:
        """The bounded reservoir sample (uniform over the stream once it
        exceeds ``sample_limit``; the full stream in arrival order
        before that)."""
        with self._lock:
            return list(self._values)

    def quantiles(self, qs=(0.5, 0.9, 0.99)) -> dict:
        """{q: value} estimated from the reservoir (nearest-rank over
        the sorted sample); empty when nothing has been observed."""
        with self._lock:
            sample = sorted(self._values)
        if not sample:
            return {}
        top = len(sample) - 1
        return {
            q: sample[min(top, max(0, round(q * top)))] for q in qs
        }

    def __repr__(self) -> str:
        return f"Histogram({self.name}, n={self._count})"


# -- the process-wide registry ------------------------------------------------

_REGISTRY: dict = {}
_REGISTRY_LOCK = threading.Lock()


def _get_or_create(name: str, kind):
    metric = _REGISTRY.get(name)
    if metric is None:
        with _REGISTRY_LOCK:
            metric = _REGISTRY.get(name)
            if metric is None:
                metric = kind(name)
                _REGISTRY[name] = metric
    if not isinstance(metric, kind):
        raise TypeError(
            f"metric {name!r} is a {type(metric).__name__}, "
            f"not a {kind.__name__}"
        )
    return metric


def counter(name: str) -> Counter:
    """The process-wide counter named ``name`` (created on first use)."""
    return _get_or_create(name, Counter)


def gauge(name: str) -> Gauge:
    return _get_or_create(name, Gauge)


def histogram(name: str) -> Histogram:
    return _get_or_create(name, Histogram)


def registered() -> "list[str]":
    """Registered metric names, sorted."""
    return sorted(_REGISTRY)


def registered_metrics() -> list:
    """The registered metric OBJECTS, sorted by name (the introspection
    server's exposition walk — ``telemetry/server.py``)."""
    return [_REGISTRY[name] for name in sorted(_REGISTRY)]


def snapshot() -> dict:
    """JSON-ready ``{name: value}`` of every registered metric (histograms
    report their ``summary()`` dict). Consistent per metric, not across
    metrics — fine for monotonic-counter deltas."""
    out = {}
    for name in sorted(_REGISTRY):
        metric = _REGISTRY[name]
        if isinstance(metric, Histogram):
            out[name] = metric.summary()
        else:
            out[name] = metric.value()
    return out


def delta(before: dict, after: "dict | None" = None) -> dict:
    """``after - before`` over two snapshots (``after`` defaults to a
    fresh ``snapshot()``). Counters subtract; histogram ``count``/``sum``
    subtract (``min``/``max``/``mean`` describe the after-window only in
    mean's case, so the delta reports count/sum/mean-of-window); gauges
    are levels and report the ``after`` value. Metrics absent from
    ``before`` count from zero."""
    if after is None:
        after = snapshot()
    out = {}
    for name, now in after.items():
        prev = before.get(name)
        if isinstance(now, dict):  # histogram summary
            prev = prev if isinstance(prev, dict) else {}
            count = now.get("count", 0) - prev.get("count", 0)
            total = (now.get("sum") or 0) - (prev.get("sum") or 0)
            out[name] = {
                "count": count,
                "sum": total,
                "mean": (total / count) if count else None,
            }
        elif isinstance(_REGISTRY.get(name), Gauge):
            out[name] = now
        else:
            out[name] = now - (prev if isinstance(prev, (int, float)) else 0)
    return out
