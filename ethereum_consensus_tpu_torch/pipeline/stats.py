"""Pipeline counter surface — a per-run view over the telemetry registry.

Reference parity: ethereum_consensus_tpu/pipeline/stats.py.

The counters themselves live in the process-wide metrics registry
(``telemetry/metrics.py``) under ``pipeline.*`` names, so any consumer
of the registry — the bench ``metrics`` block, ``--metrics-out`` dumps —
sees pipeline activity without holding a ``PipelineStats`` reference.
One ``PipelineStats`` instance rides one ``ChainPipeline`` run and reads
as the DELTA since its construction: each counter property subtracts the
baseline captured in ``__init__``, and ``stop()`` freezes the view so a
finished run's numbers stay exact even after a later run increments the
shared registry counters.

Per-run-only shapes (the exact flush-size list and the queue-depth
high-watermark, which are max/list semantics a monotonic registry
counter can't replay) are kept on the instance and mirrored to the
registry (``pipeline.flush_size`` histogram,
``pipeline.queue_depth_high_watermark`` gauge).

Concurrency: all mutation is thread-safe (every write holds a lock —
the metric's own or the instance's). The per-run VIEW is exact when
runs don't overlap in time, which the engine guarantees for its own
stats (one pipeline owns one stats instance and ``stop()`` freezes it at
close/abort/failure); two pipelines deliberately run concurrently would
fold each other's counts into their live views, while the registry
totals stay correct either way.

The counters are the operational story of a run:

* throughput — blocks submitted/committed, wall seconds;
* flush shape — how many windowed flushes, how many sets each coalesced
  (the multi-pairing amortization the pipeline exists for);
* failure handling — rollbacks and sequential re-verifications;
* occupancy — how busy each stage was. Stage A is the host (state
  mutation + incremental HTR + signature collection, on the submitting
  thread); stage B is the verifier (the coalesced multi-pairings, on the
  background worker). Occupancies near 1.0 on BOTH stages mean the
  overlap is real; a stage near 0 is the bottleneck's complement.
"""

from __future__ import annotations

import threading
import time

from ..telemetry import metrics as _metrics

__all__ = ["PipelineStats"]

# the registry counters one run's view subtracts its baseline from;
# seconds-valued entries end in _s (float increments)
_COUNTER_NAMES = (
    "blocks_submitted",
    "blocks_committed",
    "flushes",
    "sets_flushed",
    "rollbacks",
    "sequential_reverifies",
    "checkpoints",
    "fault_retries",
    "degraded_flushes",
    "stage_a_s",
    "stage_b_s",
)


class PipelineStats:
    """Per-run delta view over the ``pipeline.*`` registry counters;
    all methods thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {
            name: _metrics.counter(f"pipeline.{name}")
            for name in _COUNTER_NAMES
        }
        self._base = {
            name: c.value() for name, c in self._counters.items()
        }
        self._frozen: "dict | None" = None
        self._flush_sizes: list = []
        self._queue_high_watermark = 0
        self._flush_size_hist = _metrics.histogram("pipeline.flush_size")
        self._queue_gauge = _metrics.gauge("pipeline.queue_depth_high_watermark")
        self._t_start: "float | None" = None
        self._t_end: "float | None" = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._t_start is None:
                self._t_start = time.perf_counter()

    def stop(self) -> None:
        """Stamp the end time and freeze the per-run counter view (a
        later run's registry increments no longer show through)."""
        frozen = {
            name: c.value() - self._base[name]
            for name, c in self._counters.items()
        }
        with self._lock:
            self._t_end = time.perf_counter()
            self._frozen = frozen

    @property
    def wall_s(self) -> float:
        with self._lock:
            if self._t_start is None:
                return 0.0
            end = self._t_end if self._t_end is not None else time.perf_counter()
            return end - self._t_start

    # -- the counter view ----------------------------------------------------
    def _view(self, name: str):
        frozen = self._frozen
        if frozen is not None:
            return frozen[name]
        return self._counters[name].value() - self._base[name]

    @property
    def blocks_submitted(self) -> int:
        return self._view("blocks_submitted")

    @property
    def blocks_committed(self) -> int:
        return self._view("blocks_committed")

    @property
    def flushes(self) -> int:
        return self._view("flushes")

    @property
    def sets_flushed(self) -> int:
        return self._view("sets_flushed")

    @property
    def rollbacks(self) -> int:
        return self._view("rollbacks")

    @property
    def sequential_reverifies(self) -> int:
        return self._view("sequential_reverifies")

    @property
    def checkpoints(self) -> int:
        return self._view("checkpoints")

    @property
    def fault_retries(self) -> int:
        return self._view("fault_retries")

    @property
    def degraded_flushes(self) -> int:
        return self._view("degraded_flushes")

    @property
    def stage_a_s(self) -> float:
        return self._view("stage_a_s")

    @property
    def stage_b_s(self) -> float:
        return self._view("stage_b_s")

    @property
    def flush_sizes(self) -> list:
        with self._lock:
            return list(self._flush_sizes)

    @property
    def queue_high_watermark(self) -> int:
        return self._queue_high_watermark

    # -- mutation ------------------------------------------------------------
    def block_submitted(self, stage_a_s: float) -> None:
        self._counters["blocks_submitted"].inc()
        self._counters["stage_a_s"].inc(stage_a_s)

    def blocks_were_committed(self, n: int) -> None:
        self._counters["blocks_committed"].inc(n)

    def flush_dispatched(self, n_sets: int) -> None:
        self._counters["flushes"].inc()
        self._counters["sets_flushed"].inc(n_sets)
        self._flush_size_hist.observe(n_sets)
        with self._lock:
            self._flush_sizes.append(n_sets)

    def stage_b_busy(self, seconds: float) -> None:
        self._counters["stage_b_s"].inc(seconds)

    def rollback(self) -> None:
        self._counters["rollbacks"].inc()

    def checkpoint(self) -> None:
        self._counters["checkpoints"].inc()

    def sequential_reverify(self) -> None:
        self._counters["sequential_reverifies"].inc()

    def fault_retry(self) -> None:
        self._counters["fault_retries"].inc()

    def degraded_flush(self) -> None:
        self._counters["degraded_flushes"].inc()

    def queue_depth(self, depth: int) -> None:
        self._queue_gauge.update_max(depth)
        with self._lock:
            if depth > self._queue_high_watermark:
                self._queue_high_watermark = depth

    # -- reading -------------------------------------------------------------
    def occupancy(self) -> dict:
        """Per-stage busy fraction of the run's wall clock."""
        wall = self.wall_s
        if wall <= 0.0:
            return {"stage_a": 0.0, "stage_b": 0.0}
        return {
            "stage_a": min(1.0, self.stage_a_s / wall),
            "stage_b": min(1.0, self.stage_b_s / wall),
        }

    def snapshot(self) -> dict:
        """A plain-dict copy (JSON-ready) of every counter."""
        wall = self.wall_s
        sizes = self.flush_sizes
        stage_a = self.stage_a_s
        stage_b = self.stage_b_s
        return {
            "blocks_submitted": self.blocks_submitted,
            "blocks_committed": self.blocks_committed,
            "flushes": self.flushes,
            "sets_flushed": self.sets_flushed,
            "flush_sizes": sizes,
            "max_flush_size": max(sizes) if sizes else 0,
            "mean_flush_size": (
                sum(sizes) / len(sizes) if sizes else 0.0
            ),
            "rollbacks": self.rollbacks,
            "sequential_reverifies": self.sequential_reverifies,
            "checkpoints": self.checkpoints,
            "fault_retries": self.fault_retries,
            "degraded_flushes": self.degraded_flushes,
            "stage_a_s": stage_a,
            "stage_b_s": stage_b,
            "wall_s": wall,
            "stage_a_occupancy": (
                min(1.0, stage_a / wall) if wall > 0 else 0.0
            ),
            "stage_b_occupancy": (
                min(1.0, stage_b / wall) if wall > 0 else 0.0
            ),
            "queue_high_watermark": self.queue_high_watermark,
        }

    def __repr__(self) -> str:
        s = self.snapshot()
        return (
            f"PipelineStats(blocks={s['blocks_committed']}/"
            f"{s['blocks_submitted']}, flushes={s['flushes']}, "
            f"rollbacks={s['rollbacks']}, "
            f"occ_a={s['stage_a_occupancy']:.2f}, "
            f"occ_b={s['stage_b_occupancy']:.2f})"
        )
