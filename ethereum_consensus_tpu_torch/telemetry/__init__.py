"""Unified telemetry: structured spans, process-wide metrics, and the
device and memory observatories.

Stdlib-only submodules (importable from any layer; nothing here imports
torch at import time):

* ``spans``   — the in-process ring-buffer span recorder behind the
  ``utils/trace.py`` facade, with Chrome trace-event JSON export
  (Perfetto / ``chrome://tracing``). Off by default; one bool read while
  off.
* ``metrics`` — the process-wide counter/gauge/histogram registry with
  snapshot/delta semantics; the one home for operational counters
  (``ssz.digests``, ``bls.pairing_route.*``, ``epoch_vector.*``, ...).
* ``phases``  — the per-block phase attribution (sig batch / state HTR /
  committees / operations) from recorded transition spans.
* ``flight``  — the chain flight recorder: a bounded ring journal of
  per-block ``BlockLineage`` records assembled by the pipeline's
  commit/rollback hook, with JSONL export and a query API.
* ``device``  — the device execution observatory: kernel-library loads,
  the call ledger with its drift sentinel, the launch ledger, the
  host<->device transfer ledger, and the device-vs-host routing journal.
* ``memory``  — the memory & bandwidth observatory: resident-set census
  of the port's byte owners, phase RSS/allocation ledger bracketing the
  transition/epoch spans, and per-site bulk-copy byte counters.
* ``server``  — the live introspection server (``/metrics`` Prometheus
  exposition, ``/healthz``, ``/blocks``, ``/events`` SSE, and the mounted
  Beacon-API read plane). NOT imported here: it pulls in ``http.server``,
  which no compute layer needs — import
  ``ethereum_consensus_tpu_torch.telemetry.server`` explicitly.

Reference parity: ethereum_consensus_tpu/telemetry/__init__.py (:37-39).
"""

from __future__ import annotations

from . import flight, metrics, phases, spans
from . import device  # noqa: E402 — after spans/metrics (its imports)
from . import memory  # noqa: E402 — after spans/metrics (its imports)

__all__ = ["device", "flight", "memory", "metrics", "phases", "spans", "server"]
