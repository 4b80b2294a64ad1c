"""FaultInjector — deterministic infrastructure-fault injection for the
chain pipeline (the scenario harness's stage-B chaos hook).

Reference parity: ethereum_consensus_tpu/pipeline/faults.py.

The injector owns a per-(window seq, attempt) fault plan; the scheduler
asks it for a hook before every flush dispatch and runs that hook ON THE
VERIFIER WORKER immediately before verification (the ``pre`` parameter
of ``bls.verify_signature_sets_async``), so an injected fault surfaces
exactly where a real one would: inside the flush future.

Three fault shapes, matching the hardening they exercise
(scheduler.settle_oldest):

* ``fail_flush(seq, times)``  — ``TransientFlushError`` on the first
  ``times`` attempts of window ``seq``; the scheduler retries with
  bounded backoff (``FlushPolicy.flush_retries``) and the flush succeeds
  once the plan is exhausted.
* ``kill_worker(seq)``        — ``WorkerKilled`` from the worker
  mid-flush; the scheduler detects the death and degrades that window to
  in-line verification on the route the worker took (no hang, verdicts
  still exact).
* ``delay_flush(seq, s)``     — the worker sleeps ``s`` seconds before
  verifying; with ``s`` beyond ``FlushPolicy.settle_timeout_s`` the
  bounded settle raises ``PipelineBrokenError`` with the stuck window's
  attribution instead of deadlocking the submitter.

A fourth lane targets the MESH route (parallel/runtime.py): the injector
holds a per-kind budget of device faults (``fail_mesh("pairing"|
"epoch", times)``) consumed by ``runtime.fault_point`` inside the
sharded paths (parallel/pairing.py, parallel/epoch.py) while the
injector is installed (``install_mesh``/``uninstall_mesh``) — an
injected fault surfaces exactly where real device trouble would and the
decline is journaled (``mesh.decline.injected_fault``). Where the
reference's host fallback recovers, the port's seam raises
``MeshFaultInjected`` to the caller: the port runs no hidden host route
for a device failure (a pipeline window then breaks the pipeline, as any
device failure does, scheduler.py). Mesh injections land in
the same ``injected`` audit log with seq/attempt ``None`` (the mesh
seam is route-scoped, not window-scoped).

Thread-safety: the plan is written from the caller's thread and read
from both the engine thread (hook_for) and the worker (the hook itself);
every access holds the instance lock.
"""

from __future__ import annotations

import threading
import time

from ..telemetry import metrics
from ..utils import trace
from .errors import TransientFlushError, WorkerKilled

__all__ = ["FaultInjector"]


class FaultInjector:
    """Deterministic per-window fault plan for the verify scheduler."""

    def __init__(self):
        self._lock = threading.Lock()
        self._transient: dict = {}   # seq -> remaining failures
        self._kill: set = set()      # seqs whose worker dies mid-flush
        self._delay: dict = {}       # seq -> seconds of worker stall
        self._mesh: dict = {}        # route kind -> remaining device faults
        self._injected: list = []    # (seq, attempt, kind) audit log

    # -- plan construction (caller side) -------------------------------------
    def fail_flush(self, seq: int, times: int = 1) -> "FaultInjector":
        """Raise ``TransientFlushError`` on the first ``times`` verify
        attempts of window ``seq``."""
        with self._lock:
            self._transient[seq] = times
        return self

    def kill_worker(self, seq: int) -> "FaultInjector":
        """Kill the verifier worker mid-flush on window ``seq`` (every
        attempt — a dead worker stays dead)."""
        with self._lock:
            self._kill.add(seq)
        return self

    def delay_flush(self, seq: int, seconds: float) -> "FaultInjector":
        """Stall the worker ``seconds`` before verifying window ``seq``."""
        with self._lock:
            self._delay[seq] = float(seconds)
        return self

    def fail_mesh(self, kind: str, times: int = 1) -> "FaultInjector":
        """Plan ``times`` device faults on the mesh route ``kind``
        (``"pairing"`` / ``"epoch"``), consumed by
        ``parallel.runtime.fault_point`` while this injector is
        installed (``install_mesh``)."""
        with self._lock:
            self._mesh[kind] = self._mesh.get(kind, 0) + int(times)
        return self

    def install_mesh(self) -> "FaultInjector":
        """Arm the process-wide mesh fault seam with this injector's
        plan (parallel/runtime.install_fault_hook). Callers must
        ``uninstall_mesh`` when done — the seam is process-wide."""
        from ..parallel import runtime as _mesh_runtime

        _mesh_runtime.install_fault_hook(self.mesh_hook)
        return self

    def uninstall_mesh(self) -> None:
        from ..parallel import runtime as _mesh_runtime

        _mesh_runtime.install_fault_hook(None)

    def mesh_hook(self, kind: str) -> bool:
        """The seam's consumption callback: True exactly when a planned
        mesh fault for ``kind`` exists (one is consumed and audited)."""
        with self._lock:
            remaining = self._mesh.get(kind, 0)
            if remaining <= 0:
                return False
            self._mesh[kind] = remaining - 1
            self._injected.append((None, None, f"mesh_{kind}"))
        metrics.counter(f"pipeline.fault.injected.mesh_{kind}").inc()
        trace.event("pipeline.fault.injected", kind=f"mesh_{kind}")
        return True

    @property
    def injected(self) -> list:
        """(seq, attempt, kind) tuples, in injection order."""
        with self._lock:
            return list(self._injected)

    # -- hook resolution (scheduler side) ------------------------------------
    def hook_for(self, seq: int, attempt: int):
        """The pre-verify hook to run on the worker for this (window,
        attempt), or None when no fault is planned. The hook itself
        consumes the plan entry, so a retry of the same window re-asks
        and gets the NEXT planned behavior."""
        with self._lock:
            armed = (
                seq in self._kill
                or seq in self._delay
                or self._transient.get(seq, 0) > 0
            )
        if not armed:
            return None

        def fire() -> None:
            with self._lock:
                delay = self._delay.get(seq)
                kill = seq in self._kill
                remaining = self._transient.get(seq, 0)
                if remaining > 0:
                    self._transient[seq] = remaining - 1
                kind = (
                    "delay" if delay else
                    "worker_death" if kill else
                    "transient" if remaining > 0 else None
                )
                if kind is not None:
                    self._injected.append((seq, attempt, kind))
            if kind is None:
                return
            metrics.counter(f"pipeline.fault.injected.{kind}").inc()
            trace.event(
                "pipeline.fault.injected",
                seq=seq, attempt=attempt, kind=kind,
            )
            if delay:
                time.sleep(delay)
            if kill:
                raise WorkerKilled(f"injected worker death (window {seq})")
            if remaining > 0:
                raise TransientFlushError(
                    f"injected transient flush fault (window {seq}, "
                    f"attempt {attempt})"
                )

        return fire
