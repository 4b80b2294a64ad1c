"""Chain pipeline: async block application with cross-block signature
batching.

``ChainPipeline`` (engine.py) turns the one-shot ``Executor`` into a
streaming engine: stage A speculatively applies each block on the host
(state mutation + incremental HTR, signatures collected, not verified);
stage B proves up to ``FlushPolicy.window_size`` consecutive blocks'
merged signature sets in one coalesced multi-pairing on a background
verifier, with a bounded in-flight queue (backpressure), rollback to the
last committed state on a failed flush, and exact structured-error
attribution. ``PipelineStats`` is the counter surface; ``python -m
ethereum_consensus_tpu_torch.pipeline --selfcheck`` is the smoke entry
point (on the card; ``--device cpu`` for the kernels' plain versions).

Reference parity: ethereum_consensus_tpu/pipeline/__init__.py, the same
exports. The device pairing route engages underneath ``crypto.bls``
exactly when ``ops.install()`` has routed it; its kernels (B6, B7) then
launch on the verifier's thread, and a kernel that fails raises out of
``submit``/``close`` instead of degrading (scheduler.py).
"""

from .engine import ChainPipeline
from .errors import PipelineBrokenError, TransientFlushError, WorkerKilled
from .faults import FaultInjector
from .scheduler import FlushPolicy, VerifyScheduler, Window, auto_verify_lanes
from .stats import PipelineStats

__all__ = [
    "ChainPipeline",
    "FaultInjector",
    "FlushPolicy",
    "PipelineBrokenError",
    "PipelineStats",
    "TransientFlushError",
    "VerifyScheduler",
    "Window",
    "WorkerKilled",
    "auto_verify_lanes",
]
