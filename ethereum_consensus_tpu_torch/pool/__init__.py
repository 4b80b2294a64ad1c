"""Operation pool + write data plane.

The repo's third data plane: the READ surface (``serving/``) serves
committed state, the pipeline applies blocks — this package ACCEPTS
traffic. Attestations, aggregates, voluntary exits, slashings, and
BLS-to-execution changes ingest at line rate: structural validation on
arrival, signatures deferred into windowed cross-message RLC flushes
(``admission.py``), aggregates held as packed uint64 bitfield matrices
with vectorized redundancy elimination and best-aggregate selection
(``store.py`` / ``selection.py``), blocks produced by draining the pool
against a ``HeadStore`` snapshot (``production.py``), and the whole
surface mounted as Beacon-API POST/GET endpoints plus ``/pool``
introspection (``handlers.py``).

Every artifact — pool views, selected aggregates, produced blocks, and
every rejection reason — is bit-identical to the per-message scalar
twin (``AdmissionEngine(rlc=False)`` + ``select_aggregates(scalar=
True)``), the live fallback and differential oracle.

Reference parity: ethereum_consensus_tpu/pool/.
"""

from .admission import REASONS, Admission, AdmissionEngine  # noqa: F401
from .handlers import PoolDataPlane  # noqa: F401
from .production import ProductionError, produce_block  # noqa: F401
from .selection import select_aggregates  # noqa: F401
from .store import AggregateGroup, OperationPool  # noqa: F401

__all__ = [
    "Admission",
    "AdmissionEngine",
    "AggregateGroup",
    "OperationPool",
    "PoolDataPlane",
    "ProductionError",
    "REASONS",
    "produce_block",
    "select_aggregates",
]
