"""The proof & light-client plane: stateless serving off stored levels.

The read plane's proofs (``serving/handlers.py`` serves them over HTTP):

* ``extract``    — single-branch generalized-index proofs read off the
                   incremental-HTR stored levels, cold ``Tree`` walk as
                   fallback + differential oracle, every large-layer
                   decline counted and journaled.
* ``multiproof`` — spec multiproof layout (``get_helper_indices`` /
                   ``calculate_multi_merkle_root``) with batched
                   extraction over one shared context; sub-group work
                   gathered columnar behind the mesh runtime's
                   ``proof_gather`` gate.
* ``light_client`` — ``LightClientBootstrap``/``Update``/finality/
                   optimistic production off ``HeadStore`` snapshots,
                   served at ``/eth/v1/beacon/light_client/*``.

Reference parity: ethereum_consensus_tpu/proofs/__init__.py.
"""

from .extract import ProofContext, extract_leaf, extract_proof
from .multiproof import (
    Multiproof,
    calculate_multi_merkle_root,
    extract_multiproof,
    get_helper_indices,
    verify_multiproof,
)

__all__ = [
    "ProofContext",
    "extract_proof",
    "extract_leaf",
    "Multiproof",
    "extract_multiproof",
    "get_helper_indices",
    "calculate_multi_merkle_root",
    "verify_multiproof",
]
