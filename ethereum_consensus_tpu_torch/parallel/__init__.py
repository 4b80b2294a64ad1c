"""The sharded twins and the mesh runtime.

The reference shards its batch axes (merkle leaf ranges, validator-registry
rows, signature sets) over a 1-D device mesh from one process; the port's
mesh is an ordered tuple of torch devices driven the same way
(``mesh.py``). ``runtime.py`` is the production switch (``ECT_MESH=N|auto|
off``): it provisions one mesh per process and routes the altair epoch
sweeps (``epoch.py``), the RLC batch of a window (``pairing.py``) and large
flat ``hash_tree_root`` rebuilds (``merkle.py``) through it. Not imported
by the host layers: they consult a plain env read (``_env.mesh_requested``)
before importing ``runtime``.

``step.py`` is the distributed chain step of the graft entry
(``graft_entry.py``): the hysteresis sweep, its total and the balances root
sharded over a mesh, and the sharded altair epoch sweep step.

Reference parity: ethereum_consensus_tpu/parallel/ (``step.py``:
``make_chain_step`` :75, ``run_chain_step`` :174, ``make_epoch_sweep_step``
:201). ``runtime.proof_gather`` waits for the slice that ports ``proofs/``;
``_compat.py`` only wraps ``shard_map`` and has no counterpart.
"""

from .mesh import Mesh, all_gather, chip_mesh, default_device_mesh, psum_words
from .merkle import sharded_merkle_root_words, sharded_merkleize_chunks
from .step import make_chain_step
from .virtual_mesh import virtual_mesh

__all__ = [
    "Mesh",
    "all_gather",
    "chip_mesh",
    "default_device_mesh",
    "make_chain_step",
    "psum_words",
    "sharded_merkle_root_words",
    "sharded_merkleize_chunks",
    "virtual_mesh",
]
