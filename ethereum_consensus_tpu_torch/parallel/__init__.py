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

Reference parity: ethereum_consensus_tpu/parallel/. Left out until the
slices that reach them: ``step.py`` (the sharded chain step, reached from
``__graft_entry__.py``) and ``runtime.proof_gather`` (``proofs/``);
``_compat.py`` only wraps ``shard_map`` and has no counterpart.
"""

from .mesh import Mesh, all_gather, chip_mesh, default_device_mesh, psum_words
from .merkle import sharded_merkle_root_words, sharded_merkleize_chunks
from .virtual_mesh import virtual_mesh

__all__ = [
    "Mesh",
    "all_gather",
    "chip_mesh",
    "default_device_mesh",
    "psum_words",
    "sharded_merkle_root_words",
    "sharded_merkleize_chunks",
    "virtual_mesh",
]
