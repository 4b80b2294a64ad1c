"""Batched multi-index proofs: spec multiproof layout over one level-walk.

``extract_multiproof`` resolves N generalized indices in a single pass
over the stored levels: the spec ``get_helper_indices`` layout dedupes
every shared ancestor up front (two leaves under one subtree need ONE
helper above their join, not two overlapping branches), and the shared
``ProofContext`` memoizes layer providers and group subtrees, so the
batch reads each stored-level node at most once.

The sub-group work — the only hashing a warm batch pays — is gathered
columnar: a planning pass names every 4096-chunk group the batch will
touch, and the gather rebuilds ALL of them in one set of level passes
over a single concatenated buffer (each group padded to full width so
rows stay aligned), instead of one small tree walk per group. The route
is decided by ``parallel/runtime.py``'s ``proof_gather`` gate exactly
like the merkle rebuilds: a provisioned mesh + enough chunks engages the
columnar path (whose big ``hash_level`` calls ride the installed device
hasher: SHA-256's kernel, ``csrc/sha256.cu``, once a level has
``ssz.hash.DEVICE_MIN_NODES`` parents), a decline is counted and journaled,
and the groups build lazily on the host. A gate that raises (a mesh that
cannot be built) raises to the caller: the reference builds on the host
there.

Verification layout (consensus-specs ``ssz/merkle-proofs.md``):
``calculate_multi_merkle_root(leaves, proof, gindices)`` must equal the
object root; tests pin every leaf and helper byte-identical to the cold
``compute_subtree_root`` walk.

Reference parity: ethereum_consensus_tpu/proofs/multiproof.py
(``_columnar_group_build`` :125, ``extract_multiproof`` :177).
"""

from __future__ import annotations

from .. import _env
from ..ssz.hash import hash_level, hash_pair
from ..ssz.merkle import BYTES_PER_CHUNK
from ..telemetry import metrics as _metrics
from .extract import ProofContext, _SubNodes

__all__ = [
    "Multiproof",
    "get_branch_indices",
    "get_path_indices",
    "get_helper_indices",
    "calculate_multi_merkle_root",
    "extract_multiproof",
    "verify_multiproof",
]


# -- spec multiproof helpers (ssz/merkle-proofs.md) ---------------------------


def get_branch_indices(tree_index: int) -> "list[int]":
    """Sister-node gindices along the path from ``tree_index`` to the
    root — the nodes a single-item proof consists of."""
    out = [tree_index ^ 1]
    while out[-1] > 1:
        out.append((out[-1] // 2) ^ 1)
    return out[:-1]


def get_path_indices(tree_index: int) -> "list[int]":
    """Gindices on the path from ``tree_index`` to the root itself."""
    out = [tree_index]
    while out[-1] > 1:
        out.append(out[-1] // 2)
    return out[:-1]


def get_helper_indices(indices: "list[int]") -> "list[int]":
    """The minimal helper set for a multiproof of ``indices``: every
    branch sister not itself on (or derivable from) some path —
    deduped shared ancestors, sorted descending so leaves come first."""
    all_helper: set = set()
    all_path: set = set()
    for index in indices:
        all_helper.update(get_branch_indices(index))
        all_path.update(get_path_indices(index))
    return sorted(all_helper - all_path, reverse=True)


def calculate_multi_merkle_root(
    leaves: "list[bytes]", proof: "list[bytes]", indices: "list[int]"
) -> bytes:
    """Root from a spec-layout multiproof (the verifier side)."""
    if len(leaves) != len(indices):
        raise ValueError("one leaf per index required")
    helper_indices = get_helper_indices(indices)
    if len(proof) != len(helper_indices):
        raise ValueError(
            f"expected {len(helper_indices)} helpers, got {len(proof)}"
        )
    objects = dict(zip(indices, leaves))
    objects.update(zip(helper_indices, proof))
    keys = sorted(objects, reverse=True)
    pos = 0
    while pos < len(keys):
        k = keys[pos]
        if k in objects and k ^ 1 in objects and k // 2 not in objects:
            objects[k // 2] = hash_pair(
                objects[(k | 1) ^ 1], objects[k | 1]
            )
            keys.append(k // 2)
        pos += 1
    return objects[1]


# -- batched extraction -------------------------------------------------------


class Multiproof:
    """One batch's result: ``leaves[i]`` proves ``gindices[i]``; ``proof``
    is the helper-node list in ``get_helper_indices`` order."""

    __slots__ = ("gindices", "leaves", "proof")

    def __init__(self, gindices, leaves, proof):
        self.gindices = list(gindices)
        self.leaves = list(leaves)
        self.proof = list(proof)

    def verify(self, root: bytes) -> bool:
        return (
            calculate_multi_merkle_root(
                self.leaves, self.proof, self.gindices
            )
            == root
        )


def _columnar_group_build(pending: dict) -> None:
    """Rebuild every pending 4096-chunk group subtree in one set of
    level passes over a single concatenated buffer: each group padded to
    full width keeps rows aligned through every halving, so one
    ``hash_level`` call per level covers the whole batch (and is big
    enough for the device hasher the mesh runtime installs). Providers
    are cohorted by their tree's group shift — uniform in production,
    but the shrunk-geometry fixtures can mix widths."""
    cohorts: dict = {}  # group_shift -> (jobs, segs)
    for prov, groups in pending.items():
        gs = prov._tree.level_offset
        jobs, segs = cohorts.setdefault(gs, ([], []))
        gbytes = (1 << gs) * BYTES_PER_CHUNK
        for g in sorted(groups):
            if g in prov._groups:
                continue
            seg = prov._group_chunks(g)
            if len(seg) < gbytes:
                seg = seg + b"\x00" * (gbytes - len(seg))
            jobs.append((prov, g))
            segs.append(seg)
    for gs, (jobs, segs) in cohorts.items():
        if not jobs:
            continue
        per_level: "list[list[bytes]]" = []
        nodes = b"".join(segs)
        width = 1 << gs
        for _ in range(gs):
            per_level.append(
                [
                    nodes[i * width * 32 : (i + 1) * width * 32]
                    for i in range(len(jobs))
                ]
            )
            nodes = hash_level(nodes)
            width //= 2
        per_level.append(
            [nodes[32 * i : 32 * (i + 1)] for i in range(len(jobs))]
        )
        for at, (prov, g) in enumerate(jobs):
            prov._groups[g] = _SubNodes(
                [per_level[d][at] for d in range(gs + 1)]
            )


def _pending_chunks(pending: dict) -> int:
    return sum(
        len(groups) << prov._tree.level_offset
        for prov, groups in pending.items()
    )


def extract_multiproof(
    ctx_or_typ, value=None, gindices=None
) -> Multiproof:
    """Resolve ``gindices`` into a spec-layout multiproof in one
    level-walk. Accepts a shared ``ProofContext`` or a (typ, value)
    pair; duplicate indices are rejected (the spec layout is a set)."""
    if isinstance(ctx_or_typ, ProofContext):
        ctx = ctx_or_typ
    else:
        ctx = ProofContext(ctx_or_typ, value)
    gindices = [int(g) for g in gindices]
    if len(set(gindices)) != len(gindices):
        raise ValueError("duplicate generalized indices in a multiproof")
    for g in gindices:
        if g < 1:
            raise ValueError("generalized index must be >= 1")
    helpers = get_helper_indices(gindices)

    # planning pass: walk every index with the plan sink armed, naming
    # each sub-group subtree the batch will need — node values are
    # placeholders, the descent shape is what we are after
    ctx.pending = {}
    try:
        for g in gindices:
            ctx.node_at(g)
        for h in helpers:
            ctx.node_at(h)
        pending = {
            prov: {g for g in groups if g not in prov._groups}
            for prov, groups in ctx.pending.items()
        }
        pending = {p: gs for p, gs in pending.items() if gs}
    finally:
        ctx.pending = None

    n_chunks = _pending_chunks(pending)
    if n_chunks and _env.mesh_requested():
        from ..parallel import runtime as _runtime

        if _runtime.proof_gather(n_chunks) is not None:
            _columnar_group_build(pending)
    # otherwise the groups build lazily (per-group host Trees) as the
    # resolution pass touches them — a declining gate journaled why

    leaves = [ctx.node_at(g) for g in gindices]
    proof = [ctx.node_at(h) for h in helpers]
    _metrics.counter("proofs.batched").inc()
    return Multiproof(gindices, leaves, proof)


def verify_multiproof(
    leaves: "list[bytes]", proof: "list[bytes]", indices: "list[int]",
    root: bytes,
) -> bool:
    """The verifier side for callers that only see (leaves, proof, indices)
    triples."""
    return calculate_multi_merkle_root(leaves, proof, indices) == root
