"""SSZ binary merkleization: merkleize, mix_in_length, zero-subtree cache,
generalized indices and single-branch Merkle proofs.

Reference parity: `ssz_rs`'s `hash_tree_root` / `prove` /
`is_valid_merkle_branch_for_generalized_index` machinery (see SURVEY.md L0,
ethereum-consensus/src/ssz/mod.rs:1-8 and
spec-tests/runners/light_client.rs:10-13).
"""

from __future__ import annotations

from . import hash as _hash_mod
from .hash import hash_bytes, hash_level, hash_pair

__all__ = [
    "BYTES_PER_CHUNK",
    "ZERO_CHUNK",
    "zero_hash",
    "merkleize",
    "merkleize_chunks",
    "mix_in_length",
    "mix_in_selector",
    "pack_bytes",
    "next_pow_of_two",
    "get_generalized_index_length",
    "get_generalized_index_bit",
    "concat_generalized_indices",
    "compute_merkle_proof",
    "is_valid_merkle_branch",
    "is_valid_merkle_branch_for_generalized_index",
    "IncrementalPaddedTree",
]

BYTES_PER_CHUNK = 32
ZERO_CHUNK = b"\x00" * BYTES_PER_CHUNK

# -- mesh merkleization seam --------------------------------------------------
#
# Installed by a multi-card runtime: large flat rebuilds (cold column
# materializations, whole-list roots) divide their leaf ranges over the
# cards. This module stays torch-free: the hook is PUSHED in (the
# register_device_hasher idiom,
# ssz/hash.py) and a None return — any device trouble, any shape the mesh
# cannot own — falls through to the host merkleizer below, which remains
# the differential oracle for every mesh root.

_MESH_MERKLEIZER = None
_MESH_MIN_CHUNKS: "int | None" = None


def register_mesh_merkleizer(fn, min_chunks: "int | None") -> None:
    """Install (or, with ``fn=None``, clear) the mesh merkleization hook:
    ``fn(chunks, limit) -> root | None`` for flat trees of at least
    ``min_chunks`` populated chunks."""
    global _MESH_MERKLEIZER, _MESH_MIN_CHUNKS
    _MESH_MERKLEIZER = fn
    _MESH_MIN_CHUNKS = min_chunks

# zero_hash(i) = root of a fully-zero subtree of depth i.
_ZERO_HASHES: list[bytes] = [ZERO_CHUNK]


def zero_hash(depth: int) -> bytes:
    while len(_ZERO_HASHES) <= depth:
        h = _ZERO_HASHES[-1]
        _ZERO_HASHES.append(hash_pair(h, h))
    return _ZERO_HASHES[depth]


def next_pow_of_two(value: int) -> int:
    if value <= 1:
        return 1
    return 1 << (value - 1).bit_length()


def pack_bytes(data: bytes) -> bytes:
    """Right-pad serialized basic values to a whole number of chunks."""
    rem = len(data) % BYTES_PER_CHUNK
    if rem:
        data = data + b"\x00" * (BYTES_PER_CHUNK - rem)
    return data


def merkleize_chunks(
    chunks: bytes, limit: int | None = None, level_offset: int = 0
) -> bytes:
    """Merkleize packed ``chunks`` (concatenated 32-byte chunks) into a root.

    ``limit`` is the chunk-count bound (virtual tree width); ``None`` means
    the tree width is the padded actual chunk count. Sparse padding uses the
    zero-subtree cache, so a List[..., 2**40] bound costs only ~40 extra
    hashes above the populated subtree.

    ``level_offset`` declares that each input "chunk" is actually the root
    of a full zero-padded subtree of that height, so sparse padding must
    use ``zero_hash(level_offset + i)`` per level — the contract the
    two-level tree memo needs to merkleize subtree mids (padding with leaf
    zero chunks there would change every sparse root).
    """
    if len(chunks) % BYTES_PER_CHUNK != 0:
        raise ValueError(
            f"chunks byte length {len(chunks)} is not a multiple of {BYTES_PER_CHUNK}; "
            "pack inputs with pack_bytes() first"
        )
    count = len(chunks) // BYTES_PER_CHUNK
    if limit is None:
        width = next_pow_of_two(count)
    else:
        if count > limit:
            raise ValueError(f"chunk count {count} exceeds limit {limit}")
        width = next_pow_of_two(limit)
    depth = (width - 1).bit_length()

    if count == 0:
        return zero_hash(depth + level_offset)

    # mesh-sharded rebuilds (parallel/runtime.py hook): big flat trees
    # split by leaf range over the device mesh. Bit-identical by
    # construction; a None return (device trouble, un-ownable shape)
    # falls through to the host path. Guarded to level_offset 0 — the
    # sharded reducer pads with the standard zero table.
    if (
        _MESH_MERKLEIZER is not None
        and level_offset == 0
        and count >= _MESH_MIN_CHUNKS
    ):
        root = _MESH_MERKLEIZER(chunks, limit)
        if root is not None:
            # exact level-sum work accounting, as _native_tree_root does
            n = count
            total = 0
            for _ in range(depth):
                n = (n + 1) // 2
                total += n
            _hash_mod.add_digests(total)
            return root

    # medium-to-large flat trees: one native call walks every level
    # (the per-level Python loop pays a join + two ctypes copies per
    # level — ~3x the hash cost at randao_mixes size). Trees big enough
    # that a level would route to the DEVICE hasher keep the loop.
    # (The native walk pads with the standard zero table, so it only
    # applies at level_offset 0.)
    if level_offset == 0 and 64 <= count < 2 * _hash_mod.DEVICE_MIN_NODES:
        root = _native_tree_root(chunks, depth)
        if root is not None:
            return root

    nodes = chunks
    for level in range(depth):
        n = len(nodes) // BYTES_PER_CHUNK
        if n % 2 == 1:
            nodes = nodes + zero_hash(level + level_offset)
        nodes = hash_level(nodes)
    return nodes


_ZH_JOINED: dict = {}


def _native_tree_root(chunks: bytes, depth: int) -> "bytes | None":
    """Whole-tree reduction in one native call (ec_merkle_root), or None
    when the native backend is unavailable."""
    from .. import native

    if not native.available():
        return None
    zh = _ZH_JOINED.get(depth)
    if zh is None:
        zh = b"".join(zero_hash(level) for level in range(depth + 1))
        _ZH_JOINED[depth] = zh
    # exact level-sum digest count (zero-pad siblings come from the
    # precomputed table, so each level costs ceil(n/2) compressions)
    n = len(chunks) // BYTES_PER_CHUNK
    total = 0
    for _ in range(depth):
        n = (n + 1) // 2
        total += n
    _hash_mod.add_digests(total)
    return native.merkle_root_native(chunks, depth, zh)


def merkleize(chunks: list[bytes], limit: int | None = None) -> bytes:
    return merkleize_chunks(b"".join(chunks), limit)


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash_pair(root, length.to_bytes(32, "little"))


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return hash_pair(root, selector.to_bytes(32, "little"))


# -- generalized indices -----------------------------------------------------


def get_generalized_index_length(index: int) -> int:
    """Depth of a generalized index (number of branch nodes in its proof)."""
    return index.bit_length() - 1


def get_generalized_index_bit(index: int, position: int) -> bool:
    return (index >> position) & 1 == 1


def _floor_pow_of_two(value: int) -> int:
    return 1 << (value.bit_length() - 1)


def concat_generalized_indices(*indices: int) -> int:
    out = 1
    for index in indices:
        fp = _floor_pow_of_two(index)
        out = out * fp + (index - fp)
    return out


def is_valid_merkle_branch(
    leaf: bytes, branch: list[bytes], depth: int, index: int, root: bytes
) -> bool:
    """Spec `is_valid_merkle_branch` (phase0): verify a depth/index proof."""
    value = leaf
    for i in range(depth):
        if (index >> i) & 1:
            value = hash_pair(branch[i], value)
        else:
            value = hash_pair(value, branch[i])
    return value == root


def is_valid_merkle_branch_for_generalized_index(
    leaf: bytes, branch: list[bytes], generalized_index: int, root: bytes
) -> bool:
    depth = get_generalized_index_length(generalized_index)
    index = generalized_index - (1 << depth)
    if len(branch) != depth:
        return False
    return is_valid_merkle_branch(leaf, branch, depth, index, root)


# -- proof construction ------------------------------------------------------


class Tree:
    """A fully materialized binary merkle tree over padded chunks, used for
    proof generation (``compute_merkle_proof``). Nodes are stored per level,
    level 0 = leaves."""

    def __init__(self, chunks: list[bytes], limit: int | None = None):
        count = len(chunks)
        width = next_pow_of_two(count if limit is None else limit)
        self.depth = (width - 1).bit_length()
        # Only materialize the populated region; zero-subtree roots fill the
        # rest. Each level hashes as ONE hash_level call so proof
        # construction rides the native/device backends instead of a
        # per-pair Python loop.
        level = list(chunks)
        self.levels: list[list[bytes]] = [level]
        for d in range(self.depth):
            if len(level) % 2 == 1:
                level = level + [zero_hash(d)]
            joined = hash_level(b"".join(level))
            nxt = [joined[i : i + 32] for i in range(0, len(joined), 32)]
            self.levels.append(nxt)
            level = nxt

    @property
    def root(self) -> bytes:
        if not self.levels[-1]:
            return zero_hash(self.depth)
        return self.levels[-1][0]

    def node(self, depth_from_leaves: int, index: int) -> bytes:
        level = self.levels[depth_from_leaves]
        if index < len(level):
            return level[index]
        return zero_hash(depth_from_leaves)

    def proof(self, leaf_index: int) -> list[bytes]:
        """Sibling branch for ``leaf_index``, leaf-level first."""
        branch = []
        index = leaf_index
        for d in range(self.depth):
            branch.append(self.node(d, index ^ 1))
            index >>= 1
        return branch


def compute_merkle_proof(chunks: list[bytes], leaf_index: int, limit: int | None = None) -> list[bytes]:
    return Tree(chunks, limit).proof(leaf_index)


# -- incremental padded tree (the dirty-group memo substrate) ----------------


class IncrementalPaddedTree:
    """Stored-levels binary merkle tree over a dynamic array of nodes, each
    node the root of a depth-``level_offset`` subtree, zero-padded to a
    virtual width of ``limit`` nodes.

    This is the TOP HALF of the two-level incremental hash_tree_root
    scheme (ssz/core.py): level-0 nodes are 4096-leaf group roots, and a
    single-group edit costs exactly the log-depth path to the root —
    ``set_node`` marks, ``root()`` recomputes only marked paths. Levels
    store the populated region only; sparse padding uses the zero-subtree
    table, so a List[..., 2**40] bound adds ~28 cheap path hashes, never
    width.
    """

    __slots__ = ("depth", "level_offset", "levels", "_dirty", "_root")

    def __init__(self, nodes: bytes, limit: int, level_offset: int = 0):
        width = next_pow_of_two(limit)
        self.depth = (width - 1).bit_length()
        self.level_offset = level_offset
        self.levels: list[bytearray] = [bytearray(nodes)]
        self._dirty: set[int] | None = None  # None => full (re)build pending
        self._root: bytes | None = None

    def clone(self) -> "IncrementalPaddedTree":
        new = IncrementalPaddedTree.__new__(IncrementalPaddedTree)
        new.depth = self.depth
        new.level_offset = self.level_offset
        new.levels = [bytearray(level) for level in self.levels]
        new._dirty = set(self._dirty) if self._dirty is not None else None
        new._root = self._root
        return new

    def node_count(self) -> int:
        return len(self.levels[0]) // 32

    def set_node(self, index: int, node: bytes) -> None:
        """Replace (or append at ``node_count()``) one level-0 node."""
        level0 = self.levels[0]
        n = len(level0) // 32
        if index == n:
            level0 += node
        elif index < n:
            level0[32 * index : 32 * (index + 1)] = node
        else:
            raise IndexError(f"node {index} beyond populated width {n}")
        if self._dirty is not None:
            self._dirty.add(index)

    def truncate(self, count: int) -> None:
        """Drop level-0 nodes beyond ``count`` (shrink is rare enough that
        it schedules a full level rebuild rather than path surgery)."""
        level0 = self.levels[0]
        if len(level0) // 32 > count:
            del level0[32 * count :]
            self._dirty = None

    def root(self) -> bytes:
        if self._dirty is None:
            self._rebuild()
        elif self._dirty:
            self._update_paths()
        self._dirty = set()
        return self._root  # type: ignore[return-value]

    def _rebuild(self) -> None:
        self.levels = self.levels[:1]
        cur = self.levels[0]
        for d in range(self.depth):
            data = bytes(cur)
            if (len(data) // 32) % 2 == 1:
                data += zero_hash(self.level_offset + d)
            cur = bytearray(hash_level(data)) if data else bytearray()
            self.levels.append(cur)
        self._root = (
            bytes(cur[:32]) if cur else zero_hash(self.level_offset + self.depth)
        )

    def _update_paths(self) -> None:
        indices = self._dirty
        for d in range(self.depth):
            cur = self.levels[d]
            n = len(cur) // 32
            nxt = self.levels[d + 1]
            parents = {i >> 1 for i in indices}
            for j in sorted(parents):
                left = bytes(cur[64 * j : 64 * j + 32])
                if 2 * j + 1 < n:
                    right = bytes(cur[64 * j + 32 : 64 * j + 64])
                else:
                    right = zero_hash(self.level_offset + d)
                parent = hash_pair(left, right)
                if 32 * j == len(nxt):
                    nxt += parent
                else:
                    nxt[32 * j : 32 * (j + 1)] = parent
            indices = parents
        self._root = bytes(self.levels[-1][:32])
