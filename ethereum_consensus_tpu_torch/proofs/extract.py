"""Branch extraction off the stored-levels tree memos.

A generalized-index walker that
serves single-branch Merkle proofs by READING the incremental-HTR
machinery instead of re-merkleizing. After a warm ``hash_tree_root``
walk, the big collections of a BeaconState carry stored levels —
``CachedRootList._pack_tree`` (packed basic / Bytes32 collections) and
``CachedRootList._tree_memo`` (scalar-leaf container registries), each
an ``IncrementalPaddedTree`` of 4096-chunk group mids (ssz/core.py) —
so every sibling at or above the group layer is a 32-byte slice read,
and the handful of sub-group siblings cost one 4096-chunk subtree
rebuild, memoized per extraction context.

Layers without stored levels materialize a full ``Tree`` over their top
chunks — the cold ``compute_merkle_proof`` walk, which doubles as the
differential oracle (``ssz.core.prove`` recomputes every sibling from
values; tests pin the two byte-identical). A LARGE layer (one whose
populated chunk count clears the dirty-tracking threshold) going cold is
a routing decision, never silent: each bumps a
``proofs.fallback.{reason}`` counter, journals a
``proofs.extract``/cold entry in the device observatory when it is
armed, and fires a one-shot re-armable trace event.

Reference parity: ethereum_consensus_tpu/proofs/extract.py (``ProofContext``
:299, ``_SubNodes`` :103, ``_StoredLevels`` :119).
"""

from __future__ import annotations

import threading

from ..ssz import core as _core
from ..ssz.core import CachedRootList
from ..ssz.merkle import (
    BYTES_PER_CHUNK,
    Tree,
    next_pow_of_two,
    pack_bytes,
    zero_hash,
)
from ..telemetry import device as _device_obs
from ..telemetry import metrics as _metrics
from ..utils import trace

__all__ = [
    "ProofContext",
    "extract_proof",
    "extract_leaf",
]

# Group geometry is shared with the memo substrate (one stored-level
# node spans one 2^_DIRTY_GROUP_SHIFT-chunk subtree; a layer only ever
# CARRIES stored levels above _DIRTY_TRACK_MIN_CHUNKS populated chunks)
# and is read DYNAMICALLY — off each tree's level_offset and the live
# core globals — because the shrunk-geometry test fixtures rebind them.

# one-shot fallback events re-arm on reason change (the mesh runtime's
# _DECLINE_LAST discipline): a soak that flips causes journals every
# transition, while the counters keep counting every occurrence
_FALLBACK_LAST: dict = {}
_FALLBACK_LOCK = threading.Lock()


def _fallback(kind: str, reason: str, **inputs) -> None:
    """Count + journal + one-shot-event one large layer served cold."""
    _metrics.counter(f"proofs.fallback.{reason}").inc()
    if _device_obs.OBSERVATORY.active:
        _device_obs.route(f"proofs.{kind}", "cold", reason, **inputs)
    if _FALLBACK_LAST.get(kind) != reason:
        with _FALLBACK_LOCK:
            if _FALLBACK_LAST.get(kind) != reason:
                _FALLBACK_LAST[kind] = reason
                trace.event(
                    "proofs.fallback", kind=kind, reason=reason, **inputs
                )


def _warm(kind: str, **inputs) -> None:
    if _device_obs.OBSERVATORY.active:
        _device_obs.route(f"proofs.{kind}", "warm", "stored_levels", **inputs)


class _ColdLayer:
    """One merkle layer fully materialized (the cold walk): top chunks
    rebuilt into a ``Tree``, every node a lookup thereafter. This is
    also the only provider for small layers — a container's field roots
    come off the instance caches, so 'cold' there is a few hashes."""

    warm = False

    __slots__ = ("depth", "n_chunks", "value", "_tree")

    def __init__(self, typ, value):
        chunks = _core._top_level_chunk_bytes(typ, value)
        limit = next_pow_of_two(_core._chunk_count_of(typ))
        self.depth = (limit - 1).bit_length()
        self.n_chunks = len(chunks) // BYTES_PER_CHUNK
        self.value = value  # pins id() for the context's layer key
        self._tree = Tree(
            [chunks[i : i + 32] for i in range(0, len(chunks), 32)], limit
        )

    def node(self, d: int, idx: int) -> bytes:
        return self._tree.node(d, idx)


class _SubNodes:
    """Interior nodes of one 4096-chunk group subtree, prebuilt by the
    batched columnar gather (proofs/multiproof.py): per-level flat byte
    strings, every group padded to full width so node(d, i) is a slice."""

    __slots__ = ("_levels",)

    def __init__(self, levels: "list[bytes]"):
        self._levels = levels

    def node(self, d: int, idx: int) -> bytes:
        level = self._levels[d]
        return level[32 * idx : 32 * (idx + 1)]


class _StoredLevels:
    """Warm provider over a pack-tree / tree-memo: siblings at or above
    the group layer read straight off ``IncrementalPaddedTree.levels``;
    sub-group siblings build (and memoize) one 4096-chunk subtree per
    touched group — for a single proof every sub-group sibling shares
    the target leaf's group, so the whole branch costs one rebuild."""

    warm = True

    __slots__ = ("depth", "n_chunks", "value", "_tree", "_group_chunks",
                 "_groups", "_ctx")

    def __init__(self, tree, group_chunks, n_chunks, value, ctx):
        self._tree = tree  # IncrementalPaddedTree, levels all fresh
        self._group_chunks = group_chunks  # g -> packed chunk segment
        self._groups: dict = {}  # g -> Tree | _SubNodes
        self._ctx = ctx
        self.depth = tree.depth + tree.level_offset
        self.n_chunks = n_chunks
        self.value = value

    def node(self, d: int, idx: int) -> bytes:
        gs = self._tree.level_offset
        if d >= gs:
            td = d - gs
            levels = self._tree.levels
            if td < len(levels):
                off = 32 * idx
                level = levels[td]
                if off < len(level):
                    return bytes(level[off : off + 32])
            return zero_hash(d)
        g = idx >> (gs - d)
        local = idx & ((1 << (gs - d)) - 1)
        sub = self._groups.get(g)
        if sub is None:
            pending = self._ctx.pending
            if pending is not None:
                # planning pass of the batched gather: record the group,
                # hand back a placeholder (node VALUES never steer the
                # descent, so the plan walk stays shape-faithful)
                pending.setdefault(self, set()).add(g)
                return zero_hash(d)
            seg = self._group_chunks(g)
            if not seg:
                return zero_hash(d)
            sub = Tree(
                [seg[i : i + 32] for i in range(0, len(seg), 32)],
                1 << gs,
            )
            self._groups[g] = sub
        return sub.node(d, local)


def _pack_provider(typ, values, key, esize, ctx):
    """Stored-levels provider off ``_pack_tree`` (packed basic / Bytes32
    collections), or (None, decline_reason)."""
    pt = values._pack_tree
    if pt is None:
        return None, "no_memo"
    if pt[0] != key:
        return None, "memo_key"
    raw, tree = pt[1], pt[2]
    if len(raw) != len(values) * esize:
        return None, "stale_buffer"
    if tree._dirty is None or tree._dirty:
        return None, "stale_tree"
    dg = values._dirty_groups
    if dg is None or dg:
        return None, "dirty_groups"
    # group width comes off the TREE, not the module constant: the
    # shrunk-geometry test fixtures rebuild memos under a smaller shift
    cbytes = BYTES_PER_CHUNK << tree.level_offset

    def group_chunks(g, raw=raw, cbytes=cbytes):
        return pack_bytes(bytes(raw[g * cbytes : (g + 1) * cbytes]))

    n_chunks = (len(raw) + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
    prov = _StoredLevels(tree, group_chunks, n_chunks, values, ctx)
    if prov.depth != (next_pow_of_two(_core._chunk_count_of(typ)) - 1).bit_length():
        return None, "depth_mismatch"
    return prov, None


def _tree_provider(typ, values, tkey, ctx):
    """Stored-levels provider off ``_tree_memo`` (scalar-leaf container
    registries: chunks are the joined element roots)."""
    tm = values._tree_memo
    if tm is None:
        return None, "no_memo"
    if tm[0] != tkey:
        return None, "memo_key"
    chunks, tree = tm[1], tm[2]
    if tree is None:
        return None, "no_levels"
    if len(chunks) != BYTES_PER_CHUNK * len(values):
        return None, "stale_buffer"
    if tree._dirty is None or tree._dirty:
        return None, "stale_tree"
    dg = values._dirty_groups
    if dg is None or dg:
        # None = tracking never armed (or lost); non-empty = sticky
        # groups whose elements refuse caching — either way the next
        # mutation would not be named, so the walker declines
        return None, "dirty_groups"
    cbytes = BYTES_PER_CHUNK << tree.level_offset

    def group_chunks(g, chunks=chunks, cbytes=cbytes):
        return bytes(chunks[g * cbytes : (g + 1) * cbytes])

    prov = _StoredLevels(
        tree, group_chunks, len(chunks) // BYTES_PER_CHUNK, values, ctx
    )
    if prov.depth != (next_pow_of_two(_core._chunk_count_of(typ)) - 1).bit_length():
        return None, "depth_mismatch"
    return prov, None


def _populated_chunks(typ, value) -> int:
    if isinstance(typ, type) and issubclass(typ, _core.Container):
        return len(typ.__ssz_fields__)
    if isinstance(typ, (_core.Vector, _core.List)):
        if _core._is_basic(typ.elem):
            size = typ.elem.fixed_size()
            return (len(value) * size + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
        return len(value)
    if isinstance(typ, (_core.Bitvector, _core.Bitlist)):
        return (len(value) + 255) // 256
    if isinstance(typ, (_core.ByteVector, _core.ByteList)):
        return (len(value) + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
    raise TypeError(f"cannot chunk {typ!r}")


def _build_layer(typ, value, ctx):
    """Provider for one merkle layer: warm stored levels when the memo
    substrate can serve them, cold ``Tree`` otherwise — with every
    large-layer decline counted and journaled."""
    n_chunks = _populated_chunks(typ, value)
    # dynamic read (not the import-time constant): the shrunk-geometry
    # fixtures lower the threshold so small layers classify as large
    large = n_chunks > _core._DIRTY_TRACK_MIN_CHUNKS
    prov = None
    reason = None
    if isinstance(typ, (_core.Vector, _core.List)):
        elem = typ.elem
        limit_elems = (
            typ.length if isinstance(typ, _core.Vector) else typ.limit
        )
        if not isinstance(value, CachedRootList):
            reason = "untracked_list"
        elif _core._is_basic(elem):
            key = ("u", elem, typ.chunk_count())
            prov, reason = _pack_provider(
                typ, value, key, elem.fixed_size(), ctx
            )
        elif isinstance(elem, _core.ByteVector) and elem.length == BYTES_PER_CHUNK:
            key = ("b32", elem, limit_elems)
            prov, reason = _pack_provider(typ, value, key, BYTES_PER_CHUNK, ctx)
        elif (
            isinstance(elem, type)
            and getattr(elem, "__ssz_scalar_leaf__", False)
        ):
            tkey = ("tree", elem, limit_elems)
            prov, reason = _tree_provider(typ, value, tkey, ctx)
        else:
            reason = "unsupported_kind"
    elif large:
        reason = "unsupported_kind"
    if prov is not None:
        _warm("extract", chunks=n_chunks, layer=type(typ).__name__)
        return prov
    if large:
        ctx.declines.append((type(typ).__name__, reason))
        _fallback(
            "extract", reason, chunks=n_chunks, layer=type(typ).__name__
        )
    return _ColdLayer(typ, value)


class ProofContext:
    """Extraction context for one (type, value): settles the incremental
    memos with a ``hash_tree_root`` walk (warm after a committed block:
    a memo hit), then resolves generalized indices to nodes through
    per-layer providers memoized across calls — a batch of proofs pays
    each layer and each 4096-chunk group subtree at most once."""

    def __init__(self, typ, value):
        self.typ = typ
        self.value = value
        # the settle: makes every eligible memo exist and match its
        # collection, and is the root every extracted branch must verify
        # against (warm case: served from the caches this walker reads)
        self.root = _core.hash_tree_root(typ, value)
        self.declines: list = []  # (layer_kind, reason) for large layers
        self.pending: "dict | None" = None  # batched-gather plan sink
        self._layers: dict = {}

    def _layer(self, typ, value):
        key = (id(typ), id(value))
        prov = self._layers.get(key)
        if prov is None:
            prov = _build_layer(typ, value, self)
            self._layers[key] = prov
        return prov

    def node_at(self, gindex: int, typ=None, value=None) -> bytes:
        """The 32-byte node at ``gindex`` in hash_tree_root(typ, value)
        — the warm twin of ``ssz.core.compute_subtree_root``."""
        if typ is None:
            typ, value = self.typ, self.value
        gindex = int(gindex)
        if gindex < 1:
            raise ValueError("generalized index must be >= 1")
        if gindex == 1:
            return _core.hash_tree_root(typ, value)
        bits = bin(gindex)[3:]  # descent path, MSB first
        if isinstance(typ, (_core.List, _core.Bitlist, _core.ByteList)):
            if bits[0] == "1":
                if len(bits) > 1:
                    raise ValueError("cannot descend into the length mix-in")
                return len(value).to_bytes(32, "little")
            bits = bits[1:]
            if not bits:
                prov = self._layer(typ, value)
                return prov.node(prov.depth, 0)
        prov = self._layer(typ, value)
        depth = prov.depth
        if len(bits) <= depth:
            return prov.node(depth - len(bits), int(bits, 2))
        chunk_index = int(bits[:depth], 2)
        elem_typ, elem_val = _core._element_at(typ, value, chunk_index)
        return self.node_at(int("1" + bits[depth:], 2), elem_typ, elem_val)

    def leaf(self, gindex: int) -> bytes:
        return self.node_at(gindex)

    def proof(self, gindex: int) -> "list[bytes]":
        """Single-branch proof for ``gindex``, leaf-level sibling first —
        the layout ``is_valid_merkle_branch_for_generalized_index``
        consumes, byte-identical to ``ssz.core.prove``."""
        g = int(gindex)
        if g < 1:
            raise ValueError("generalized index must be >= 1")
        branch = []
        while g > 1:
            branch.append(self.node_at(g ^ 1))
            g >>= 1
        _metrics.counter("proofs.served").inc()
        return branch

    def warm(self) -> bool:
        """True while no large layer has been served cold."""
        return not self.declines


def extract_proof(typ, value, gindex: int) -> "list[bytes]":
    """One-shot single-branch extraction (callers holding several
    requests against the same value should share a ``ProofContext``)."""
    return ProofContext(typ, value).proof(gindex)


def extract_leaf(typ, value, gindex: int) -> bytes:
    return ProofContext(typ, value).node_at(gindex)
