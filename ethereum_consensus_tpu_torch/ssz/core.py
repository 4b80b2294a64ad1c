"""SSZ (SimpleSerialize) type system: basic uints/bool, ByteVector/ByteList,
Vector/List, Bitvector/Bitlist, Container — serialization, strict
deserialization, hash_tree_root, JSON presentation serde, defaults and
generalized indices.

This replaces the reference's `ssz_rs` dependency plus its local
`ByteVector`/`ByteList` wrappers (ethereum-consensus/src/ssz/{mod,byte_vector,
byte_list}.rs) with a single idiomatic Python layer. Values are plain Python
objects (int, bool, bytes, list, Container instances); SSZ *types* are
descriptor objects exposing serialize/deserialize/hash_tree_root.

JSON convention follows the reference's serde layer
(ethereum-consensus/src/serde.rs): u64-ish scalars render as decimal strings,
byte types as 0x-hex.
"""

from __future__ import annotations

import functools
import struct
import time as _time
from itertools import starmap
from operator import attrgetter
from typing import Any

from ..telemetry import memory as _memory
from .hash import hash_level
from .merkle import (
    BYTES_PER_CHUNK,
    IncrementalPaddedTree,
    merkleize_chunks,
    mix_in_length,
    next_pow_of_two,
    pack_bytes,
    zero_hash,
)

__all__ = [
    "SSZType",
    "uint8",
    "uint16",
    "uint32",
    "uint64",
    "uint128",
    "uint256",
    "boolean",
    "Vector",
    "List",
    "Bitvector",
    "Bitlist",
    "ByteVector",
    "ByteList",
    "Container",
    "Union",
    "serialize",
    "deserialize",
    "hash_tree_root",
    "bulk_store",
    "INSTRUMENTED_LIST_MUTATORS",
    "instrumented_surface",
    "get_generalized_index",
    "prove",
    "compute_subtree_root",
    "DeserializeError",
]

OFFSET_SIZE = 4
MAX_LENGTH = 2**32  # offsets are u32


from ..error import DeserializationError as _DeserializationError  # noqa: E402


class DeserializeError(_DeserializationError, ValueError):
    """Malformed SSZ input.

    Part of BOTH hierarchies: the structured taxonomy
    (``error.DeserializationError`` — the reference surfaces ssz_rs
    failures through its Error enum, error.rs:15-33) and ``ValueError``
    (the natural Python contract for malformed bytes)."""


# ---------------------------------------------------------------------------
# Type descriptor base
# ---------------------------------------------------------------------------


class SSZType:
    """Base descriptor. Subclasses implement the SSZ type algebra."""

    # -- size ---------------------------------------------------------------
    def is_fixed_size(self) -> bool:
        raise NotImplementedError

    def fixed_size(self) -> int:
        raise NotImplementedError(f"{self} is variable-size")

    # -- codec --------------------------------------------------------------
    def serialize(self, value: Any) -> bytes:
        raise NotImplementedError

    def deserialize(self, data: bytes) -> Any:
        raise NotImplementedError

    # -- merkleization ------------------------------------------------------
    def hash_tree_root(self, value: Any) -> bytes:
        raise NotImplementedError

    def chunk_count(self) -> int:
        """Number of chunks at this type's merkle layer (spec chunk_count)."""
        raise NotImplementedError

    # -- values -------------------------------------------------------------
    def default(self) -> Any:
        raise NotImplementedError

    # -- presentation serde (reference serde.rs convention) -----------------
    def to_json(self, value: Any) -> Any:
        raise NotImplementedError

    def from_json(self, obj: Any) -> Any:
        raise NotImplementedError

    def __repr__(self) -> str:
        return self.__class__.__name__


# ---------------------------------------------------------------------------
# Basic types
# ---------------------------------------------------------------------------


class _UintType(SSZType):
    def __init__(self, byte_length: int):
        self.byte_length = byte_length
        self.bits = byte_length * 8
        self.max = (1 << self.bits) - 1

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return self.byte_length

    def serialize(self, value: int) -> bytes:
        if not isinstance(value, int) or isinstance(value, bool):
            raise TypeError(f"expected int for uint{self.bits}, got {type(value)}")
        if not 0 <= value <= self.max:
            raise ValueError(f"value {value} out of range for uint{self.bits}")
        return value.to_bytes(self.byte_length, "little")

    def deserialize(self, data: bytes) -> int:
        if len(data) != self.byte_length:
            raise DeserializeError(
                f"uint{self.bits}: expected {self.byte_length} bytes, got {len(data)}"
            )
        return int.from_bytes(data, "little")

    def hash_tree_root(self, value: int) -> bytes:
        return self.serialize(value).ljust(BYTES_PER_CHUNK, b"\x00")

    def chunk_count(self) -> int:
        return 1

    def default(self) -> int:
        return 0

    def to_json(self, value: int) -> str:
        return str(value)

    def from_json(self, obj: Any) -> int:
        value = int(obj)
        if not 0 <= value <= self.max:
            raise ValueError(f"value {value} out of range for uint{self.bits}")
        return value

    def __repr__(self) -> str:
        return f"uint{self.bits}"


class _BooleanType(SSZType):
    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return 1

    def serialize(self, value: bool) -> bytes:
        if not isinstance(value, (bool, int)) or value not in (0, 1):
            raise ValueError(f"expected boolean, got {value!r}")
        return b"\x01" if value else b"\x00"

    def deserialize(self, data: bytes) -> bool:
        if len(data) != 1 or data[0] not in (0, 1):
            raise DeserializeError(f"invalid boolean encoding: {data!r}")
        return data[0] == 1

    def hash_tree_root(self, value: bool) -> bytes:
        return self.serialize(value).ljust(BYTES_PER_CHUNK, b"\x00")

    def chunk_count(self) -> int:
        return 1

    def default(self) -> bool:
        return False

    def to_json(self, value: bool) -> bool:
        return bool(value)

    def from_json(self, obj: Any) -> bool:
        if isinstance(obj, bool):
            return obj
        raise ValueError(f"expected bool, got {obj!r}")

    def __repr__(self) -> str:
        return "boolean"


uint8 = _UintType(1)
uint16 = _UintType(2)
uint32 = _UintType(4)
uint64 = _UintType(8)
uint128 = _UintType(16)
uint256 = _UintType(32)
boolean = _BooleanType()


def _is_basic(typ: SSZType) -> bool:
    return isinstance(typ, (_UintType, _BooleanType))


# ---------------------------------------------------------------------------
# Parametrized type factory plumbing
# ---------------------------------------------------------------------------


class _Parametrized:
    """``Klass[args]`` returns a cached descriptor instance."""

    _cache: dict[tuple, SSZType] = {}

    def __class_getitem__(cls, params):
        if not isinstance(params, tuple):
            params = (params,)
        key = (cls, *params)
        inst = _Parametrized._cache.get(key)
        if inst is None:
            inst = cls(*params)  # type: ignore[call-arg]
            _Parametrized._cache[key] = inst
        return inst


# ---------------------------------------------------------------------------
# Byte types (hex-presented, bytes-valued)
# ---------------------------------------------------------------------------


class ByteVector(_Parametrized, SSZType):
    """Fixed-length byte string; JSON as 0x-hex.
    Parity: ethereum-consensus/src/ssz/byte_vector.rs."""

    def __init__(self, length: int):
        if length <= 0:
            raise ValueError("ByteVector length must be positive")
        self.length = length

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return self.length

    def serialize(self, value: bytes) -> bytes:
        value = bytes(value)
        if len(value) != self.length:
            raise ValueError(f"ByteVector[{self.length}]: got {len(value)} bytes")
        return value

    def deserialize(self, data: bytes) -> bytes:
        if len(data) != self.length:
            raise DeserializeError(f"ByteVector[{self.length}]: got {len(data)} bytes")
        return bytes(data)

    def hash_tree_root(self, value: bytes) -> bytes:
        return merkleize_chunks(pack_bytes(self.serialize(value)))

    def chunk_count(self) -> int:
        return (self.length + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK

    def default(self) -> bytes:
        return b"\x00" * self.length

    def to_json(self, value: bytes) -> str:
        return "0x" + bytes(value).hex()

    def from_json(self, obj: str) -> bytes:
        data = _bytes_from_hex(obj)
        if len(data) != self.length:
            raise ValueError(f"ByteVector[{self.length}]: got {len(data)} bytes")
        return data

    def __repr__(self) -> str:
        return f"ByteVector[{self.length}]"


class ByteList(_Parametrized, SSZType):
    """Bounded variable-length byte string; JSON as 0x-hex.
    Parity: ethereum-consensus/src/ssz/byte_list.rs."""

    def __init__(self, limit: int):
        self.limit = limit

    def is_fixed_size(self) -> bool:
        return False

    def serialize(self, value: bytes) -> bytes:
        value = bytes(value)
        if len(value) > self.limit:
            raise ValueError(f"ByteList[{self.limit}]: got {len(value)} bytes")
        return value

    def deserialize(self, data: bytes) -> bytes:
        if len(data) > self.limit:
            raise DeserializeError(f"ByteList[{self.limit}]: got {len(data)} bytes")
        return bytes(data)

    def hash_tree_root(self, value: bytes) -> bytes:
        value = self.serialize(value)
        root = merkleize_chunks(pack_bytes(value), limit=self.chunk_count())
        return mix_in_length(root, len(value))

    def chunk_count(self) -> int:
        return (self.limit + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK

    def default(self) -> bytes:
        return b""

    def to_json(self, value: bytes) -> str:
        return "0x" + bytes(value).hex()

    def from_json(self, obj: str) -> bytes:
        data = _bytes_from_hex(obj)
        if len(data) > self.limit:
            raise ValueError(f"ByteList[{self.limit}]: got {len(data)} bytes")
        return data

    def __repr__(self) -> str:
        return f"ByteList[{self.limit}]"


def _bytes_from_hex(obj: str) -> bytes:
    if not isinstance(obj, str) or not obj.startswith("0x"):
        raise ValueError(f"expected 0x-hex string, got {obj!r}")
    return bytes.fromhex(obj[2:])


# ---------------------------------------------------------------------------
# Homogeneous collections
# ---------------------------------------------------------------------------


# struct codes of the uints a fixed-size collection packs in one call
_UINT_CODES = {1: "B", 2: "H", 4: "I", 8: "Q"}


@functools.lru_cache(maxsize=None)
def _bulk_plan(elem: SSZType):
    """How a collection of ``elem`` values packs and unpacks in bulk: with
    one ``struct`` call (a uint of 1–8 bytes), by slicing (a byte vector),
    or a ``struct`` row an element (a container of such uints, booleans and
    byte vectors): ``(kind, code, keys, fields)``, or None for every other
    element type (the per-element path). The bulk paths give the
    per-element path's values and bytes; on input that path would refuse
    they step aside, so it raises its own errors."""
    if isinstance(elem, _UintType) and elem.byte_length in _UINT_CODES:
        return ("uint", _UINT_CODES[elem.byte_length], None, None)
    if isinstance(elem, ByteVector):
        return ("bytes", elem.length, None, None)
    if not (isinstance(elem, type) and issubclass(elem, Container)
            and elem.__init__ is Container.__init__ and elem.__ssz_fields__):
        return None
    codes = []
    for typ in elem.__ssz_fields__.values():
        if isinstance(typ, _UintType) and typ.byte_length in _UINT_CODES:
            codes.append(_UINT_CODES[typ.byte_length])
        elif isinstance(typ, _BooleanType):
            codes.append("B")
        elif isinstance(typ, ByteVector):
            codes.append(f"{typ.length}s")
        else:
            return None
    return ("row", struct.Struct("<" + "".join(codes)), tuple(elem.__ssz_fields__),
            tuple(elem.__ssz_fields__.values()))


def _column_ok(typ: SSZType, column: tuple) -> bool:
    """Every value of a row field is one the field's serialize takes as it
    is: exact ints in range, booleans, bytes of the vector's length."""
    if not column:
        return True
    kinds = set(map(type, column))
    if isinstance(typ, _UintType):
        return kinds == {int} and min(column) >= 0 and max(column) <= typ.max
    if isinstance(typ, _BooleanType):
        return kinds <= {bool, int} and set(column) <= {0, 1}
    return kinds == {bytes} and set(map(len, column)) == {typ.length}


def _serialize_bulk(elem: SSZType, values: list) -> "bytes | None":
    plan = _bulk_plan(elem)
    if plan is None:
        return None
    kind, code, keys, fields = plan
    if kind == "bytes":
        return b"".join(values) if _column_ok(elem, tuple(values)) else None
    if kind == "uint":
        if not values:
            return b""
        if set(map(type, values)) != {int} or min(values) < 0 or max(values) > elem.max:
            return None
        return struct.pack(f"<{len(values)}{code}", *values)
    try:
        rows = list(map(attrgetter(*keys), values))
    except AttributeError:
        return None
    if len(keys) == 1:
        rows = [(v,) for v in rows]
    columns = tuple(zip(*rows)) if rows else ((),) * len(keys)
    if not all(_column_ok(typ, column) for typ, column in zip(fields, columns)):
        return None
    return b"".join(starmap(code.pack, rows))


def _deserialize_bulk(elem: SSZType, data: bytes, n: int) -> "list | None":
    plan = _bulk_plan(elem)
    if plan is None:
        return None
    kind, code, keys, fields = plan
    if kind == "uint":
        return list(struct.unpack(f"<{n}{code}", data))
    if kind == "bytes":
        data = bytes(data)
        return [data[i : i + code] for i in range(0, n * code, code)]
    if not n:
        return []
    rows = code.iter_unpack(data)
    flags = [i for i, typ in enumerate(fields) if isinstance(typ, _BooleanType)]
    if flags:
        columns = list(zip(*rows))
        for i in flags:
            if max(columns[i]) > 1:
                return None
            columns[i] = map(bool, columns[i])
        rows = zip(*columns)
    new = object.__new__
    out = []
    for row in rows:
        obj = new(elem)
        obj.__dict__.update(zip(keys, row))
        out.append(obj)
    return out


def _serialize_homogeneous(elem: SSZType, values: list) -> bytes:
    if elem.is_fixed_size():
        packed = _serialize_bulk(elem, values)
        if packed is not None:
            return packed
        return b"".join(elem.serialize(v) for v in values)
    parts = [elem.serialize(v) for v in values]
    offset = OFFSET_SIZE * len(parts)
    out = bytearray()
    for part in parts:
        out += offset.to_bytes(OFFSET_SIZE, "little")
        offset += len(part)
    for part in parts:
        out += part
    return bytes(out)


def _deserialize_homogeneous(elem: SSZType, data: bytes, count: int | None) -> list:
    """``count`` fixed for Vector, None for List (derive from data)."""
    if elem.is_fixed_size():
        size = elem.fixed_size()
        if count is not None:
            if len(data) != size * count:
                raise DeserializeError(
                    f"expected {size * count} bytes for {count} elements, got {len(data)}"
                )
            n = count
        else:
            if len(data) % size != 0:
                raise DeserializeError(
                    f"byte length {len(data)} not a multiple of element size {size}"
                )
            n = len(data) // size
        values = _deserialize_bulk(elem, data, n)
        if values is not None:
            return values
        return [elem.deserialize(data[i * size : (i + 1) * size]) for i in range(n)]

    # variable-size elements: offset table
    if len(data) == 0:
        if count not in (None, 0):
            raise DeserializeError("expected elements, got empty data")
        return []
    if len(data) < OFFSET_SIZE:
        raise DeserializeError("truncated offset table")
    first = int.from_bytes(data[:OFFSET_SIZE], "little")
    if first % OFFSET_SIZE != 0 or first == 0:
        raise DeserializeError(f"invalid first offset {first}")
    n = first // OFFSET_SIZE
    if count is not None and n != count:
        raise DeserializeError(f"expected {count} elements, got {n}")
    offsets = [
        int.from_bytes(data[i * OFFSET_SIZE : (i + 1) * OFFSET_SIZE], "little")
        for i in range(n)
    ]
    offsets.append(len(data))
    values = []
    for i in range(n):
        if offsets[i] > offsets[i + 1]:
            raise DeserializeError("offsets not monotonic")
        values.append(elem.deserialize(data[offsets[i] : offsets[i + 1]]))
    return values


class CachedRootList(list):
    """A list that carries per-descriptor hash_tree_root caches, cleared
    by every mutating method. Containers wrap their plain-list field
    values in this (constructor, setattr, copy), so the big immutable-
    element collections of a BeaconState — randao_mixes (65,536 chunks
    mainnet), block_roots/state_roots (8,192), balances, slashings —
    merkleize once per mutation instead of once per hash_tree_root call
    (3-4 full-state roots per block, phase0/slot_processing.rs:45).

    The cache is CONSULTED only for collections whose elements are
    immutable values (uints, booleans, byte vectors): a list of
    containers can mutate through an element without touching the list,
    so those never populate it. NOTE: wrapping copies the caller's list
    — a detached alias of the original plain list no longer writes
    through (spec code always mutates via ``state.field[...]``, which is
    instrumented)."""

    __slots__ = ("_root_cache", "_pack_memo", "_uniform_kind",
                 "_elems_fresh", "_parents_registered", "_self_ref",
                 "_container_parents", "_mut_gen", "_pack_gen",
                 "_dirty_groups", "_tree_memo", "_pack_tree",
                 "_memos_owned", "_col_dirty", "_col_cache", "_col_owned",
                 "__weakref__")

    def __init__(self, *args):
        super().__init__(*args)
        # memory-observatory census hook (telemetry/memory.py): while
        # list tracking is armed, every new instance joins the weak map
        # the resident-set census walks; off path = one module-attribute
        # read + None check
        tracked = _memory.TRACKED_LISTS
        if tracked is not None:
            tracked[id(self)] = self
        self._root_cache: dict = {}
        # --- mutation-propagated dirty tracking (docs/INCREMENTAL_HTR.md)
        # Set of dirty 4096-element group indices accumulated since the
        # last serviced walk; None = tracking inactive (small list, never
        # walked, or an untrackable mutation lost the index map). Marked
        # by the instrumented list mutators and, for scalar-leaf container
        # elements, by Container.__setattr__ through the weak-parent chain
        # using the element's stamped index.
        self._dirty_groups: "set | None" = None
        # (key, chunks bytearray, IncrementalPaddedTree, root) for lists of
        # scalar-leaf containers: chunks = the joined element roots, tree =
        # the 4096-chunk group mids. Survives mutation (dirty groups name
        # exactly what to re-merkleize); shared structurally with copies
        # under _memos_owned copy-on-write.
        self._tree_memo: "list | None" = None
        # same shape for packed basic/bytes32 collections: (key, packed
        # bytearray, IncrementalPaddedTree, root)
        self._pack_tree: "list | None" = None
        # False after a copy shares _tree_memo/_pack_tree with a sibling:
        # the next splice clones before mutating (staleness therefore
        # costs one buffer copy, never a wrong root)
        self._memos_owned: bool = True
        # weakrefs to Containers whose instance root cache covers this
        # list as a field (the nested-root scheme): every mutation fires
        # their _ssz_root_dirty. None until a parent registers.
        self._container_parents: "list | None" = None
        # True only while every scalar-leaf container element is known
        # unchanged since the last full walk (elements notify through
        # weakref parents on __setattr__; every list mutation resets it).
        # Registration is one-time (_parents_registered) + incremental in
        # the mutators; _self_ref is the stable weakref handed out.
        self._elems_fresh: bool = False
        self._parents_registered: bool = False
        self._self_ref = None
        # --- element-level column invalidation (models/ops_vector.py,
        # docs/OPS_VECTOR.md). None = no columnar consumer attached;
        # set() = the ELEMENT indices whose values changed since the
        # consumer last drained. Activated by the registry-column cache
        # (which sets it to an empty set at build time) and maintained by
        # every sanctioned mutation channel — the instrumented list
        # mutators below, Container.__setattr__'s weak-parent notify for
        # container elements, and bulk_store's changed-indices contract.
        # Any mutation whose touched indices can't be named (structural
        # resize, reorder, uncertified bulk write) resets it to None, and
        # the consumer falls back to a full column rebuild. This is the
        # same single-writer discipline as _dirty_groups, at element
        # (not 4096-group) granularity, for host arrays instead of
        # merkle subtrees.
        self._col_dirty: "set | None" = None
        # The columnar view itself (an opaque record owned by
        # models/ops_vector.py) lives WITH the list so it travels across
        # state copies: _copy_value shares it structurally and drops
        # ownership on BOTH sides (the _tree_memo/_memos_owned
        # discipline) — whichever side refreshes first clones its arrays,
        # so staleness costs one buffer copy, never a wrong column.
        self._col_cache = None
        self._col_owned: bool = True
        # (key, packed_bytes, root) of the last merkleization, exempt
        # from mutation invalidation: correctness comes from comparing
        # the EXACT packed bytes on reuse, so a stale entry can only
        # miss, never lie. Turns the single-slot-write-per-block pattern
        # on big vectors (randao_mixes, block_roots, state_roots) into a
        # C-speed memcmp instead of a full tree rebuild.
        self._pack_memo: "tuple | None" = None
        # mutation generation + the generation the pack memo was taken
        # at: when they match AND the uniformity verdict certifies every
        # element immutable, the memo root is served without even
        # re-packing (the re-pack of a 131k-int balances list per state
        # root was the hot line of epoch slot processing). Mutators bump
        # _mut_gen; only successful packs advance _pack_gen.
        self._mut_gen: int = 0
        self._pack_gen: int = -1
        # uniformity verdict — ("bytes", L): every element is `bytes` of
        # exactly length L; ("int",): every element is a plain int.
        # Established by a full scan at hash time and MAINTAINED by the
        # instrumented mutators (a write of anything else resets it), so
        # big vectors/lists stop re-paying per-element type/size scans
        # on every rehash. Stored as a tuple; None = unknown.
        self._uniform_kind: "tuple | None" = None

    def _invalidate(self):
        self._root_cache.clear()

    def __reduce__(self):
        # pickle as a plain rebuild (fresh empty cache on restore)
        return (type(self), (list(self),))


# Dirty-group granularity: 4096 elements per group — one group of a
# scalar-leaf container list spans exactly one 4096-leaf merkle subtree
# (one chunk per element root). Module globals so the property tests can
# shrink the geometry and exercise many groups on small collections.
_DIRTY_GROUP_SHIFT = 12
# Above this many pending column-dirty element indices a full column
# rebuild is cheaper than maintaining (and later replaying) the set.
_COL_DIRTY_CAP = 1 << 16
# Track only collections whose merkle layer clears one group — below
# that a full re-merkleization is a single cheap native call anyway.
_DIRTY_TRACK_MIN_CHUNKS = 1 << 12


def _mutation_groups(name, args, pre_len, post_len):
    """Dirty element-index groups touched by an instrumented list mutation,
    or None when the mutation shifts surviving indices (tracking lost)."""
    gs = _DIRTY_GROUP_SHIFT
    if name == "__setitem__":
        i = args[0]
        if type(i) is int:
            if i < 0:
                i += pre_len
            return (i >> gs,)
        if type(i) is slice and post_len == pre_len:
            start, stop, step = i.indices(pre_len)
            if step == 1:
                if stop <= start:
                    return ()
                return range(start >> gs, ((stop - 1) >> gs) + 1)
        return None
    if name == "append":
        return (pre_len >> gs,)
    if name in ("extend", "__iadd__"):
        if post_len == pre_len:
            return ()
        return range(pre_len >> gs, ((post_len - 1) >> gs) + 1)
    if name == "pop":
        # only an end-pop preserves the surviving indices
        if not args or args[0] == -1 or args[0] == pre_len - 1:
            return (post_len >> gs,)
        return None
    # insert/remove/sort/reverse/__delitem__/__imul__/clear: index map gone
    return None


def _mutation_elems(name, args, pre_len, post_len):
    """Element indices touched by an instrumented list mutation, for the
    column-invalidation channel (``_col_dirty``), or None when the touched
    set can't be named (resize, reorder, slice-resize) — the columnar
    consumer then rebuilds. Stricter than ``_mutation_groups``: a column
    array has fixed length, so ANY length change loses tracking."""
    if post_len != pre_len:
        return None
    if name == "__setitem__":
        i = args[0]
        if type(i) is int:
            return ((i + pre_len) if i < 0 else i,)
        if type(i) is slice:
            start, stop, step = i.indices(pre_len)
            if step == 1:
                return range(start, stop)
        return None
    if name in ("extend", "__iadd__", "__imul__"):
        return ()  # length unchanged ⇒ empty payload / *1: content intact
    return None  # sort/reverse permute in place: index map gone


def _instrument(name):
    base = getattr(list, name)
    # single-element writers can keep the uniform-bytes verdict alive
    # when the incoming value matches it; everything else resets it
    value_pos = {"__setitem__": 1, "append": 0, "insert": 1}.get(name)

    def method(self, *args, **kwargs):
        self._root_cache.clear()
        self._elems_fresh = False
        self._mut_gen += 1
        cps = self._container_parents
        if cps is not None:
            # containers whose instance root covers this list field
            # (nested-root scheme) are now stale
            for _ref in cps:
                _p = _ref()
                if _p is not None:
                    _p._ssz_root_dirty()
        kind = self._uniform_kind
        if kind is not None:
            keep = False
            if value_pos is not None and len(args) > value_pos and not kwargs:
                v = args[value_pos]
                if kind[0] == "bytes":
                    keep = type(v) is bytes and len(v) == kind[1]
                elif kind[0] == "bool":  # bitfield lists
                    keep = type(v) is bool
                else:  # ("int",)
                    keep = type(v) is int
                if name == "__setitem__" and type(args[0]) is not int:
                    keep = False  # slice assignment: arbitrary payload
            if not keep:
                self._uniform_kind = None
        pre_len = len(self)
        result = base(self, *args, **kwargs)
        dg = self._dirty_groups
        if dg is not None:
            marks = _mutation_groups(name, args, pre_len, len(self))
            if marks is None:
                self._dirty_groups = None
            else:
                dg.update(marks)
        cd = self._col_dirty
        if cd is not None:
            elems = _mutation_elems(name, args, pre_len, len(self))
            if elems is None:
                self._col_dirty = None
            else:
                cd.update(elems)
        if self._parents_registered:
            # keep newly added container elements wired to this list (and
            # stamped with their index, so their mutations mark the right
            # dirty group) — the freshness scheme keeps seeing their
            # mutations (read back from the list itself: extend/slice
            # payloads may be one-shot iterables the base call consumed)
            if value_pos is not None and len(args) > value_pos:
                if name == "__setitem__" and type(args[0]) is not int:
                    sl = args[0]
                    added = list.__getitem__(self, sl)
                    idxs = range(*sl.indices(len(self)))
                elif name == "__setitem__":
                    i = args[0]
                    if i < 0:
                        i += len(self)
                    added = (args[1],)
                    idxs = (i,)
                elif name == "insert":
                    i = args[0]
                    if i < 0:
                        i = max(0, i + pre_len)
                    added = (args[1],)
                    idxs = (min(i, pre_len),)
                else:  # append
                    added = (args[value_pos],)
                    idxs = (pre_len,)
            elif name in ("extend", "__iadd__"):
                added = list.__getitem__(self, slice(pre_len, len(self)))
                idxs = range(pre_len, len(self))
            else:
                added = ()
                idxs = ()
            ref = self._self_ref
            for i, v in zip(idxs, added):
                if isinstance(v, Container):
                    d = v.__dict__
                    old = d.get("_ssz_idx")
                    if (
                        old is not None
                        and old != i
                        and old < len(self)
                        and list.__getitem__(self, old) is v
                    ):
                        # the same object now sits at two indices of THIS
                        # list: per-index dirty marking can't cover both
                        self._dirty_groups = None
                    d["_ssz_idx"] = i
                    ps = d.get("_ssz_parents")
                    if ps is None:
                        d["_ssz_parents"] = [ref]
                    elif ps[-1] is not ref:
                        ps.append(ref)
        return result

    method.__name__ = name
    return method


# The instrumented-mutator surface: every channel through which an SSZ
# value may legally mutate while keeping dirty tracking and the cache
# hierarchy sound. This tuple is the single source of truth — the loop
# below installs exactly these wrappers, ``instrumented_surface()``
# publishes them to tooling, and any list method NOT named here bypasses
# invalidation (which is why tools/speclint's mutation-purity analyzer
# flags raw ``list.<method>(...)`` calls outside this module).
INSTRUMENTED_LIST_MUTATORS = (
    "__setitem__",
    "__delitem__",
    "__iadd__",
    "__imul__",
    "append",
    "extend",
    "insert",
    "pop",
    "remove",
    "clear",
    "sort",
    "reverse",
)

for _name in INSTRUMENTED_LIST_MUTATORS:
    setattr(CachedRootList, _name, _instrument(_name))
del _name


def instrumented_surface() -> dict:
    """Machine-readable manifest of the instrumented mutation surface.

    Consumed by ``tools/speclint`` (the static mutation-purity analyzer
    derives its rule set from this instead of hard-coding names) and by
    ``tests/test_ssz_incremental.py`` (the runtime property test drives
    every public mutator listed here and asserts the incremental root
    matches a cold recompute), so the manifest, the analyzer, and the
    runtime invariants stay in lockstep.

    * ``list_mutators`` — every instrumented ``CachedRootList`` method;
      mutating an SSZ collection through anything else (e.g. a raw
      ``list.append(values, v)``) leaves dirty tracking stale.
    * ``public_list_mutators`` — the non-dunder subset, reachable as
      ordinary method calls from spec code.
    * ``container_field_write`` — attribute assignment on a Container
      routes through ``Container.__setattr__`` (the weak-parent chain);
      ``object.__setattr__`` / ``__dict__`` stores on SSZ *field* names
      bypass it.
    * ``bulk_mutators`` — module-level bulk entry points with an explicit
      changed-indices dirty contract.
    * ``column_channel`` — the element-level invalidation feed the
      registry-column cache (``models/ops_vector.py``) consumes: every
      sanctioned mutation channel above also marks ``_col_dirty`` (or
      resets it to None when the touched indices can't be named), so a
      columnar view stays delta-refreshable without any consumer-side
      hooks. Single consumer per list; drained under the same
      single-writer discipline as ``_dirty_groups``.
    """
    return {
        "list_type": "CachedRootList",
        "list_mutators": INSTRUMENTED_LIST_MUTATORS,
        "public_list_mutators": tuple(
            n for n in INSTRUMENTED_LIST_MUTATORS if not n.startswith("__")
        ),
        "container_field_write": "Container.__setattr__",
        "bulk_mutators": ("bulk_store",),
        "column_channel": {
            "dirty_slot": "_col_dirty",
            "consumer": "ethereum_consensus_tpu_torch.models.ops_vector",
            "markers": (
                "CachedRootList instrumented mutators",
                "Container.__setattr__",
                "bulk_store",
            ),
        },
    }


def _cacheable_elem(elem: SSZType) -> bool:
    """Element TYPES whose canonical values are immutable ⇒ the
    list-level root cache can engage (values still re-checked at store
    time by _cacheable_values)."""
    return isinstance(elem, (_UintType, _BooleanType, ByteVector))


def _cacheable_values(elem: SSZType, values: list) -> bool:
    """Store-time guard matching the container cache's: a bytearray in a
    ByteVector slot could mutate in place without passing through any
    instrumented CachedRootList method, so only all-`bytes` collections
    may cache. Uint/boolean values are ints/bools (immutable) — their
    lists always qualify."""
    if isinstance(elem, ByteVector):
        kind = getattr(values, "_uniform_kind", None)
        if kind is not None and kind[0] == "bytes":
            return True  # maintained by the instrumented mutators
        return all(type(v) is bytes for v in values)
    return True


def _group_mids(chunks: bytes) -> bytes:
    """Roots of consecutive ``2**_DIRTY_GROUP_SHIFT``-chunk groups in one
    set of hash_level passes. Sound because every group except the last is
    full and aligned, so the global per-level zero padding IS the last
    (partial) group's padding."""
    nodes = chunks
    for lvl in range(_DIRTY_GROUP_SHIFT):
        if (len(nodes) // 32) % 2:
            nodes += zero_hash(lvl)
        nodes = hash_level(nodes)
    return nodes


def _pack_tree_eligible(values, limit_chunks: int, count_chunks: int) -> bool:
    return (
        count_chunks > _DIRTY_TRACK_MIN_CHUNKS
        and limit_chunks % (1 << _DIRTY_GROUP_SHIFT) == 0
        and values._uniform_kind is not None
    )


def _packed_splice(elem, values, key, limit_chunks: int) -> "bytes | None":
    """Dirty-group incremental root for a packed basic/bytes32 collection:
    re-serialize ONLY the dirty 4096-element groups into the retained raw
    buffer, re-merkleize their 4096-chunk groups, and let the stored-level
    tree recompute the log-depth paths. Returns None whenever the memo,
    the tracking state, or the values don't support it (callers fall back
    to the full pack, which raises the structured errors)."""
    pt = values._pack_tree
    dg = values._dirty_groups
    if pt is None or dg is None or pt[0] != key:
        return None
    kind = values._uniform_kind
    if kind is None:
        return None
    if isinstance(elem, _UintType):
        if kind[0] != "int" or elem.byte_length > 8:
            return None
        esize = elem.byte_length
    elif isinstance(elem, ByteVector) and elem.length == BYTES_PER_CHUNK:
        if kind[0] != "bytes" or kind[1] != BYTES_PER_CHUNK:
            return None
        esize = BYTES_PER_CHUNK
    else:
        return None
    n = len(values)
    raw, tree, root = pt[1], pt[2], pt[3]
    if not dg:
        return root if len(raw) == n * esize else None
    gs = _DIRTY_GROUP_SHIFT
    gsize = 1 << gs
    # write-direction shortcut: a CLEAN list-resident column cache whose
    # dtype matches the wire width IS the list's content (the adoption /
    # refresh contracts of models/ops_vector.py), so dirty groups can
    # serialize straight off the array at C speed instead of converting
    # Python ints per element — the big win for the columnar-primary
    # epoch commit, whose bulk_store dirties every balance group at once
    col_arr = None
    if esize != BYTES_PER_CHUNK:
        cc = getattr(values, "_col_cache", None)
        if (
            cc is not None
            and cc[0] == "list"
            and values._col_dirty == set()
            and cc[1].shape[0] == n
            and cc[1].dtype.itemsize == esize
            and cc[1].dtype.kind == "u"
        ):
            col_arr = cc[1]
    # serialize every dirty range BEFORE touching the memo, with the same
    # strictness as serialize(): a non-conforming value sends the whole
    # walk to the fallback path and its structured errors
    _obs = _memory.OBSERVATORY
    _t0 = _time.perf_counter() if _obs.active else 0.0
    segs = []
    try:
        for g in sorted(dg):
            start = g << gs
            if start >= n:
                continue
            stop = min(n, start + gsize)
            if col_arr is not None:
                # astype(copy=False) is a no-op on little-endian hosts
                # and fixes the byte order on big-endian ones
                seg = col_arr[start:stop].astype(
                    "<u%d" % esize, copy=False
                ).tobytes()
                segs.append((start, stop, seg))
                continue
            seg_vals = list.__getitem__(values, slice(start, stop))
            if esize == BYTES_PER_CHUNK:
                seg = b"".join(seg_vals)
                if len(seg) != BYTES_PER_CHUNK * (stop - start):
                    return None
            else:
                import numpy as _np

                col = _np.asarray(seg_vals, dtype="<u8")
                if esize < 8 and bool((col >> (8 * esize)).any()):
                    return None
                seg = col.astype("<u%d" % esize).tobytes()
            segs.append((start, stop, seg))
    except (OverflowError, TypeError, ValueError):
        return None
    if not values._memos_owned:
        raw = bytearray(raw)
        tree = tree.clone()
        pt = [key, raw, tree, root]
        values._pack_tree = pt
        values._memos_owned = True
    if n * esize < len(raw):
        del raw[n * esize :]
    for start, stop, seg in segs:
        raw[start * esize : stop * esize] = seg
    # element-group -> chunk-group: one group spans gsize*esize bytes,
    # i.e. gsize*esize/32 chunks, so cg = g >> log2(32//esize). EVERY
    # dirty group names its chunk-group — including ranges now beyond the
    # shrunk length, whose chunk-group content changed by truncation alone
    pcl = 5 - (esize.bit_length() - 1)
    cbytes = BYTES_PER_CHUNK << gs
    total_chunks = (len(raw) + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
    n_cgs = (total_chunks + (1 << gs) - 1) >> gs
    tree.truncate(n_cgs)
    for cg in sorted({g >> pcl for g in dg}):
        if cg >= n_cgs:
            continue
        seg = bytes(raw[cg * cbytes : (cg + 1) * cbytes])
        if not seg:
            continue
        tree.set_node(cg, merkleize_chunks(pack_bytes(seg), limit=1 << gs))
    root = tree.root()
    pt[3] = root
    values._dirty_groups = set()
    if _obs.active:
        # bandwidth: exactly the bytes re-serialized into the retained
        # raw buffer (the dirty groups), timed over the whole splice
        _obs.record_copy(
            "ssz.packed_splice",
            sum(len(seg) for _start, _stop, seg in segs),
            _t0,
            _time.perf_counter(),
        )
    return root


def _merkleize_packed_memo(
    values, key, packed: bytes, limit: int, raw: "bytes | None" = None
) -> bytes:
    """merkleize_chunks with a mutation-surviving memo on CachedRootList
    inputs: reuse requires the exact same packed bytes (C-speed compare),
    so staleness can only cost a miss, never a wrong root.

    Collections big enough for dirty-group tracking instead build the
    retained raw buffer + stored-level group tree that _packed_splice
    services on later walks (mutators mark groups; only those re-pack and
    re-hash). FULL power-of-two vectors (randao_mixes, block_roots,
    state_roots — always fully populated, count == limit) below the
    tracking threshold keep the legacy mid-level memo: on a byte-diff
    miss, only the subtrees whose bytes changed re-hash plus the top
    tree."""
    if not isinstance(values, CachedRootList):
        return merkleize_chunks(packed, limit=limit)
    count = len(packed) // BYTES_PER_CHUNK
    if _pack_tree_eligible(values, limit, count):
        gs = _DIRTY_GROUP_SHIFT
        tree = IncrementalPaddedTree(
            _group_mids(packed), limit >> gs, level_offset=gs
        )
        root = tree.root()
        values._pack_tree = [
            key,
            bytearray(packed if raw is None else raw),
            tree,
            root,
        ]
        values._memos_owned = True
        values._dirty_groups = set()
        values._pack_memo = None
        values._pack_gen = -1
        return root
    two_level = (
        count == limit and count >= 4096 and (count & (count - 1)) == 0
    )
    memo = values._pack_memo
    if memo is not None and memo[0] == key:
        if memo[1] == packed:
            # byte-identical repack: refresh the generation stamp so the
            # NEXT walk can skip the repack entirely (gen fast path)
            values._pack_gen = values._mut_gen
            return memo[2]
        if two_level and len(memo) == 5 and len(memo[1]) == len(packed):
            _, old, _, mids, sub_chunks = memo
            bs = sub_chunks * BYTES_PER_CHUNK
            nsub = count // sub_chunks
            new_mids = bytearray(mids)
            try:
                import numpy as _np

                a = _np.frombuffer(packed, dtype=_np.uint8).reshape(nsub, bs)
                b = _np.frombuffer(old, dtype=_np.uint8).reshape(nsub, bs)
                changed = _np.nonzero((a != b).any(axis=1))[0].tolist()
            except Exception:  # noqa: BLE001 — no numpy: bytes-slice scan
                changed = [
                    i for i in range(nsub)
                    if packed[i * bs : (i + 1) * bs] != old[i * bs : (i + 1) * bs]
                ]
            for i in changed:
                new_mids[32 * i : 32 * (i + 1)] = merkleize_chunks(
                    packed[i * bs : (i + 1) * bs], limit=sub_chunks
                )
            mids = bytes(new_mids)
            root = merkleize_chunks(mids, limit=nsub)
            values._pack_memo = (key, packed, root, mids, sub_chunks)
            values._pack_gen = values._mut_gen
            return root
    if two_level:
        depth = count.bit_length() - 1
        k = depth // 2
        sub_chunks = 1 << k
        nodes = packed
        for _ in range(k):  # full vector: every level is exact, no padding
            nodes = hash_level(nodes)
        mids = nodes
        root = merkleize_chunks(mids, limit=count // sub_chunks)
        values._pack_memo = (key, packed, root, mids, sub_chunks)
        values._pack_gen = values._mut_gen
        return root
    root = merkleize_chunks(packed, limit=limit)
    values._pack_memo = (key, packed, root)
    values._pack_gen = values._mut_gen
    return root


_BULK_ROOTS_MIN = 2048  # below this, per-element hashing beats the setup

# two-level tree memo (see the registry walk): subtree group size and the
# minimum joined-chunks size that justifies keeping mids around
_TREE_SUB_CHUNKS = 1 << 12
_TREE_TWO_LEVEL_MIN_BYTES = (1 << 14) * 32


def _bulk_scalar_leaf_roots(elem_cls, values) -> "bytes | None":
    """COLD-WALK bulk path: the concatenated hash_tree_roots of a large
    list of scalar-leaf containers (the validator registry), computed
    columnar — one numpy/bytes column per field, three native
    ``hash_level`` passes over one contiguous buffer — instead of a
    Python call tree per element. A 2^20-validator registry walk drops
    from ~20s of per-element overhead to ~2s. Returns None when any
    value doesn't conform (caller falls back to the per-element path,
    which raises structured errors); populates every element's
    ``_htr_cache`` on success so later walks go incremental."""
    import numpy as np

    fields = elem_cls.__ssz_fields__
    n = len(values)
    leaves = 1 << (len(fields) - 1).bit_length()  # next pow2 (1 for F=1)
    buf = np.zeros((n, leaves, 32), dtype=np.uint8)
    for j, (name, typ) in enumerate(fields.items()):
        try:
            col_vals = [v.__dict__[name] for v in values]
        except KeyError:
            return None
        # strictness parity with the per-element path (serialize): every
        # check below runs as one C-speed set/map pass, and any value the
        # strict path would REJECT sends the whole walk to the fallback,
        # which raises the structured error — the bulk path must never
        # silently root what serialize() refuses (a truncated float, a
        # bool in a uint slot, compensating wrong-length byte vectors).
        if isinstance(typ, _BooleanType):
            # type check FIRST: it keys on always-hashable types, making
            # the value-set check safe (no unhashable surprises)
            if not set(map(type, col_vals)) <= {bool, int} or not (
                set(col_vals) <= {0, 1}
            ):
                return None
            buf[:, j, 0] = np.fromiter(col_vals, dtype=np.uint8, count=n)
        elif isinstance(typ, _UintType) and typ.byte_length <= 8:
            size = typ.byte_length
            if set(map(type, col_vals)) != {int}:  # excludes bool/float
                return None
            try:
                col = np.fromiter(col_vals, dtype=np.uint64, count=n)
            except (TypeError, ValueError, OverflowError):
                return None  # negative or >= 2^64
            if size < 8 and bool((col >> (8 * size)).any()):
                return None  # out-of-range for the field width
            buf[:, j, :8] = col.astype("<u8").view(np.uint8).reshape(n, 8)
        elif isinstance(typ, ByteVector) and typ.length <= 64:
            length = typ.length
            if set(map(type, col_vals)) != {bytes} or set(
                map(len, col_vals)
            ) != {length}:
                # per-element type AND length checks: a 47+49 pair would
                # fool a joined-total check (same pitfall the b32 fast
                # path documents), and a bytearray joins fine but would
                # defeat cache invalidation
                return None
            joined = b"".join(col_vals)
            col = np.frombuffer(joined, dtype=np.uint8).reshape(n, length)
            if length <= 32:
                buf[:, j, :length] = col
            else:
                # two chunks -> one hash level collapses them to one leaf
                # (the 48-byte pubkey case)
                pair = np.zeros((n, 64), dtype=np.uint8)
                pair[:, :length] = col
                buf[:, j, :] = np.frombuffer(
                    hash_level(pair.tobytes()), dtype=np.uint8
                ).reshape(n, 32)
        else:
            return None  # uint256 / nested / unknown: not columnar
    nodes = buf.tobytes()
    while len(nodes) > n * 32:
        nodes = hash_level(nodes)
    for i, v in enumerate(values):
        v.__dict__["_htr_cache"] = nodes[32 * i : 32 * (i + 1)]
    return nodes


def _pack_memo_gen_hit(values, key) -> bool:
    """True when the pack memo can be served WITHOUT re-packing: nothing
    mutated the list since the memo was stored (generation match — the
    instrumented mutators are the only mutation channel once the
    uniformity verdict certifies every element immutable) and the memo
    belongs to this (descriptor, limit)."""
    return (
        isinstance(values, CachedRootList)
        and values._uniform_kind is not None
        and values._pack_gen == values._mut_gen
        and values._pack_memo is not None
        and values._pack_memo[0] == key
    )


def _tree_splice(elem, values, tkey) -> "bytes | None":
    """Dirty-group incremental root for a list of scalar-leaf containers:
    re-join the element roots of ONLY the dirty 4096-element groups (the
    untouched elements in those groups serve their instance caches), re-
    merkleize those groups, and let the stored-level tree walk the
    log-depth paths. Returns None when the memo or tracking state can't
    support it — the caller falls back to the discovery walk."""
    tm = values._tree_memo
    dg = values._dirty_groups
    if tm is None or dg is None or tm[0] != tkey or tm[2] is None:
        return None
    chunks, tree, root = tm[1], tm[2], tm[3]
    n = len(values)
    if not dg:
        return root if len(chunks) == 32 * n else None
    if not values._memos_owned:
        chunks = bytearray(chunks)
        tree = tree.clone()
        tm = [tkey, chunks, tree, root]
        values._tree_memo = tm
        values._memos_owned = True
    gs = _DIRTY_GROUP_SHIFT
    gsize = 1 << gs
    if 32 * n < len(chunks):
        del chunks[32 * n :]
    htr = elem.hash_tree_root
    sticky = set()
    for g in sorted(dg):
        start = g << gs
        if start >= n:
            continue
        stop = min(n, start + gsize)
        parts = []
        clean = True
        for v in list.__getitem__(values, slice(start, stop)):
            r = v.__dict__.get("_htr_cache")
            if r is None:
                r = htr(v)
                if "_htr_cache" not in v.__dict__:
                    # element refused caching (a mutable field value can
                    # change without notifying): its group must recompute
                    # on every walk until the value is replaced
                    clean = False
            parts.append(r)
        if not clean:
            sticky.add(g)
        seg = b"".join(parts)
        chunks[32 * start : 32 * stop] = seg
        tree.set_node(g, merkleize_chunks(seg, limit=gsize))
    tree.truncate((n + gsize - 1) >> gs)
    root = tree.root()
    tm[3] = root
    values._dirty_groups = sticky
    values._elems_fresh = not sticky
    return root


def _finish_container_walk(values, tkey, chunks, limit_elems, tm) -> bytes:
    """Full-walk tail for a scalar-leaf container list: serve the exact
    chunks-compare memo, group-diff against the retained chunks when a
    tree exists (the discovery path, now only reached after untracked
    mutations), or build the dirty-group tree for future splices."""
    gs = _DIRTY_GROUP_SHIFT
    gsize = 1 << gs
    if tm is not None and tm[1] == chunks:
        return tm[3]
    n_chunks = len(chunks) // BYTES_PER_CHUNK
    eligible = n_chunks > _DIRTY_TRACK_MIN_CHUNKS and limit_elems % gsize == 0
    bs = BYTES_PER_CHUNK << gs
    if tm is not None and tm[2] is not None and eligible:
        old = tm[1]
        tree = tm[2] if values._memos_owned else tm[2].clone()
        n_groups = (n_chunks + gsize - 1) >> gs
        tree.truncate(n_groups)
        for g in range(n_groups):
            seg = chunks[g * bs : (g + 1) * bs]
            if bytes(old[g * bs : (g + 1) * bs]) != seg:
                tree.set_node(g, merkleize_chunks(seg, limit=gsize))
        root = tree.root()
        values._tree_memo = [tkey, bytearray(chunks), tree, root]
        values._memos_owned = True
        return root
    if eligible:
        tree = IncrementalPaddedTree(
            _group_mids(chunks), limit_elems >> gs, level_offset=gs
        )
        root = tree.root()
        values._tree_memo = [tkey, bytearray(chunks), tree, root]
        values._memos_owned = True
        return root
    root = merkleize_chunks(chunks, limit=limit_elems)
    values._tree_memo = [tkey, chunks, None, root]
    values._memos_owned = True
    return root


def _register_and_activate(elem, values, tkey) -> None:
    """Post-full-walk bookkeeping for a scalar-leaf container list: wire
    every element to this list (weak parent + index stamp) and, when the
    walk left a group tree and every element carries its root cache, arm
    dirty-group tracking (an empty set) so the NEXT walk is a splice.
    Intra-list aliasing (the same element object at two indices) defeats
    per-index marking, so registration refuses to arm in that case."""
    stamped = None
    if not values._parents_registered:
        import weakref

        ref = values._self_ref
        if ref is None:
            ref = weakref.ref(values)
            values._self_ref = ref
        stamped = True
        n_v = len(values)
        for i, v in enumerate(values):
            d = v.__dict__
            old_i = d.get("_ssz_idx")
            if (
                old_i is not None
                and old_i != i
                and old_i < n_v
                and list.__getitem__(values, old_i) is v
            ):
                stamped = False  # duplicate object within THIS list
            d["_ssz_idx"] = i
            parents = d.get("_ssz_parents")
            if parents is None:
                d["_ssz_parents"] = [ref]
            elif not any(p is ref for p in parents):
                # identity, not ==: weakref.ref.__eq__ compares live
                # referents by VALUE, and these lists compare field-wise —
                # a distinct but value-equal sibling list (state copy
                # sharing elements) would be mistaken for self
                if len(parents) > 16:  # prune dead lineages
                    parents[:] = [p for p in parents if p() is not None]
                parents.append(ref)
        values._parents_registered = True
    # Freshness is only sound if every element's sole mutation channel
    # really is __setattr__: an element holding a mutable buffer
    # (bytearray in a ByteVector slot) can change in place without
    # notifying. elem.hash_tree_root() just ran on every element and set
    # _htr_cache iff all field values were immutable (int|bool|bytes), so
    # cache presence IS that proof — for the freshness flag AND for
    # arming dirty-group tracking.
    all_cached = all("_htr_cache" in v.__dict__ for v in values)
    values._elems_fresh = all_cached
    tm = values._tree_memo
    if not (all_cached and tm is not None and tm[0] == tkey and tm[2] is not None):
        values._dirty_groups = None
        return
    if values._dirty_groups is None and stamped is None:
        # reactivation after an untracked mutation: stamps may be stale —
        # rewrite them, refusing on intra-list duplicates
        stamped = True
        n_v = len(values)
        for i, v in enumerate(values):
            d = v.__dict__
            old_i = d.get("_ssz_idx")
            if (
                old_i is not None
                and old_i != i
                and old_i < n_v
                and list.__getitem__(values, old_i) is v
            ):
                stamped = False
                break
            d["_ssz_idx"] = i
    values._dirty_groups = set() if stamped in (None, True) else None


def bulk_store(values, new_values, changed_indices=None) -> None:
    """See ``_bulk_store_impl`` — this thin wrapper adds the memory
    observatory's bandwidth accounting (``ssz.bulk_store`` site): the
    wire-width column's exact ``nbytes`` when the caller hands an
    ndarray, the pointer-width splice estimate (8 bytes/element)
    otherwise. One bool read while the observatory is off."""
    obs = _memory.OBSERVATORY
    if not obs.active:
        return _bulk_store_impl(values, new_values, changed_indices)
    nbytes = getattr(new_values, "nbytes", None)
    if nbytes is None:
        nbytes = len(new_values) * 8
    t0 = _time.perf_counter()
    out = _bulk_store_impl(values, new_values, changed_indices)
    obs.record_copy("ssz.bulk_store", int(nbytes), t0, _time.perf_counter())
    return out


def _bulk_store_impl(values, new_values, changed_indices=None) -> None:
    """Same-length full-content overwrite with an explicit dirty contract:
    the caller certifies that every position whose value differs from the
    current content appears in ``changed_indices`` (element indices; None
    = unknown, every group goes dirty). This is the bulk-mutator entry
    the fork models' vectorized epoch sweeps use instead of
    ``values[:] = new`` — a whole-registry balance write that really
    changed a few thousand entries re-merkleizes a few groups, not the
    whole collection (docs/INCREMENTAL_HTR.md).

    ``new_values`` may be a 1-D unsigned numpy array (the columnar epoch
    commit's wire-width buffer): the content splices in via ONE
    ``tolist`` boxing and the uniformity verdict is certified from the
    dtype — no second per-element materialization, no type scan."""
    n = len(values)
    uint_column = (
        getattr(getattr(new_values, "dtype", None), "kind", "") == "u"
        and getattr(new_values, "ndim", 0) == 1
    )
    if uint_column:
        new_values = new_values.tolist()
    if (
        values.__class__ is not CachedRootList
        or len(new_values) != n
        or (new_values and isinstance(new_values[0], Container))
    ):
        values[:] = new_values
        return
    list.__setitem__(values, slice(0, n), new_values)
    values._root_cache.clear()
    values._elems_fresh = False
    values._mut_gen += 1
    # re-certify uniformity NOW (one C-speed pass — or for free from an
    # adopted column's dtype): the dirty-group splice only engages on a
    # certified collection, and deferring the scan to the next walk
    # would demote every bulk_store to a full re-pack — exactly the cost
    # this entry point exists to avoid
    if uint_column:
        values._uniform_kind = ("int",)
    else:
        kinds = set(map(type, new_values))
        if kinds == {int}:
            values._uniform_kind = ("int",)
        elif kinds == {bool}:
            values._uniform_kind = ("bool",)
        elif kinds == {bytes} and len(set(map(len, new_values))) == 1:
            values._uniform_kind = ("bytes", len(new_values[0]))
        else:
            values._uniform_kind = None
    cps = values._container_parents
    if cps is not None:
        for ref in cps:
            p = ref()
            if p is not None:
                p._ssz_root_dirty()
    dg = values._dirty_groups
    cd = values._col_dirty
    if dg is None and cd is None:
        return
    gs = _DIRTY_GROUP_SHIFT
    if changed_indices is None:
        # uncertified: every element may differ — columnar consumers
        # rebuild rather than refresh
        values._col_dirty = None
        if dg is not None and n:
            dg.update(range(((n - 1) >> gs) + 1))
        return
    try:
        import numpy as _np

        arr = _np.asarray(changed_indices, dtype=_np.int64)
        if dg is not None and arr.size:
            dg.update(_np.unique(arr >> gs).tolist())
        if cd is not None:
            if arr.size + len(cd) > _COL_DIRTY_CAP:
                values._col_dirty = None  # full rebuild beats a huge set
            else:
                cd.update(arr.tolist())
    except (TypeError, ValueError):
        idxs = [int(i) for i in changed_indices]
        if dg is not None:
            dg.update({i >> gs for i in idxs})
        if cd is not None:
            if len(idxs) + len(cd) > _COL_DIRTY_CAP:
                values._col_dirty = None
            else:
                cd.update(idxs)


def _merkleize_homogeneous(elem: SSZType, values: list, limit_elems: int) -> bytes:
    if _is_basic(elem):
        limit = (
            limit_elems * elem.fixed_size() + BYTES_PER_CHUNK - 1
        ) // BYTES_PER_CHUNK
        key = ("u", elem, limit)
        if _pack_memo_gen_hit(values, key):
            return values._pack_memo[2]
        if isinstance(values, CachedRootList):
            hit = _packed_splice(elem, values, key, limit)
            if hit is not None:
                return hit
        all_int = getattr(values, "_uniform_kind", None) == ("int",)
        if not all_int and values and set(map(type, values)) == {int}:
            all_int = True  # C-speed scan; keeps serialize()'s
            # bool/float rejections out of the numpy path
            if isinstance(values, CachedRootList):
                values._uniform_kind = ("int",)  # mutators maintain it
        if (
            isinstance(elem, _UintType)
            and elem.byte_length in (1, 2, 4, 8)
            and all_int
        ):
            # vectorized uint packing (u64 balances/inactivity lists and
            # the u8 participation flags dominate — the per-element
            # serialize of a 131k-flag list was the hot line of altair+
            # block walks). Convert through u64 FIRST and range-check the
            # width explicitly: a direct sub-word asarray silently WRAPS
            # out-of-range ints on numpy<2 (the same hazard the columnar
            # bulk path guards with its shift check), whereas u64
            # conversion raises OverflowError for >=2^64 on every numpy
            # and the shift catches everything else; the little-endian
            # astype matches serialize().
            _obs = _memory.OBSERVATORY
            _t0 = _time.perf_counter() if _obs.active else 0.0
            try:
                import numpy as _np

                col = _np.asarray(values, dtype="<u8")
                size = elem.byte_length
                if size < 8 and bool((col >> (8 * size)).any()):
                    raise OverflowError  # out of range for the width
                raw = col.astype("<u%d" % size).tobytes()
            except (OverflowError, TypeError, ValueError):
                raw = b"".join(elem.serialize(v) for v in values)
            if _obs.active:
                # bandwidth: the full wire-width column materialization
                # (a whole-collection re-pack — the cost _packed_splice
                # exists to avoid)
                _obs.record_copy(
                    "ssz.column_serialize", len(raw), _t0, _time.perf_counter()
                )
        else:
            raw = b"".join(elem.serialize(v) for v in values)
        return _merkleize_packed_memo(values, key, pack_bytes(raw), limit, raw=raw)
    if isinstance(elem, ByteVector) and elem.length == BYTES_PER_CHUNK:
        # a 32-byte vector's root IS its bytes — and the validation runs
        # at C speed (join rejects non-bytes with TypeError; the len-set
        # check rejects any element that isn't exactly 32 bytes), because
        # a per-element Python genexpr over block_roots/state_roots/
        # randao_mixes (tens of thousands of elements on a mainnet
        # state) was the single hottest line of block processing.
        # Anything non-conforming falls to the per-element path and its
        # structured errors.
        # both scans run at C speed and are BOTH required: the len-set
        # rejects any element that isn't exactly 32 long (a 31+33 pair
        # would fool a total-length check alone), while the joined byte
        # length rejects sized buffer objects whose len() isn't their
        # byte size (array.array('I', …)/memoryview of wider items would
        # fool the len-set alone)
        b32_key = ("b32", elem, limit_elems)
        if _pack_memo_gen_hit(values, b32_key):
            return values._pack_memo[2]
        if isinstance(values, CachedRootList):
            hit = _packed_splice(elem, values, b32_key, limit_elems)
            if hit is not None:
                return hit
        if getattr(values, "_uniform_kind", None) == ("bytes", BYTES_PER_CHUNK):
            sizes_ok = True  # full scan done once; mutators maintain it
        else:
            try:
                sizes_ok = not values or set(map(len, values)) == {BYTES_PER_CHUNK}
            except TypeError:  # un-sized element (e.g. int)
                sizes_ok = False
        if sizes_ok:
            try:
                chunks = b"".join(values)
            except TypeError:  # sized but not bytes-like (e.g. str)
                chunks = None
            if chunks is not None and len(chunks) == BYTES_PER_CHUNK * len(
                values
            ):
                if (
                    values
                    and isinstance(values, CachedRootList)
                    and values._uniform_kind is None
                    and all(type(v) is bytes for v in values)
                ):
                    # the flag asserts type-is-bytes too (a bytearray
                    # joins fine but can mutate in place), so it is only
                    # set after one full type scan; mutators keep it
                    values._uniform_kind = ("bytes", BYTES_PER_CHUNK)
                return _merkleize_packed_memo(
                    values, b32_key, chunks, limit_elems, raw=chunks
                )
    freshable = (
        isinstance(values, CachedRootList)
        and isinstance(elem, type)
        and getattr(elem, "__ssz_scalar_leaf__", False)
    )
    tkey = ("tree", elem, limit_elems)
    tm = None
    if freshable:
        # dirty-group splice: the mutators and the element setattr chain
        # have named exactly which 4096-leaf groups changed — re-merkleize
        # those plus the log-depth path, no registry walk
        hit = _tree_splice(elem, values, tkey)
        if hit is not None:
            return hit
        tm = values._tree_memo
        if tm is not None and tm[0] != tkey:
            tm = None
        if (
            values._elems_fresh
            and tm is not None
            and len(tm[1]) == 32 * len(values)
        ):
            # SCALAR-LEAF container elements (the validator registry)
            # notify this list through weakref parents on any field
            # write, so a set freshness flag proves no element changed
            # since the last walk — the memoized root stands.
            return tm[3]
    chunks = None
    if freshable and len(values) >= _BULK_ROOTS_MIN and tm is None:
        # no memo yet = a cold-LIST walk: a fresh deserialize (elements
        # cold too) or a fresh CachedRootList wrapped around
        # ALREADY-CACHED elements (validating-constructor / fork-upgrade
        # paths; state.copy() itself carries the memo and skips this
        # branch entirely). The columnar bulk path rebuilds every element
        # root at native speed — right for the cold elements, several
        # times slower than the probing join when the elements carry
        # their roots; sample a few elements to tell the cases apart
        n_v = len(values)
        step = max(1, n_v // 8)
        if any(
            "_htr_cache" not in values[i].__dict__
            for i in range(0, n_v, step)
        ):
            chunks = _bulk_scalar_leaf_roots(elem, values)
    if chunks is None:
        if freshable:
            # warm incremental join: most elements hold a cached root
            # (32-byte, never falsy), so an inline dict probe skips the
            # classmethod dispatch per element — ~2x on a million-element
            # registry walk where a handful of elements changed
            htr = elem.hash_tree_root
            chunks = b"".join(
                [v.__dict__.get("_htr_cache") or htr(v) for v in values]
            )
        else:
            if (
                isinstance(values, CachedRootList)
                and values._elems_fresh
            ):
                # NESTED-container freshness (pending attestations): the
                # last full walk registered this list as every element's
                # weak parent and every element held its instance root —
                # any later element/field/nested mutation cleared the
                # flag through the notify chain, so a set flag proves
                # the joined leaf roots are unchanged and the memo root
                # stands without re-probing ~2k element roots per slot
                memo = values._root_cache.get(("tree", elem, limit_elems))
                if memo is not None:
                    return memo[1]
            chunks = b"".join(elem.hash_tree_root(v) for v in values)
    if freshable:
        root = _finish_container_walk(values, tkey, chunks, limit_elems, tm)
        _register_and_activate(elem, values, tkey)
        return root
    if isinstance(values, CachedRootList):
        # container-element lists (the validator registry) can't cache a
        # root blindly — an element can mutate without touching the list
        # — but the JOINED leaf roots reflect any such mutation (element
        # roots are instance-cached with setattr invalidation), so a
        # (chunks, root) memo keyed on the exact leaf bytes is sound: a
        # 256KB memcmp replaces the ~16k-hash tree rebuild per state root
        memo = values._root_cache.get(("tree", elem, limit_elems))
        if memo is not None and memo[0] == chunks:
            root = memo[1]
        elif (
            memo is not None
            and len(chunks) >= _TREE_TWO_LEVEL_MIN_BYTES
            and limit_elems % _TREE_SUB_CHUNKS == 0
        ):
            # memo is not None: a COLD walk keeps the single-call native
            # whole-tree path; mids only pay off once there is a previous
            # walk to diff against
            # two-level rebuild: group the element roots into fixed
            # subtrees and recompute only the groups whose leaf segment
            # changed — a block that edits a handful of validators pays a
            # few 4096-leaf subtrees plus the tiny top tree, not a full
            # million-leaf merkleization (the same scheme the packed-list
            # memo uses)
            sub = _TREE_SUB_CHUNKS
            bs = sub * BYTES_PER_CHUNK
            nsub = (len(chunks) + bs - 1) // bs
            old = memo[0]
            old_mids = memo[2] if len(memo) > 2 else b""  # cold memo: 2-tuple
            mids = bytearray(nsub * 32)
            for i in range(nsub):
                seg = chunks[i * bs : (i + 1) * bs]
                if (
                    len(old_mids) >= 32 * (i + 1)
                    and old[i * bs : (i + 1) * bs] == seg
                ):
                    mids[32 * i : 32 * (i + 1)] = old_mids[
                        32 * i : 32 * (i + 1)
                    ]
                else:
                    mids[32 * i : 32 * (i + 1)] = merkleize_chunks(
                        seg, limit=sub
                    )
            # each mid is the root of a height-log2(sub) subtree, so the
            # sparse top tree must pad with zero-SUBTREE hashes — plain
            # leaf-zero padding would change every count<limit root
            root = merkleize_chunks(
                bytes(mids),
                limit=limit_elems // sub,
                level_offset=sub.bit_length() - 1,
            )
            values._root_cache[("tree", elem, limit_elems)] = (
                chunks,
                root,
                bytes(mids),
            )
        else:
            root = merkleize_chunks(chunks, limit=limit_elems)
            values._root_cache[("tree", elem, limit_elems)] = (chunks, root)
        if values and isinstance(list.__getitem__(values, 0), Container):
            _register_nested_freshness(values)
        return root
    return merkleize_chunks(chunks, limit=limit_elems)


def _register_nested_freshness(values) -> None:
    """Post-full-walk bookkeeping for a NESTED-container list (the
    pending-attestation shape): wire every element to this list as a
    weak parent, then mark element freshness iff every element finished
    the walk holding its instance root. ``_try_cache_nested_root`` wired
    each element's OWN children during that walk, so any nested mutation
    propagates up (``_ssz_root_dirty`` → parent-list
    ``_elems_fresh = False``) and direct field writes notify through
    ``Container.__setattr__`` — a set flag therefore proves the joined
    leaf roots are unchanged and the ``("tree", ...)`` memo root can be
    served without the per-element probe walk. An element that failed to
    cache (a mutable buffer in some field) leaves the flag False and
    every walk honest."""
    if not values._parents_registered:
        import weakref

        ref = values._self_ref
        if ref is None:
            ref = weakref.ref(values)
            values._self_ref = ref
        n_v = len(values)
        for i, v in enumerate(values):
            d = v.__dict__
            d["_ssz_idx"] = i
            parents = d.get("_ssz_parents")
            if parents is None:
                d["_ssz_parents"] = [ref]
            elif not any(p is ref for p in parents):
                # identity, never == (weakref equality compares live
                # referents by value — a value-equal sibling list would
                # be mistaken for self)
                if len(parents) > 16:  # prune dead lineages
                    parents[:] = [p for p in parents if p() is not None]
                parents.append(ref)
        values._parents_registered = True
    values._elems_fresh = all("_htr_cache" in v.__dict__ for v in values)


class Vector(_Parametrized, SSZType):
    def __init__(self, elem: SSZType, length: int):
        if length <= 0:
            raise ValueError("Vector length must be positive")
        self.elem = elem
        self.length = length

    def is_fixed_size(self) -> bool:
        return self.elem.is_fixed_size()

    def fixed_size(self) -> int:
        return self.elem.fixed_size() * self.length

    def serialize(self, value: list) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"{self!r}: expected {self.length} elements, got {len(value)}")
        return _serialize_homogeneous(self.elem, value)

    def deserialize(self, data: bytes) -> list:
        return _deserialize_homogeneous(self.elem, data, self.length)

    def hash_tree_root(self, value: list) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"{self!r}: expected {self.length} elements, got {len(value)}")
        if isinstance(value, CachedRootList) and _cacheable_elem(self.elem):
            hit = value._root_cache.get(self)
            if hit is None:
                hit = _merkleize_homogeneous(self.elem, value, self.length)
                if _cacheable_values(self.elem, value):
                    value._root_cache[self] = hit
            return hit
        return _merkleize_homogeneous(self.elem, value, self.length)

    def chunk_count(self) -> int:
        if _is_basic(self.elem):
            return (self.length * self.elem.fixed_size() + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
        return self.length

    def default(self) -> list:
        return [self.elem.default() for _ in range(self.length)]

    def to_json(self, value: list) -> list:
        return [self.elem.to_json(v) for v in value]

    def from_json(self, obj: list) -> list:
        if len(obj) != self.length:
            raise ValueError(f"{self!r}: expected {self.length} elements, got {len(obj)}")
        return [self.elem.from_json(v) for v in obj]

    def __repr__(self) -> str:
        return f"Vector[{self.elem!r}, {self.length}]"


class List(_Parametrized, SSZType):
    def __init__(self, elem: SSZType, limit: int):
        self.elem = elem
        self.limit = limit

    def is_fixed_size(self) -> bool:
        return False

    def serialize(self, value: list) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"{self!r}: {len(value)} elements exceeds limit")
        return _serialize_homogeneous(self.elem, value)

    def deserialize(self, data: bytes) -> list:
        values = _deserialize_homogeneous(self.elem, data, None)
        if len(values) > self.limit:
            raise DeserializeError(f"{self!r}: {len(values)} elements exceeds limit")
        return values

    def hash_tree_root(self, value: list) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"{self!r}: {len(value)} elements exceeds limit")
        if isinstance(value, CachedRootList) and _cacheable_elem(self.elem):
            hit = value._root_cache.get(self)
            if hit is None:
                hit = mix_in_length(
                    _merkleize_homogeneous(self.elem, value, self.limit),
                    len(value),
                )
                if _cacheable_values(self.elem, value):
                    value._root_cache[self] = hit
            return hit
        root = _merkleize_homogeneous(self.elem, value, self.limit)
        return mix_in_length(root, len(value))

    def chunk_count(self) -> int:
        if _is_basic(self.elem):
            return (self.limit * self.elem.fixed_size() + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
        return self.limit

    def default(self) -> list:
        return []

    def to_json(self, value: list) -> list:
        return [self.elem.to_json(v) for v in value]

    def from_json(self, obj: list) -> list:
        if len(obj) > self.limit:
            raise ValueError(f"{self!r}: {len(obj)} elements exceeds limit")
        return [self.elem.from_json(v) for v in obj]

    def __repr__(self) -> str:
        return f"List[{self.elem!r}, {self.limit}]"


# ---------------------------------------------------------------------------
# Bitfields (values are list[bool])
# ---------------------------------------------------------------------------


def _bits_to_bytes(bits: list, include_delimiter: bool) -> bytes:
    n = len(bits)
    total = n + 1 if include_delimiter else n
    if n >= 256:
        # vectorized packing for committee-scale bitfields: the per-bit
        # Python loop below was the hot line of hashing a mainnet epoch's
        # pending attestations (~2k aggregates × ~1k bits). bool()
        # coercion through asarray matches the loop's truthiness test
        # bit-for-bit; exotic elements fall back to the loop.
        try:
            import numpy as _np

            arr = _np.asarray(bits, dtype=bool)
            if arr.shape == (n,):
                packed = _np.packbits(arr, bitorder="little").tobytes()
                out = bytearray((total + 7) // 8)
                out[: len(packed)] = packed
                if include_delimiter:
                    out[n // 8] |= 1 << (n % 8)
                return bytes(out)
        except Exception:  # noqa: BLE001 — exotic elements: bit loop
            pass
    out = bytearray((total + 7) // 8) if total else bytearray(b"")
    for i, bit in enumerate(bits):
        if bit:
            out[i // 8] |= 1 << (i % 8)
    if include_delimiter:
        out[n // 8] |= 1 << (n % 8)
    return bytes(out)


class Bitvector(_Parametrized, SSZType):
    def __init__(self, length: int):
        if length <= 0:
            raise ValueError("Bitvector length must be positive")
        self.length = length

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return (self.length + 7) // 8

    def serialize(self, value: list) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"Bitvector[{self.length}]: got {len(value)} bits")
        return _bits_to_bytes(value, include_delimiter=False)

    def deserialize(self, data: bytes) -> list:
        if len(data) != self.fixed_size():
            raise DeserializeError(f"Bitvector[{self.length}]: got {len(data)} bytes")
        bits = [bool((data[i // 8] >> (i % 8)) & 1) for i in range(self.length)]
        # high bits beyond length must be zero
        if self.length % 8 and data[-1] >> (self.length % 8):
            raise DeserializeError("Bitvector has set padding bits")
        return bits

    def hash_tree_root(self, value: list) -> bytes:
        return merkleize_chunks(
            pack_bytes(self.serialize(value)), limit=self.chunk_count()
        )

    def chunk_count(self) -> int:
        return (self.length + 255) // 256

    def default(self) -> list:
        return [False] * self.length

    def to_json(self, value: list) -> str:
        return "0x" + self.serialize(value).hex()

    def from_json(self, obj: str) -> list:
        return self.deserialize(_bytes_from_hex(obj))

    def __repr__(self) -> str:
        return f"Bitvector[{self.length}]"


class Bitlist(_Parametrized, SSZType):
    def __init__(self, limit: int):
        self.limit = limit

    def is_fixed_size(self) -> bool:
        return False

    def serialize(self, value: list) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"Bitlist[{self.limit}]: got {len(value)} bits")
        return _bits_to_bytes(value, include_delimiter=True)

    def deserialize(self, data: bytes) -> list:
        if len(data) == 0:
            raise DeserializeError("Bitlist must contain the delimiter bit")
        if data[-1] == 0:
            raise DeserializeError("Bitlist missing delimiter bit")
        last = data[-1]
        delimiter_pos = last.bit_length() - 1
        n = (len(data) - 1) * 8 + delimiter_pos
        if n > self.limit:
            raise DeserializeError(f"Bitlist[{self.limit}]: got {n} bits")
        return [bool((data[i // 8] >> (i % 8)) & 1) for i in range(n)]

    def hash_tree_root(self, value: list) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"Bitlist[{self.limit}]: got {len(value)} bits")
        # bitfield roots cache exactly like immutable-scalar list roots:
        # bools are immutable, every sanctioned mutation runs through the
        # instrumented mutators (which clear _root_cache), and the cached
        # dict TRAVELS across state copies — so a copied state's pending
        # attestations stop re-serializing ~2k aggregation bitfields per
        # walk. The ("bool",) uniformity verdict (established here by one
        # C-speed scan, maintained by the mutators) additionally lets the
        # nested-root purity scan skip its per-bit element check.
        cached = isinstance(value, CachedRootList)
        if cached:
            hit = value._root_cache.get(self)
            if hit is not None:
                return hit
        raw = _bits_to_bytes(value, include_delimiter=False)
        root = merkleize_chunks(pack_bytes(raw), limit=self.chunk_count())
        root = mix_in_length(root, len(value))
        if cached:
            if value._uniform_kind is None and set(map(type, value)) <= {
                bool
            }:
                value._uniform_kind = ("bool",)
            if value._uniform_kind == ("bool",):
                value._root_cache[self] = root
                # the packed little-endian bits ride the same cache (and
                # the same invalidation): the committee-mask kernel
                # (models/committees.py) reads its bitfield matrix rows
                # from here instead of re-boxing ~2k × ~1k Python bools
                value._root_cache["bitpack"] = raw
        return root

    def chunk_count(self) -> int:
        return (self.limit + 255) // 256

    def default(self) -> list:
        return []

    def to_json(self, value: list) -> str:
        return "0x" + self.serialize(value).hex()

    def from_json(self, obj: str) -> list:
        return self.deserialize(_bytes_from_hex(obj))

    def __repr__(self) -> str:
        return f"Bitlist[{self.limit}]"


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------


class _ContainerMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        fields: dict[str, SSZType] = {}
        for base in reversed(cls.__mro__[1:]):
            fields.update(getattr(base, "__ssz_fields__", {}))
        for key, val in ns.get("__annotations__", {}).items():
            if isinstance(val, str):
                # `from __future__ import annotations` stores strings; resolve
                # against the defining module so fields aren't silently lost.
                import sys as _sys

                mod = _sys.modules.get(ns.get("__module__", ""), None)
                mod_globals = getattr(mod, "__dict__", {})
                try:
                    val = eval(val, mod_globals, dict(ns))  # noqa: S307
                except Exception as exc:
                    raise TypeError(
                        f"{name}.{key}: cannot resolve annotation {val!r}: {exc}"
                    ) from exc
            if isinstance(val, (SSZType, _ContainerMeta)):
                fields[key] = val
        cls.__ssz_fields__ = fields
        # Scalar-leaf containers (every field an immutable-valued scalar:
        # uints, booleans, fixed byte vectors — no nested containers, no
        # lists) can cache their hash_tree_root on the instance, with
        # attribute assignment as the only invalidation point. This is
        # the cross-slot cache the per-slot state root leans on: 32k+
        # Validator records of which a block touches a handful
        # (reference hot path: phase0/slot_processing.rs:45).
        cls.__ssz_scalar_leaf__ = bool(fields) and all(
            isinstance(t, (_UintType, _BooleanType, ByteVector))
            for t in fields.values()
        )
        return cls


def _register_weak_parent(store: list, ref) -> None:
    """Identity-guarded append of a parent weakref (identity, never ==:
    weakref equality compares live referents by value)."""
    if not any(p is ref for p in store):
        if len(store) > 16:  # prune dead lineages
            store[:] = [p for p in store if p() is not None]
        store.append(ref)


def _try_cache_nested_root(cls, value, root: bytes) -> None:
    """Instance-root caching for NESTED containers (the general case the
    scalar-leaf fast path can't cover): cache iff every field value is an
    immutable scalar, a Container that itself holds a cached root (its
    mutations notify us through the parent link installed here), or a
    CachedRootList of immutable scalars (its instrumented mutators fire
    _ssz_root_dirty through _container_parents). Anything else — a list
    holding containers, a mutable buffer — leaves the value uncached and
    every walk honest. This is what makes per-slot state roots cheap over
    the 1,024 PendingAttestations of a mainnet epoch and over execution
    payload headers: their subtrees stop re-merkleizing when untouched."""
    d = value.__dict__
    containers: list = []
    lists: list = []
    for k in cls.__ssz_fields__:
        v = d.get(k)
        t = v.__class__
        if t is int or t is bytes or t is bool:
            continue
        if isinstance(v, Container):
            if "_htr_cache" not in v.__dict__:
                return  # child uncovered: its mutations couldn't notify
            containers.append(v)
        elif t is CachedRootList:
            kind = v._uniform_kind
            if kind is None and not all(
                x.__class__ is int or x.__class__ is bool or x.__class__ is bytes
                for x in v
            ):
                return  # container elements mutate without list notice
            lists.append(v)
        else:
            return  # unknown value kind: stay conservative
    ref = d.get("_ssz_self_ref")
    if ref is None:
        import weakref

        ref = weakref.ref(value)
        d["_ssz_self_ref"] = ref
    for child in containers:
        ps = child.__dict__.get("_ssz_parents")
        if ps is None:
            child.__dict__["_ssz_parents"] = [ref]
        else:
            _register_weak_parent(ps, ref)
    for child in lists:
        ps = child._container_parents
        if ps is None:
            child._container_parents = [ref]
        else:
            _register_weak_parent(ps, ref)
    d["_htr_cache"] = root


class Container(metaclass=_ContainerMeta):
    """SSZ container. Declare fields as class annotations whose *values* are
    SSZType descriptors::

        class Checkpoint(Container):
            epoch: uint64
            root: ByteVector[32]

    Instances are mutable attribute bags; missing constructor arguments get
    type defaults. The class itself doubles as its own type descriptor (the
    classmethods mirror the SSZType protocol)."""

    __ssz_fields__: dict[str, SSZType] = {}

    def __init__(self, **kwargs):
        fields = type(self).__ssz_fields__
        for key in kwargs:
            if key not in fields:
                raise TypeError(f"{type(self).__name__} has no field {key!r}")
        for key, typ in fields.items():
            value = kwargs[key] if key in kwargs else typ.default()
            if type(value) is list:
                value = CachedRootList(value)
            object.__setattr__(self, key, value)

    # -- python niceties ----------------------------------------------------
    def __setattr__(self, key, value):
        # any field write invalidates the cached root; plain-list values
        # wrap into the root-caching list. Weak parents lose their
        # covering state here — THE invalidation edge that makes both
        # cache schemes sound: list parents (the registry freshness
        # scheme) drop their freshness flag; container parents (the
        # nested-root scheme) drop their instance roots transitively.
        # Container parents only need the notification when this object
        # actually held a cached root: a parent can only have cached
        # while this child's root was cached (registration happens
        # inside the parent's walk, which re-caches the child), so an
        # already-absent cache means the ancestors are already dirty.
        d = self.__dict__
        had = d.pop("_htr_cache", None) is not None
        parents = d.get("_ssz_parents")
        if parents is not None:
            idx = d.get("_ssz_idx")
            # the column channel only trusts immutable scalars: a field
            # that becomes e.g. a bytearray could then mutate in place
            # without notifying, so its row can't stay column-tracked
            tv = value.__class__
            col_safe = tv is int or tv is bytes or tv is bool
            for ref in parents:
                p = ref()
                if p is None:
                    continue
                if p.__class__ is CachedRootList:
                    p._elems_fresh = False
                    dg = p._dirty_groups
                    cd = p._col_dirty
                    if dg is not None or cd is not None:
                        # the stamped index is trusted only when it still
                        # points at THIS object in THAT list (stamps are
                        # per-element, and a structural mutation or a
                        # different-position alias can stale them); any
                        # mismatch downgrades the list to the discovery
                        # walk rather than risking a missed group
                        stamped = (
                            idx is not None
                            and idx < list.__len__(p)
                            and list.__getitem__(p, idx) is self
                        )
                        if dg is not None:
                            if stamped:
                                dg.add(idx >> _DIRTY_GROUP_SHIFT)
                            else:
                                p._dirty_groups = None
                        if cd is not None:
                            if stamped and col_safe:
                                cd.add(idx)
                            else:
                                p._col_dirty = None
                elif had:
                    p._ssz_root_dirty()
        if type(value) is list:
            value = CachedRootList(value)
        object.__setattr__(self, key, value)

    def _ssz_root_dirty(self) -> None:
        """A covered child (field container or list) changed: drop the
        instance root and propagate. The pop-guard both terminates
        aliasing diamonds and skips ancestors that are already dirty
        (cache present ⇒ every ancestor's cache was populated after
        this one — see __setattr__)."""
        d = self.__dict__
        if d.pop("_htr_cache", None) is None:
            return
        parents = d.get("_ssz_parents")
        if parents is not None:
            idx = d.get("_ssz_idx")
            for ref in parents:
                p = ref()
                if p is None:
                    continue
                if p.__class__ is CachedRootList:
                    p._elems_fresh = False
                    # a NESTED child changed: the columnar consumers only
                    # attach to scalar-leaf element lists (which never take
                    # this path), so stay conservative and drop tracking
                    p._col_dirty = None
                    dg = p._dirty_groups
                    if dg is not None:
                        if (
                            idx is not None
                            and idx < list.__len__(p)
                            and list.__getitem__(p, idx) is self
                        ):
                            dg.add(idx >> _DIRTY_GROUP_SHIFT)
                        else:
                            p._dirty_groups = None
                else:
                    p._ssz_root_dirty()

    def __eq__(self, other) -> bool:
        if type(self) is not type(other):
            return NotImplemented
        return all(
            getattr(self, k) == getattr(other, k) for k in type(self).__ssz_fields__
        )

    # Containers are mutable attribute bags: not hashable (use
    # `.root()` explicitly when a stable digest is needed).
    __hash__ = None

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{k}={getattr(self, k)!r}" for k in list(type(self).__ssz_fields__)[:4]
        )
        more = "" if len(type(self).__ssz_fields__) <= 4 else ", ..."
        return f"{type(self).__name__}({inner}{more})"

    def copy(self):
        """Deep structural copy (lists copied, nested containers copied).

        A cached hash_tree_root travels with the copy: field values are
        identical so the root is identical, and any later field write on
        either object invalidates its own cache (__setattr__). Without
        this, copying a state forced a full registry rehash — ~0.9s of
        the mainnet block benchmark.

        Builds via __new__ + a dict update rather than the validating
        constructor: every value comes from an already-constructed
        container, so re-wrapping and field checks would only re-spend
        what __init__ already paid (state copies dominated the mainnet
        block benchmark before this). Scalars (ints, bytes, bools) are
        immutable and shared; lists and nested containers are copied."""
        cls = type(self)
        new = cls.__new__(cls)
        nd = new.__dict__
        nd.update(self.__dict__)
        # the copy belongs to no list yet: carrying the original's weak
        # parents would make its mutations invalidate the WRONG lists
        nd.pop("_ssz_parents", None)
        # the self-weakref points at the ORIGINAL; children registered
        # under it would notify the wrong object
        nd.pop("_ssz_self_ref", None)
        if not cls.__ssz_scalar_leaf__:
            # a nested-cached root is only sound with child->parent links
            # installed, and the copied children aren't wired to the copy;
            # the next walk re-caches and re-registers. (Scalar-leaf
            # containers have no children — their cache travels.)
            nd.pop("_htr_cache", None)
        for key, typ in cls.__ssz_fields__.items():
            v = nd[key]
            tv = v.__class__
            if tv is int or tv is bytes or tv is bool:
                continue
            if tv is CachedRootList or tv is list:
                nd[key] = _copy_value(typ, v)
            elif isinstance(v, Container):
                nd[key] = v.copy()
            # any other value kind is immutable by SSZ construction and
            # shares, exactly like the validating-constructor path did
        return new

    # -- SSZType protocol (classmethods) ------------------------------------
    @classmethod
    def fields(cls) -> dict[str, SSZType]:
        return cls.__ssz_fields__

    @classmethod
    def is_fixed_size(cls) -> bool:
        return all(t.is_fixed_size() for t in cls.__ssz_fields__.values())

    @classmethod
    def fixed_size(cls) -> int:
        if not cls.is_fixed_size():
            raise NotImplementedError(f"{cls.__name__} is variable-size")
        return sum(t.fixed_size() for t in cls.__ssz_fields__.values())

    @classmethod
    def serialize(cls, value: "Container") -> bytes:
        fixed_parts: list[bytes | None] = []
        variable_parts: list[bytes] = []
        for key, typ in cls.__ssz_fields__.items():
            v = getattr(value, key)
            if typ.is_fixed_size():
                fixed_parts.append(typ.serialize(v))
            else:
                fixed_parts.append(None)
                variable_parts.append(typ.serialize(v))
        fixed_len = sum(
            len(p) if p is not None else OFFSET_SIZE for p in fixed_parts
        )
        offset = fixed_len
        out = bytearray()
        vlens = [len(p) for p in variable_parts]
        vi = 0
        for p in fixed_parts:
            if p is not None:
                out += p
            else:
                if offset + vlens[vi] >= MAX_LENGTH:
                    raise ValueError(
                        f"{cls.__name__}: serialized size exceeds u32 offset range"
                    )
                out += offset.to_bytes(OFFSET_SIZE, "little")
                offset += vlens[vi]
                vi += 1
        for p in variable_parts:
            out += p
        return bytes(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "Container":
        fields = cls.__ssz_fields__
        # pass 1: slice fixed region, collect offsets
        pos = 0
        offsets: list[int] = []
        fixed_slices: dict[str, bytes] = {}
        variable_keys: list[str] = []
        for key, typ in fields.items():
            if typ.is_fixed_size():
                size = typ.fixed_size()
                if pos + size > len(data):
                    raise DeserializeError(f"{cls.__name__}: truncated at field {key}")
                fixed_slices[key] = data[pos : pos + size]
                pos += size
            else:
                if pos + OFFSET_SIZE > len(data):
                    raise DeserializeError(f"{cls.__name__}: truncated offset at {key}")
                offsets.append(int.from_bytes(data[pos : pos + OFFSET_SIZE], "little"))
                variable_keys.append(key)
                pos += OFFSET_SIZE
        if offsets:
            if offsets[0] != pos:
                raise DeserializeError(
                    f"{cls.__name__}: first offset {offsets[0]} != fixed size {pos}"
                )
        elif pos != len(data):
            raise DeserializeError(
                f"{cls.__name__}: {len(data) - pos} trailing bytes"
            )
        offsets.append(len(data))
        for a, b in zip(offsets, offsets[1:]):
            if a > b:
                raise DeserializeError(f"{cls.__name__}: offsets not monotonic")
        # pass 2: decode
        kwargs = {}
        vi = 0
        for key, typ in fields.items():
            if typ.is_fixed_size():
                kwargs[key] = typ.deserialize(fixed_slices[key])
            else:
                kwargs[key] = typ.deserialize(data[offsets[vi] : offsets[vi + 1]])
                vi += 1
        return cls(**kwargs)

    @classmethod
    def hash_tree_root(cls, value: "Container") -> bytes:
        cached = value.__dict__.get("_htr_cache")
        if cached is not None:
            return cached
        chunks = b"".join(
            typ.hash_tree_root(getattr(value, key))
            for key, typ in cls.__ssz_fields__.items()
        )
        root = merkleize_chunks(chunks)
        if cls.__ssz_scalar_leaf__:
            if all(
                isinstance(value.__dict__.get(k), (int, bool, bytes))
                for k in cls.__ssz_fields__
            ):
                # cache only when every field VALUE is immutable — a
                # bytearray in a ByteVector field could mutate in place
                # without passing through __setattr__.
                # (bypass __setattr__, which would immediately evict it)
                value.__dict__["_htr_cache"] = root
        else:
            _try_cache_nested_root(cls, value, root)
        return root

    @classmethod
    def chunk_count(cls) -> int:
        return len(cls.__ssz_fields__)

    @classmethod
    def default(cls) -> "Container":
        return cls()

    @classmethod
    def to_json(cls, value: "Container") -> dict:
        return {
            key: typ.to_json(getattr(value, key))
            for key, typ in cls.__ssz_fields__.items()
        }

    @classmethod
    def from_json(cls, obj: dict) -> "Container":
        # Missing fields are an error (serde-derive behavior in the
        # reference); unknown keys are ignored (serde default).
        kwargs = {}
        for key, typ in cls.__ssz_fields__.items():
            if key not in obj:
                raise ValueError(f"{cls.__name__}: missing field {key!r} in JSON")
            kwargs[key] = typ.from_json(obj[key])
        return cls(**kwargs)

    # instance conveniences
    def encode(self) -> bytes:
        return type(self).serialize(self)

    def root(self) -> bytes:
        return type(self).hash_tree_root(self)


def _share_col_cache(value: "CachedRootList", copied: "CachedRootList") -> None:
    """Structural share of the columnar view across a copy: contents are
    identical at copy time, so the arrays are too. The pending dirty set
    is duplicated (each side replays it against its own future), and
    ownership drops on BOTH sides so the first refresh clones before
    mutating (the _tree_memo discipline)."""
    cc = value._col_cache
    cd = value._col_dirty
    if cc is None or cd is None:
        return
    copied._col_cache = cc
    copied._col_dirty = set(cd)
    copied._col_owned = False
    value._col_owned = False


def _copy_scalar_leaf_list(value: "CachedRootList") -> "CachedRootList":
    """Specialized copy for lists of scalar-leaf containers (the validator
    registry): element dicts are duplicated raw (their field values are
    immutable and the root cache travels), and every copy is wired to the
    NEW list up front — parent weakref + index stamp — so the copied
    state's dirty-group tracking continues seamlessly instead of paying a
    full re-registration walk on its first root."""
    import weakref

    copied = CachedRootList()
    ref = weakref.ref(copied)
    copied._self_ref = ref
    append = list.append
    for i, v in enumerate(value):
        cls = v.__class__
        nv = cls.__new__(cls)
        d = nv.__dict__
        d.update(v.__dict__)
        d["_ssz_parents"] = [ref]
        d["_ssz_idx"] = i
        d.pop("_ssz_self_ref", None)
        append(copied, nv)
    copied._parents_registered = True
    copied._elems_fresh = value._elems_fresh
    _share_col_cache(value, copied)
    return copied


def _copy_value(typ: SSZType, value: Any):
    if isinstance(value, Container):
        return value.copy()
    if isinstance(value, list):
        elem = getattr(typ, "elem", None)
        shared_memos = False
        if elem is not None and not _is_basic(elem):
            # SSZ lists are homogeneous: one dispatch covers every element
            if (
                isinstance(value, CachedRootList)
                and isinstance(elem, type)
                and getattr(elem, "__ssz_scalar_leaf__", False)
            ):
                copied = _copy_scalar_leaf_list(value)
                if value._tree_memo is not None:
                    # structural share of the chunks/tree memo: BOTH sides
                    # drop ownership, so whichever splices first clones —
                    # staleness costs one buffer copy, never a wrong root
                    copied._tree_memo = value._tree_memo
                    value._memos_owned = False
                    shared_memos = True
                dg = value._dirty_groups
                copied._dirty_groups = set(dg) if dg is not None else None
            elif value and isinstance(value[0], Container):
                copied = CachedRootList(v.copy() for v in value)
            elif value and value[0].__class__ is bytes:
                # immutable leaf elements (the Bytes32/Bytes48 vectors:
                # randao mixes, block/state root histories, committee
                # pubkeys): the per-element copy is the identity, so the
                # element walk — ~83k calls per state copy, a third of
                # its cost — collapses to one shallow list copy
                copied = CachedRootList(value)
            else:
                copied = CachedRootList(_copy_value(elem, v) for v in value)
        else:
            copied = CachedRootList(value)
            if isinstance(value, CachedRootList):
                if value._pack_tree is not None:
                    copied._pack_tree = value._pack_tree
                    value._memos_owned = False
                    shared_memos = True
                dg = value._dirty_groups
                copied._dirty_groups = set(dg) if dg is not None else None
        # identical values ⇒ identical roots: the cache (only ever
        # populated for immutable-element collections) travels with the
        # copy; mutations on either side clear their own
        if isinstance(value, CachedRootList):
            copied._root_cache = dict(value._root_cache)
            copied._pack_memo = value._pack_memo  # immutable tuple: shared
            copied._uniform_kind = value._uniform_kind
            _share_col_cache(value, copied)
            # the generation pair travels too: the copy's memo is exactly
            # as fresh as the original's was at copy time, and the copy's
            # own instrumented mutators bump only ITS counter
            copied._mut_gen = value._mut_gen
            copied._pack_gen = value._pack_gen
            if shared_memos:
                copied._memos_owned = False
        _obs = _memory.OBSERVATORY
        if _obs.active:
            # bandwidth: the structural list copy's pointer array
            # (8 bytes/slot — element payloads and memos are shared
            # structurally, so this is the bytes a state copy moves)
            _obs.record_copy("ssz.state_copy", len(value) * 8)
        return copied
    return value


# ---------------------------------------------------------------------------
# Union (SSZ union; used by ssz_generic vectors and future forks)
# ---------------------------------------------------------------------------


class Union(_Parametrized, SSZType):
    """SSZ Union[T0, T1, ...]; ``None`` as option 0 when T0 is None.
    Values are ``(selector, value)`` tuples."""

    def __init__(self, *options):
        if not options or len(options) > 128:
            raise ValueError("Union supports 1..128 options")
        if options[0] is None and len(options) == 1:
            raise ValueError("Union[None] is not allowed")
        self.options = options

    def is_fixed_size(self) -> bool:
        return False

    def serialize(self, value: tuple) -> bytes:
        selector, inner = value
        opt = self.options[selector]
        if opt is None:
            if inner is not None:
                raise ValueError("Union None option carries no value")
            return bytes([selector])
        return bytes([selector]) + opt.serialize(inner)

    def deserialize(self, data: bytes) -> tuple:
        if not data:
            raise DeserializeError("empty union encoding")
        selector = data[0]
        if selector >= len(self.options):
            raise DeserializeError(f"union selector {selector} out of range")
        opt = self.options[selector]
        if opt is None:
            if len(data) != 1:
                raise DeserializeError("union None option carries no value")
            return (0, None)
        return (selector, opt.deserialize(data[1:]))

    def hash_tree_root(self, value: tuple) -> bytes:
        from .merkle import mix_in_selector

        selector, inner = value
        opt = self.options[selector]
        root = zero_hash(0) if opt is None else opt.hash_tree_root(inner)
        return mix_in_selector(root, selector)

    def default(self) -> tuple:
        opt = self.options[0]
        return (0, None if opt is None else opt.default())

    def to_json(self, value: tuple) -> dict:
        selector, inner = value
        opt = self.options[selector]
        return {
            "selector": selector,
            "value": None if opt is None else opt.to_json(inner),
        }

    def from_json(self, obj: dict) -> tuple:
        selector = int(obj["selector"])
        opt = self.options[selector]
        return (selector, None if opt is None else opt.from_json(obj["value"]))

    def __repr__(self) -> str:
        return f"Union[{', '.join(repr(o) for o in self.options)}]"


# ---------------------------------------------------------------------------
# Module-level conveniences
# ---------------------------------------------------------------------------


def serialize(typ, value=None) -> bytes:
    if value is None and isinstance(typ, Container):
        return type(typ).serialize(typ)
    return typ.serialize(value)


def deserialize(typ, data: bytes):
    return typ.deserialize(data)


def hash_tree_root(typ, value=None) -> bytes:
    if value is None and isinstance(typ, Container):
        return type(typ).hash_tree_root(typ)
    return typ.hash_tree_root(value)


# ---------------------------------------------------------------------------
# Generalized indices over types (light-client proof support)
# ---------------------------------------------------------------------------


def _item_position(typ, index_or_name) -> tuple[int, int, SSZType]:
    """(chunk_index, depth_extra_unused, elem_type) for a path step."""
    if isinstance(typ, type) and issubclass(typ, Container):
        keys = list(typ.__ssz_fields__)
        pos = keys.index(index_or_name)
        return pos, 0, typ.__ssz_fields__[index_or_name]
    if isinstance(typ, (Vector, List)):
        if _is_basic(typ.elem):
            per_chunk = BYTES_PER_CHUNK // typ.elem.fixed_size()
            return index_or_name // per_chunk, 0, typ.elem
        return index_or_name, 0, typ.elem
    if isinstance(typ, (Bitvector, Bitlist)):
        return index_or_name // 256, 0, boolean
    if isinstance(typ, (ByteVector, ByteList)):
        return index_or_name // BYTES_PER_CHUNK, 0, uint8
    raise TypeError(f"cannot index into {typ!r}")


def _chunk_count_of(typ) -> int:
    if isinstance(typ, type) and issubclass(typ, Container):
        return typ.chunk_count()
    return typ.chunk_count()


def get_generalized_index(typ, *path) -> int:
    """Spec `get_generalized_index`: walk ``path`` (field names / indices /
    the literal string "__len__") from ``typ``, returning the generalized
    index of the addressed subtree in the hash_tree_root of ``typ``."""
    root = 1
    for step in path:
        if step == "__len__":
            if not isinstance(typ, (List, Bitlist, ByteList)):
                raise TypeError("__len__ only valid on lists")
            root = root * 2 + 1
            typ = uint64
            continue
        is_list = isinstance(typ, (List, Bitlist, ByteList))
        pos, _, next_typ = _item_position(typ, step)
        base = next_pow_of_two(_chunk_count_of(typ))
        root = root * (2 if is_list else 1) * base + pos
        typ = next_typ
    return root


# ---------------------------------------------------------------------------
# Typed single-branch proofs (the ssz_rs `prove` equivalent,
# reference: ssz_rs re-exported at ethereum-consensus/src/ssz/mod.rs:1-8,
# used by spec-tests/runners/light_client.rs:10-13)
# ---------------------------------------------------------------------------


def _top_level_chunk_bytes(typ, value) -> bytes:
    """The populated 32-byte chunks at ``typ``'s top merkle layer
    (pre-length-mixin for list kinds)."""
    from .merkle import pack_bytes

    if isinstance(typ, type) and issubclass(typ, Container):
        return b"".join(
            t.hash_tree_root(getattr(value, key))
            for key, t in typ.__ssz_fields__.items()
        )
    if isinstance(typ, (Vector, List)):
        if _is_basic(typ.elem):
            return pack_bytes(b"".join(typ.elem.serialize(v) for v in value))
        return b"".join(typ.elem.hash_tree_root(v) for v in value)
    if isinstance(typ, (Bitvector, Bitlist)):
        return pack_bytes(_bits_to_bytes(value, include_delimiter=False))
    if isinstance(typ, (ByteVector, ByteList)):
        return pack_bytes(bytes(value))
    raise TypeError(f"cannot chunk {typ!r}")


def _element_at(typ, value, chunk_index: int):
    """(elem_typ, elem_value) under top-layer chunk ``chunk_index`` — only
    meaningful for composite-element kinds (deeper descent)."""
    if isinstance(typ, type) and issubclass(typ, Container):
        key = list(typ.__ssz_fields__)[chunk_index]
        return typ.__ssz_fields__[key], getattr(value, key)
    if isinstance(typ, (Vector, List)) and not _is_basic(typ.elem):
        if chunk_index < len(value):
            return typ.elem, value[chunk_index]
        return typ.elem, typ.elem.default()
    raise TypeError(f"{typ!r}: generalized index descends below chunk layer")


def compute_subtree_root(typ, value, gindex: int) -> bytes:
    """hash of the subtree at ``gindex`` in hash_tree_root(typ, value)."""
    from .merkle import merkleize_chunks, next_pow_of_two, zero_hash

    if gindex < 1:
        raise ValueError("generalized index must be >= 1")
    if gindex == 1:
        return hash_tree_root(typ, value)
    bits = bin(gindex)[3:]  # descent path, MSB first

    is_list_kind = isinstance(typ, (List, Bitlist, ByteList))
    if is_list_kind:
        if bits[0] == "1":
            if len(bits) > 1:
                raise ValueError("cannot descend into the length mix-in")
            return len(value).to_bytes(32, "little")
        bits = bits[1:]

    chunks = _top_level_chunk_bytes(typ, value)
    limit = next_pow_of_two(_chunk_count_of(typ))
    depth = (limit - 1).bit_length()
    if not bits:
        return merkleize_chunks(chunks, limit=limit)
    if len(bits) <= depth:
        k = depth - len(bits)
        start = int(bits, 2) << k
        sub = chunks[start * 32 : (start + (1 << k)) * 32]
        if not sub:
            return zero_hash(k)
        return merkleize_chunks(sub, limit=1 << k)
    # deeper than the chunk layer: recurse into the addressed element
    chunk_index = int(bits[:depth], 2)
    elem_typ, elem_val = _element_at(typ, value, chunk_index)
    sub_gindex = int("1" + bits[depth:], 2)
    return compute_subtree_root(elem_typ, elem_val, sub_gindex)


def prove(typ, value, gindex: int) -> list[bytes]:
    """Single-branch merkle proof for ``gindex``: branch[i] is the sibling
    at distance i above the leaf, as consumed by
    is_valid_merkle_branch_for_generalized_index / is_valid_merkle_branch."""
    branch = []
    g = gindex
    while g > 1:
        branch.append(compute_subtree_root(typ, value, g ^ 1))
        g >>= 1
    return branch
