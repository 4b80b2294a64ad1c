"""SSZ subsystem: type algebra, codec, merkleization, proofs.

Replaces the reference's `ssz_rs` dependency (re-exported at
ethereum-consensus/src/ssz/mod.rs:1-8). ``prelude`` mirrors
`ssz::prelude::*`.
"""

from . import core, hash, merkle
from .core import (
    INSTRUMENTED_LIST_MUTATORS,
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    DeserializeError,
    List,
    SSZType,
    Union,
    Vector,
    boolean,
    deserialize,
    get_generalized_index,
    hash_tree_root,
    instrumented_surface,
    prove,
    compute_subtree_root,
    serialize,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)
from .merkle import (
    compute_merkle_proof,
    concat_generalized_indices,
    get_generalized_index_length,
    is_valid_merkle_branch,
    is_valid_merkle_branch_for_generalized_index,
    merkleize_chunks,
    zero_hash,
)

prelude = core

__all__ = [
    "core",
    "hash",
    "merkle",
    "INSTRUMENTED_LIST_MUTATORS",
    "instrumented_surface",
    "Bitlist",
    "Bitvector",
    "ByteList",
    "ByteVector",
    "Container",
    "DeserializeError",
    "List",
    "SSZType",
    "Union",
    "Vector",
    "boolean",
    "deserialize",
    "get_generalized_index",
    "hash_tree_root",
    "prove",
    "compute_subtree_root",
    "serialize",
    "uint8",
    "uint16",
    "uint32",
    "uint64",
    "uint128",
    "uint256",
    "compute_merkle_proof",
    "concat_generalized_indices",
    "get_generalized_index_length",
    "is_valid_merkle_branch",
    "is_valid_merkle_branch_for_generalized_index",
    "merkleize_chunks",
    "zero_hash",
]
