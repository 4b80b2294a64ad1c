"""Native C++ backend: builds and loads the SHA-256 merkle kernels.

The host rung of the hashing ladder (hashlib → native → device): a
from-scratch C++ SHA-256 merkle library compiled on first use with the
system toolchain and loaded via ctypes. With no ``g++`` on the machine
the package stays on hashlib; a build that fails raises with the
compiler's message.

``install()`` registers the native hasher with ssz.hash so every
hash_tree_root below the device threshold runs native.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = [
    "load",
    "available",
    "hash_level_native",
    "merkle_root_native",
    "install",
]

_SOURCE = os.path.join(os.path.dirname(__file__), "sha256_merkle.cpp")
_LIB = None
_TRIED = False


def _build_dir() -> str:
    path = os.path.join(os.path.dirname(__file__), "_build")
    os.makedirs(path, exist_ok=True)
    return path


def _source_tag() -> str:
    with open(_SOURCE, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def load():
    """Compile (once per source hash) + load the shared library; None when
    the machine has no ``g++``."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    lib_path = os.path.join(_build_dir(), f"sha256_merkle-{_source_tag()}.so")
    if not os.path.exists(lib_path):
        if shutil.which("g++") is None:
            return None
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build_dir())
        os.close(fd)
        try:
            proc = subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SOURCE,
                 "-o", tmp],
                capture_output=True,
                text=True,
                timeout=120,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"native SHA-256 build failed:\n{proc.stderr}"
                )
            os.replace(tmp, lib_path)  # atomic under concurrent builds
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(lib_path)
    lib.ec_hash_level.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.ec_hash_level.restype = None
    lib.ec_merkle_root.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.ec_merkle_root.restype = None
    lib.ec_version.restype = ctypes.c_uint64
    _LIB = lib
    return lib


def available() -> bool:
    return load() is not None


def _require_lib():
    lib = load()
    if lib is None:
        raise RuntimeError("native backend unavailable: no g++ found")
    return lib


def hash_level_native(nodes: bytes) -> bytes:
    """Native twin of ssz.hash.hash_level_host."""
    lib = _require_lib()
    n_pairs = len(nodes) // 64
    out = ctypes.create_string_buffer(n_pairs * 32)
    lib.ec_hash_level(nodes, out, n_pairs)
    return out.raw


def merkle_root_native(chunks: bytes, depth: int, zero_hashes: bytes) -> bytes:
    """Whole-tree reduction in one native call (``zero_hashes`` = depth+1
    concatenated 32-byte zero-subtree roots)."""
    lib = _require_lib()
    out = ctypes.create_string_buffer(32)
    lib.ec_merkle_root(chunks, len(chunks) // 32, depth, zero_hashes, out)
    return out.raw


def install() -> bool:
    """Register the native hasher with the SSZ hash dispatch; returns
    whether the native path is active."""
    if not available():
        return False
    from ..ssz import hash as hash_module

    hash_module.register_native_hasher(hash_level_native)
    return True
