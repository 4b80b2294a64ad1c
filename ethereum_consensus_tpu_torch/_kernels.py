"""Build and load the CUDA kernels in ``csrc/``.

Each kernel source compiles with ``nvcc`` into a shared library with a plain
C interface, bound with ctypes (pointers and the stream as ``c_void_p``).
Libraries go into ``_build/`` beside this file, named by a hash of the
sources and flags, so a source edit rebuilds and an unchanged tree reuses
the library. Builds happen on first use, never at import: the package
imports on machines without a CUDA toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["build_all", "build_log", "load"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# library name -> (sources, {C function: (argtypes, restype)})
_LIBRARIES = {
    "sha256": (
        ("sha256.cu", "sha256_core.h"),
        {
            "sha256_64b_launch": (
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_void_p],
                ctypes.c_int,
            ),
        },
    ),
}

_LOADED: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _paths(name: str) -> tuple[str, str]:
    sources, _ = _LIBRARIES[name]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(os.path.join(_CSRC, src), "rb") as f:
            digest.update(f.read())
    stem = os.path.join(_BUILD, f"{name}-{digest.hexdigest()[:16]}")
    return stem + ".so", stem + ".log"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills) of the
    current build of ``name``."""
    with open(_paths(name)[1]) as f:
        return f.read()


def build_all() -> float:
    """Compile every library that is not built yet, one ``nvcc`` per source,
    all started together. Returns the wall seconds; raises with the
    compiler's output when any build fails."""
    t0 = time.perf_counter()
    os.makedirs(_BUILD, exist_ok=True)
    running = []
    for name, (sources, _) in _LIBRARIES.items():
        lib_path, log_path = _paths(name)
        if os.path.exists(lib_path):
            continue
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, sources[0])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, proc, tmp, lib_path, log_path))
    failures = []
    for name, proc, tmp, lib_path, log_path in running:
        output, _ = proc.communicate()
        with open(log_path, "w") as f:
            f.write(output)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{output}")
            continue
        os.replace(tmp, lib_path)  # atomic under concurrent builds
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    lib_path, _ = _paths(name)
    if not os.path.exists(lib_path):
        build_all()
    lib = ctypes.CDLL(lib_path)
    for fn_name, (argtypes, restype) in _LIBRARIES[name][1].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    _LOADED[name] = lib
    return lib
