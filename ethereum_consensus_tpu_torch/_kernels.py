"""Build and load the CUDA kernels in ``csrc/``.

Each kernel source compiles with ``nvcc`` into a shared library with a plain
C interface, bound with ctypes (pointers and the stream as ``c_void_p``).
A library may add compiler flags to its source's: the ``*_mxu`` builds of
``g1_sum.cu`` and ``pairing.cu`` define ``FP381_MUL_MXU``, which makes every
field product the int8 tensor-core product of ``csrc/fp_mma.h``.
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
import threading
import time

__all__ = ["build_all", "build_log", "library_path", "load", "loaded"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# library name -> (sources, {C function: (argtypes, restype)}[, extra nvcc flags])
_G1_SUM_FUNCTIONS = {
    "g1_sum_sets_launch": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_void_p],
        ctypes.c_int,
    ),
}
_PAIRING_FUNCTIONS = {
    "g1_mul_affine_launch": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_void_p],
        ctypes.c_int,
    ),
    "g2_mul_sum_launch": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "g2_sum_launch": (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "miller_loop_launch": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "fp12_product_launch": (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p],
        ctypes.c_int,
    ),
}
_MXU = ("-DFP381_MUL_MXU",)

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
    "merkle": (
        ("merkle.cu", "merkle_core.h", "sha256_core.h"),
        {
            "merkle_root_launch": (
                [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
                ctypes.c_int,
            ),
            "merkle_latency_launch": (
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p],
                ctypes.c_int,
            ),
        },
    ),
    "shuffle": (
        ("shuffle.cu", "shuffle_core.h"),
        {
            "shuffle_launch": (
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                 ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p],
                ctypes.c_int,
            ),
        },
    ),
    "sweeps": (
        ("sweeps.cu", "sweeps_core.h", "udiv64_core.h", "warp_chunks.h"),
        {
            "effective_balance_launch": (
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                 ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p],
                ctypes.c_int,
            ),
        },
    ),
    "altair_sweeps": (
        ("altair_sweeps.cu", "altair_core.h", "udiv64_core.h", "warp_chunks.h"),
        {
            "flag_deltas_launch": (
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                 ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
                ctypes.c_int,
            ),
            "inactivity_updates_launch": (
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p],
                ctypes.c_int,
            ),
            "inactivity_penalties_launch": (
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p],
                ctypes.c_int,
            ),
        },
    ),
    "fused_epoch": (
        ("fused_epoch.cu", "epoch_pass.h", "masked_sums.h", "altair_core.h", "udiv64_core.h",
         "warp_chunks.h"),
        {
            "fused_epoch_launch": (
                [ctypes.c_void_p] * 7 + [ctypes.c_int64] + [ctypes.c_uint64] * 10
                + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int64]
                + [ctypes.c_void_p] * 3,
                ctypes.c_int,
            ),
            "fused_flag_sums_launch": (
                [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p],
                ctypes.c_int,
            ),
            "fused_epoch_apply_launch": (
                [ctypes.c_void_p] * 7 + [ctypes.c_int64] + [ctypes.c_uint64] * 13
                + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4,
                ctypes.c_int,
            ),
            "rewards_apply_launch": (
                [ctypes.c_void_p] * 7 + [ctypes.c_int64] + [ctypes.c_uint64] * 11
                + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3,
                ctypes.c_int,
            ),
        },
    ),
    "epoch_staged": (
        ("epoch_staged.cu", "epoch_staged_core.h", "altair_core.h", "udiv64_core.h",
         "warp_chunks.h"),
        {
            "staged_inactivity_launch": (
                [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint64,
                                         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
                ctypes.c_int,
            ),
            "staged_flag_deltas_launch": (
                [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_uint64] * 4
                + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3,
                ctypes.c_int,
            ),
            "staged_apply_pairs_launch": (
                [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                                         ctypes.c_void_p],
                ctypes.c_int,
            ),
        },
    ),
    "chain_step": (
        ("chain_step.cu", "chain_step_core.h", "epoch_pass.h", "masked_sums.h",
         "altair_core.h", "udiv64_core.h", "sweeps_core.h", "warp_chunks.h"),
        {
            "chain_step_shard_launch": (
                [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_uint64] * 4
                + [ctypes.c_void_p] * 4,
                ctypes.c_int,
            ),
            "epoch_step_sums_launch": (
                [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p],
                ctypes.c_int,
            ),
            "epoch_step_apply_launch": (
                [ctypes.c_void_p] * 7 + [ctypes.c_int64] + [ctypes.c_uint64] * 13
                + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3,
                ctypes.c_int,
            ),
        },
    ),
    "g1_sum": (("g1_sum.cu", "g1_sum_lanes.h", "pairing_lanes.h", "fp_tower.h", "fp381_core.h"),
               _G1_SUM_FUNCTIONS),
    "g1_sum_mxu": (("g1_sum.cu", "fp381_core.h", "fp_mma.h"), _G1_SUM_FUNCTIONS, _MXU),
    "pairing": (("pairing.cu", "pairing_lanes.h", "fp_tower.h", "fp381_core.h"),
                _PAIRING_FUNCTIONS),
    "pairing_mxu": (("pairing.cu", "fp_tower.h", "fp381_core.h", "fp_mma.h"),
                    _PAIRING_FUNCTIONS, _MXU),
    "mont_mxu": (
        ("mont_mxu.cu", "fp_mma.h", "fp381_core.h"),
        {
            "mont_mxu_launch": (
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                 ctypes.c_void_p],
                ctypes.c_int,
            ),
        },
    ),
}

_LOADED: dict = {}
# double-checked: two threads that first use a library at once (the chain
# pipeline's verifier lanes beside stage A) build and ledger it once
_LOAD_LOCK = threading.Lock()
# held around every ``launch_count(s)`` increment in ops/: the counts stay
# exact when threads launch at once
LAUNCH_LOCK = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _flags(name: str) -> list:
    """nvcc's flags for library ``name``: the common ones and its own."""
    entry = _LIBRARIES[name]
    return [*NVCC_FLAGS, *(entry[2] if len(entry) > 2 else ())]


def _paths(name: str) -> tuple[str, str]:
    sources = _LIBRARIES[name][0]
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    for src in sources:
        with open(os.path.join(_CSRC, src), "rb") as f:
            digest.update(f.read())
    stem = os.path.join(_BUILD, f"{name}-{digest.hexdigest()[:16]}")
    return stem + ".so", stem + ".log"


def library_path(name: str) -> str:
    """The path of the current build of ``name`` (built or not)."""
    return _paths(name)[0]


def loaded() -> tuple:
    """The names of the libraries this process has loaded."""
    return tuple(_LOADED)


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills) of the
    current build of ``name``."""
    with open(_paths(name)[1]) as f:
        return f.read()


def build_all(names=None) -> float:
    """Compile every library (or those of ``names``) that is not built yet,
    one ``nvcc`` per source, all started together. Returns the wall
    seconds; raises with the compiler's output when any build fails."""
    t0 = time.perf_counter()
    os.makedirs(_BUILD, exist_ok=True)
    running = []
    for name, (sources, *_) in _LIBRARIES.items():
        if names is not None and name not in names:
            continue
        lib_path, log_path = _paths(name)
        if os.path.exists(lib_path):
            continue
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_flags(name), "-o", tmp, os.path.join(_CSRC, sources[0])]
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
    """The bound library ``name``, built first if needed. Its first load
    in the process goes into the device observatory's compile ledger
    (built or reused, and the seconds)."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    from .telemetry import device as _obs

    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        t0 = time.perf_counter()
        lib_path, _ = _paths(name)
        built = not os.path.exists(lib_path)
        if built:
            build_all()
        lib = ctypes.CDLL(lib_path)
        for fn_name, (argtypes, restype) in _LIBRARIES[name][1].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LOADED[name] = lib
        _obs.library(name, t0, time.perf_counter(), built)
        return lib
