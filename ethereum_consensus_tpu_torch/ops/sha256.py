"""Batched SHA-256 of 64-byte messages: the CUDA kernel and its plain version.

The SSZ merkleization hot path (SURVEY.md §3.1) is millions of independent
SHA-256 hashes of exactly 64 bytes (two 32-byte child nodes). A 64-byte
message compresses in exactly two blocks: the message, then the constant pad
block (0x80…, bit length 512).

Layout, as in the reference: messages are ``(16, N)`` big-endian words with
lanes last, digests ``(8, N)``. The words are ``torch.int32`` tensors holding
the uint32 bit patterns (torch's uint32 has no ``+`` or ``>>``).

Two paths, bit-identical:
  - ``sha256_64b_cuda``: the Hopper kernel in ``csrc/sha256.cu``;
  - ``sha256_64b_plain``: plain PyTorch on int64 with explicit 32-bit masks.
``sha256_64b`` takes the plain version for a CPU tensor only; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from .. import _kernels
from ..telemetry import device as _obs
from ..convert import chunks_from_words, words_from_chunks
from ..ssz.hash import register_device_hasher

__all__ = [
    "H0",
    "K",
    "hash_level_bytes",
    "install_device_hasher",
    "launch_count",
    "sha256_64b",
    "sha256_64b_cuda",
    "sha256_64b_plain",
]

# SHA-256 round constants (FIPS 180-4).
K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
    0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
    0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
    0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

# Initial hash state.
H0 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

_MASK = 0xFFFFFFFF

# Kernel launches since the count was last set to 0 (``sha256_64b_cuda``
# adds one per launch and nowhere else).
launch_count = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate right of non-negative 32-bit values held in int64."""
    return ((x >> n) | (x << (32 - n))) & _MASK


def _compress_plain(state: list, w: list) -> list:
    """One compression of block ``w`` (16 rows, consumed) into ``state``."""
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        if t < 16:
            wt = w[t]
        else:
            w15 = w[(t - 15) % 16]
            w2 = w[(t - 2) % 16]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            wt = (w[t % 16] + s0 + w[(t - 7) % 16] + s1) & _MASK
            w[t % 16] = wt
        big_s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _MASK) & g)
        t1 = (h + big_s1 + ch + K[t] + wt) & _MASK
        big_s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (big_s0 + maj) & _MASK
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _MASK, c, b, a, (t1 + t2) & _MASK
    return [(s + v) & _MASK for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def _check_words(words: torch.Tensor) -> int:
    if words.dtype != torch.int32:
        raise TypeError(f"message words must be torch.int32, got {words.dtype}")
    if words.dim() != 2 or words.shape[0] != 16 or words.shape[1] < 1:
        raise ValueError(f"message words must be (16, N) with N >= 1, got {tuple(words.shape)}")
    return words.shape[1]


def sha256_64b_plain(words: torch.Tensor) -> torch.Tensor:
    """SHA-256 of N 64-byte messages in plain PyTorch: (16, N) → (8, N) int32."""
    n = _check_words(words)
    w = words.to(torch.int64) & _MASK
    full = functools.partial(torch.full, (n,), dtype=torch.int64, device=words.device)
    state = _compress_plain([full(v) for v in H0], list(w.unbind(0)))
    pad = [full(0x80000000)] + [full(0)] * 14 + [full(512)]
    out = torch.stack(_compress_plain(state, pad))
    # uint32 values to their int32 bit patterns
    return (out - ((out & 0x80000000) << 1)).to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def sha256_64b_cuda(words: torch.Tensor) -> torch.Tensor:
    """SHA-256 of N 64-byte messages on the card (csrc/sha256.cu).

    ``words`` is a contiguous (16, N) int32 CUDA tensor; returns (8, N)."""
    global launch_count
    n = _check_words(words)
    if words.device.type != "cuda":
        raise ValueError(f"sha256_64b_cuda needs a CUDA tensor, got {words.device}")
    if not words.is_contiguous():
        raise ValueError("message words must be contiguous")
    lib = _kernels.load("sha256")
    out = torch.empty((8, n), dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.sha256_64b_launch(words.data_ptr(), out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"sha256_64b kernel launch failed: CUDA error {rc}")
    with _kernels.LAUNCH_LOCK:
        launch_count += 1
    _obs.launch("sha256_64b")
    return out


def sha256_64b(words: torch.Tensor) -> torch.Tensor:
    """Batched SHA-256: the kernel for a CUDA tensor, the plain version for
    a CPU tensor. (16, N) → (8, N) int32."""
    if words.device.type == "cpu":
        return sha256_64b_plain(words)
    return sha256_64b_cuda(words)


# ---------------------------------------------------------------------------
# Host bridge: bytes ↔ device words
# ---------------------------------------------------------------------------


def hash_level_bytes(nodes: bytes, device="cuda") -> bytes:
    """Device equivalent of ssz.hash.hash_level_host: ``nodes`` is 2n 32-byte
    nodes concatenated; returns n parent nodes. Bit-identical to hashlib."""
    words = _obs.h2d("ops.sha256.hash_level", words_from_chunks(nodes, "cpu", width=16),
                     device=device)
    return chunks_from_words(_obs.d2h("ops.sha256.hash_level", sha256_64b(words)))


def install_device_hasher(device="cuda") -> None:
    """Route ssz merkleization's large levels (``ssz.hash.DEVICE_MIN_NODES``
    parent nodes and up) through ``hash_level_bytes`` on ``device``.

    For a CUDA device this needs a card and builds the kernel now, so a
    machine that cannot run it fails here rather than at the first level."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("install_device_hasher: no CUDA device is available")
        _kernels.load("sha256")
    register_device_hasher(functools.partial(hash_level_bytes, device=device))
