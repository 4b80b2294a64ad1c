"""The port's SHA-256 against the reference package and hashlib.

Bit-exact throughout: the results are integers. The reference's
``sha256_64b`` dispatcher routes to ``sha256_64b_xla`` on a CPU backend,
which is how its own tests run it (the Pallas interpret tests stay skipped
there). The kernel's arithmetic header is built here with g++ and held
against hashlib; the kernel itself runs only where a CUDA card is present.
"""

import ctypes
import hashlib
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ethereum_consensus_tpu.ops import sha256 as ref_sha
from ethereum_consensus_tpu_torch.ops import sha256 as port_sha

CSRC = Path(port_sha.__file__).resolve().parents[1] / "csrc"
EDGE_PATTERNS = [b"\x00" * 64, b"\xff" * 64, bytes(range(64))]


def _words(msgs: bytes) -> np.ndarray:
    """(16, N) uint32 big-endian words, lanes last."""
    n = len(msgs) // 64
    return np.ascontiguousarray(
        np.frombuffer(msgs, dtype=">u4").astype(np.uint32).reshape(n, 16).T
    )


def _hashlib(msgs: bytes) -> bytes:
    return b"".join(
        hashlib.sha256(msgs[i : i + 64]).digest() for i in range(0, len(msgs), 64)
    )


def _digest_bytes(out_u32: np.ndarray) -> bytes:
    return out_u32.T.astype(">u4").tobytes()


def _port_plain(words: np.ndarray) -> np.ndarray:
    out = port_sha.sha256_64b_plain(torch.from_numpy(words.view(np.int32)))
    return out.numpy().view(np.uint32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1025])
def test_plain_matches_reference_and_hashlib(n):
    rng = np.random.default_rng(n)
    msgs = rng.bytes(64 * n)
    words = _words(msgs)
    got = _port_plain(words)
    assert got.shape == (8, n)
    assert (got == np.asarray(ref_sha.sha256_64b_xla(jnp.asarray(words)))).all()
    assert (got == np.asarray(ref_sha.sha256_64b(jnp.asarray(words)))).all()
    assert _digest_bytes(got) == _hashlib(msgs)


@pytest.mark.parametrize("pattern", EDGE_PATTERNS, ids=["zeros", "ones", "counting"])
def test_plain_edge_patterns(pattern):
    words = _words(pattern)
    got = _port_plain(words)
    assert (got == np.asarray(ref_sha.sha256_64b_xla(jnp.asarray(words)))).all()
    assert _digest_bytes(got) == hashlib.sha256(pattern).digest()


def test_dispatcher_takes_plain_version_for_cpu_tensor():
    words = torch.from_numpy(_words(np.random.default_rng(5).bytes(64 * 9)).view(np.int32))
    before = port_sha.launch_count
    assert torch.equal(port_sha.sha256_64b(words), port_sha.sha256_64b_plain(words))
    assert port_sha.launch_count == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    good = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        port_sha.sha256_64b(good.to(torch.int64))
    with pytest.raises(ValueError):
        port_sha.sha256_64b(torch.zeros((8, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        port_sha.sha256_64b(torch.zeros((16, 0), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_sha.sha256_64b_cuda(good)


def test_hash_level_bytes_matches_reference():
    rng = np.random.default_rng(2)
    nodes = rng.bytes(64 * 33)
    got = port_sha.hash_level_bytes(nodes, device="cpu")
    assert got == ref_sha.hash_level_bytes(nodes)
    assert got == _hashlib(nodes)


_HOST_SHIM = r"""
#include "sha256_core.h"
// The kernel's per-message arithmetic over the kernel's (16, n) -> (8, n)
// lanes-last layout, on the host.
extern "C" void sha256_64b_host(const uint32_t* in, uint32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t msg[16], digest[8];
    for (int w = 0; w < 16; ++w) msg[w] = in[w * n + i];
    sha256_core::digest_64b(msg, digest);
    for (int w = 0; w < 8; ++w) out[w * n + i] = digest[w];
  }
}
"""


def test_kernel_header_host_build_matches_hashlib(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    shim = tmp_path / "shim.cpp"
    shim.write_text(_HOST_SHIM)
    lib_path = tmp_path / "libsha256_core.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
         f"-I{CSRC}", str(shim), "-o", str(lib_path)],
        check=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.sha256_64b_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.sha256_64b_host.restype = None
    msgs = np.random.default_rng(11).bytes(64 * 1000) + b"".join(EDGE_PATTERNS)
    words = _words(msgs)
    n = words.shape[1]
    out = np.zeros((8, n), dtype=np.uint32)
    lib.sha256_64b_host(words.ctypes.data, out.ctypes.data, n)
    assert _digest_bytes(out) == _hashlib(msgs)


@pytest.mark.parametrize("n", [1, 1000, 1024, 1025])
def test_kernel_matches_plain_on_card(cuda, n):
    msgs = np.random.default_rng(n).bytes(64 * n)
    words = torch.from_numpy(_words(msgs).view(np.int32)).to(cuda)
    got = port_sha.sha256_64b(words)
    torch.cuda.synchronize()
    assert torch.equal(got, port_sha.sha256_64b_plain(words))
    assert _digest_bytes(got.cpu().numpy().view(np.uint32)) == _hashlib(msgs)
