"""Device kernels (CUDA C++ for Hopper): SHA-256 merkleization.

Importing this package imports torch but builds nothing; the pure-host
layers (ssz/, models/) never import it — device acceleration is installed
explicitly via ``install()``.
"""

from ..ssz.hash import register_device_hasher
from .merkle import merkleize_chunks_device
from .sha256 import install_device_hasher, sha256_64b, sha256_64b_plain


def install(device="cuda") -> None:
    """Route SHA-256 hash levels above ssz.hash.DEVICE_MIN_NODES
    (merkleization) through the kernel on ``device``.

    Spec semantics are unchanged — the kernel is bit-identical to hashlib;
    the threshold only decides where the work runs. With ``device="cuda"``
    and no card this raises."""
    install_device_hasher(device=device)


def uninstall() -> None:
    """Send every hash level back to the host backends."""
    register_device_hasher(None)


__all__ = [
    "install",
    "install_device_hasher",
    "merkleize_chunks_device",
    "sha256_64b",
    "sha256_64b_plain",
    "uninstall",
]
