"""The device mesh of the sharded twins, and their two collectives.

The reference's mesh is a 1-D ``jax.sharding.Mesh`` driven by one process
(single-controller): one logical axis carries every batch axis (merkle leaf
ranges, signature batches, validator-registry rows), and ``shard_map``
bodies reduce across it with ``psum`` and ``all_gather``. The port keeps the
single controller: a ``Mesh`` is an ordered tuple of torch devices, each
shard's kernels run on its own device from this one process, and each
shard's small partials are copied to the mesh's first device and reduced
there. The collectives are tiny (three u64 flag sums and a wrap count; one
32-byte root, or one Fq12 value and one G2 point, per shard), so no
communication library is needed. One code path serves one card, several
shards of one card (``virtual_mesh.py``) and several cards.

Reference parity: ethereum_consensus_tpu/parallel/mesh.py (``chip_mesh``
:22, ``default_device_mesh`` :34); the collectives replace ``jax.lax.psum``
and ``jax.lax.all_gather`` inside the reference's ``shard_map`` bodies.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import _device_flags

__all__ = [
    "Mesh",
    "all_gather",
    "chip_mesh",
    "default_device_mesh",
    "device_count",
    "psum_words",
]

_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices: shard i runs on ``devices[i]``, and the
    partials gather on ``devices[0]``."""

    devices: tuple

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @property
    def n_dev(self) -> int:
        return len(self.devices)


def _device_type() -> str:
    """The type of the devices that the routed kernels run on
    (``ops.install(device=...)``, "cuda" by default)."""
    return torch.device(_device_flags.DEVICE).type


def device_count(device_type: "str | None" = None) -> int:
    """The devices of ``device_type`` (the routed type by default): the
    CUDA cards, or the one host for "cpu"."""
    device_type = device_type or _device_type()
    if device_type == "cuda":
        return torch.cuda.device_count()
    return 1


def chip_mesh(n_devices: "int | None" = None) -> Mesh:
    """A mesh over the first ``n_devices`` devices of the routed type (all
    by default); raises when there are fewer."""
    device_type = _device_type()
    available = device_count(device_type)
    n = available if n_devices is None else n_devices
    if n < 1 or n > available:
        raise ValueError(f"requested {n} {device_type} devices, only {available} available")
    if device_type == "cuda":
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    return Mesh((torch.device(device_type),) * n)


def default_device_mesh() -> Mesh:
    return chip_mesh()


def psum_words(parts) -> tuple:
    """The reference's ``psum`` of per-shard u64 words: ``parts`` holds one
    (k,) int64 tensor (u64 bit patterns) or k-sequence per shard; returns
    the k sums mod 2^64 as ints."""
    totals = None
    for part in parts:
        words = [int(v) & _MASK64 for v in (part.tolist() if torch.is_tensor(part) else part)]
        totals = words if totals is None else [(a + b) & _MASK64 for a, b in zip(totals, words)]
    if totals is None:
        raise ValueError("psum_words needs at least one shard")
    return tuple(totals)


def all_gather(parts, mesh: Mesh) -> torch.Tensor:
    """The reference's ``all_gather``: the shards' tensors stacked on the
    mesh's first device."""
    return torch.stack([part.to(mesh.devices[0]) for part in parts])
