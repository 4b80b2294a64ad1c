"""Several shards of one device: the sharded code paths on one card, or on
the host.

The reference tests its sharding on a virtual multi-device CPU platform
(``XLA_FLAGS=--xla_force_host_platform_device_count=N`` in a fresh process,
ethereum_consensus_tpu/parallel/virtual_mesh.py:33 ``cpu_mesh_env``). The
port's mesh is a tuple of torch devices, so the counterpart needs no
subprocess: ``virtual_mesh(n, device)`` repeats one device n times. The
tests use it on "cpu" (each shard through the kernels' plain versions);
``chip_smoke.py`` uses it on "cuda" to hold 4 shards on the one card
against the unsharded kernels.
"""

from __future__ import annotations

import torch

from .mesh import Mesh

__all__ = ["virtual_mesh"]


def virtual_mesh(n_shards: int, device="cuda") -> Mesh:
    """A mesh of ``n_shards`` shards, all on ``device``."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    return Mesh((torch.device(device),) * n_shards)
