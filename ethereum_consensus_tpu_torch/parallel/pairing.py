"""Mesh-sharded RLC batch signature verification.

The signature-set axis is the mesh axis: each shard runs the blinder
multiplications, the Miller loops and its local Fq12 product and G2 sum
for its slice of the batch on its own device (B7, ``ops/pairing.py``);
only the per-shard partials (one Fq12 value and one Jacobian G2 point)
gather on the mesh's first device, where B7's own kernels fold them
(``fp12_product``, and ``g2_sum_points`` on ``g2_mul_sum``'s fold). The
final exponentiation stays in the native library, as on the unsharded
route.

Padding discipline, as the reference's: lanes pad to ``n_dev × 2^k`` with
generator points; padded pk/H lanes are masked to one before the local
Fq12 product (a validity column), and padded signature lanes carry
blinder 0, whose multiple is the identity the G2 fold skips. A window of
528 sets on one shard therefore pads to 1,024 lanes: the reference's own
behaviour, about twice the unsharded route's Miller work.

Reference parity: ethereum_consensus_tpu/parallel/pairing.py (``_pad_width``
:77, ``miller_partials_sharded`` :83, ``batch_verify_sharded`` :147).
"""

from __future__ import annotations

import torch

from ..native import bls as native_bls
from ..ops import pairing as dp
from .mesh import Mesh, all_gather, default_device_mesh

__all__ = ["batch_verify_sharded", "miller_partials_sharded"]


def _pad_width(n: int, n_dev: int) -> int:
    """Lanes per shard: the next power of two covering ceil(n/n_dev)."""
    per = -(-n // n_dev)
    return 1 << (per - 1).bit_length() if per > 1 else 1


def _fp12_ones(k: int, device) -> torch.Tensor:
    """(k, 2, 3, 2, 12) canonical Fq12 ones."""
    one = torch.zeros((k, 2, 3, 2, 12), dtype=torch.int32, device=device)
    one[:, 0, 0, 0, 0] = 1
    return one


def _shard_partials(device, pk_raws, h_raws, sig_raws, pk_scalars, sig_scalars, valid):
    """One shard's (Fq12 product of its valid lanes, Jacobian G2 sum of its
    blinded signatures), on ``device``."""
    k = len(pk_raws)
    xp, yp = dp.g1_mul_batched(dp.g1_affine_from_raw(pk_raws, device), pk_scalars)
    fs = dp.miller_loop_batched(xp, yp, *dp.g2_affine_from_raw(h_raws, device))
    mask = torch.tensor(valid, dtype=torch.bool).to(device)[:, None, None, None, None]
    local_f = dp.fp12_product(torch.where(mask, fs, _fp12_ones(k, device)))
    sig = torch.stack(dp.g2_affine_from_raw(sig_raws, device), dim=1).contiguous()
    local_sig = dp.g2_mul_sum(sig, dp.scalar_words(sig_scalars, device))
    return local_f, local_sig


def miller_partials_sharded(mesh: Mesh, pk_raws, h_raws, sig_raws, scalars):
    """Shard the batch over ``mesh`` and return the partials
    ``(f_total, s_raw, s_inf)`` ready for ``ops.pairing.finalize_verdict``:
    the (2, 3, 2, 12) Miller product on the mesh's first device, and the
    affine raw192 signature sum with its infinity flag.

    Inputs are those of ``batch_verify_device`` (non-identity pk
    aggregates, hash points, signatures as raw affine bytes, nonzero
    128-bit blinders)."""
    n = len(pk_raws)
    n_dev = mesh.n_dev
    if not n or not len(h_raws) == len(sig_raws) == len(scalars) == n:
        raise ValueError("need one pubkey, message point, signature and scalar per set")
    from . import runtime as _runtime

    _runtime.fault_point("pairing", sets=n, devices=n_dev)

    k = _pad_width(n, n_dev)
    width = n_dev * k
    g1f, g2f = native_bls.g1_generator_raw(), native_bls.g2_generator_raw()
    pk_padded = list(pk_raws) + [g1f] * (width - n)
    h_padded = list(h_raws) + [g2f] * (width - n)
    sig_padded = list(sig_raws) + [g2f] * (width - n)
    pk_scalars = list(scalars) + [1] * (width - n)
    sig_scalars = list(scalars) + [0] * (width - n)
    valid = [True] * n + [False] * (width - n)

    partials = [
        _shard_partials(device, pk_padded[i * k:(i + 1) * k], h_padded[i * k:(i + 1) * k],
                        sig_padded[i * k:(i + 1) * k], pk_scalars[i * k:(i + 1) * k],
                        sig_scalars[i * k:(i + 1) * k], valid[i * k:(i + 1) * k])
        for i, device in enumerate(mesh.devices)
    ]
    f_total = dp.fp12_product(all_gather([f for f, _ in partials], mesh))
    s_raw, s_inf = dp._g2_point_to_raw(dp.g2_sum_points(all_gather([s for _, s in partials],
                                                                   mesh)))
    return f_total, s_raw, s_inf


def batch_verify_sharded(pk_raws, h_raws, sig_raws, scalars, mesh: "Mesh | None" = None) -> bool:
    """The RLC batch verdict with the set axis sharded over a device mesh —
    semantics identical to ``ops.pairing.batch_verify_device``."""
    mesh = mesh if mesh is not None else default_device_mesh()
    f_total, s_raw, s_inf = miller_partials_sharded(mesh, pk_raws, h_raws, sig_raws, scalars)
    return dp.finalize_verdict(f_total, s_raw, s_inf, device=mesh.devices[0])
