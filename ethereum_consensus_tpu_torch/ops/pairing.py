"""BLS12-381 RLC batch verification on the card: the CUDA kernels of the
batched pairing (csrc/pairing.cu) and their plain versions.

    prod_i e([r_i] pk_i, H_i) * e(-G, sum_i [r_i] sig_i) == 1

The O(N) group work of ``verify_signature_sets``' random linear
combination runs as four kernels:

  - ``g1_mul_affine``: [r_i] pk_i for the 128-bit blinders, MSB first,
    then affine through one inversion per lane (a warp a lane, its Fp
    products spread over the warp's threads, the inversion a binary
    extended Euclid);
  - ``g2_mul_sum``: sum_i [r_i] sig_i as one Jacobian G2 point (a lanes
    pass, a warp a lane, writes each [r_i] sig_i; fold launches pair
    neighbours inside 64-lane blocks, then the block partials);
  - ``miller_loop``: f_{|x|,Q_i}(P_i), conjugated, per lane (a warp a
    lane, its Fp2 products spread over the warp's threads);
  - ``fp12_product``: the product of the Miller values (a warp a
    product of two values, 32 values a block, then the block partials).

The sum S is taken first, so the extra pair e(-G, S) rides as lane n of
the one Miller launch and into the product (the reference runs it through
its Miller loop at n = 1 and multiplies on the host: the same Fq12 value,
since the product's order does not change it); the final exponentiation
verdict is the native library's (``fp12_final_exp_is_one``): scalar and
branchy, the wrong shape for the card. ``finalize_verdict``, which closes
the mesh twin's partials, still runs the extra pair at n = 1.

Layout at the tensor boundary: canonical (not Montgomery) values as int32
tensors carrying the uint32 limb bit patterns, 12 limbs of 32 bits, least
significant first. G1 affine ``(N, 2, 12)`` (x, y); G2 affine
``(N, 2, 2, 12)`` (x.c0, x.c1, y.c0, y.c1); G2 Jacobian ``(..., 3, 2, 12)``
(x, y, z), all zero for infinity; Fq12 ``(..., 2, 3, 2, 12)`` (the
order of ``fq12.fp12_to_ints``); scalars ``(N, 4)``, least significant
word first.

Under the "mxu" multiplier (``fq8.set_multiplier("mxu")`` or
``EC_PAIRING_MULT=mxu``, the reference's ``fql.set_multiplier``) the
wrappers launch the mxu build of the same kernels, one warp per lane with
every Fp product on the int8 tensor cores (csrc/fp_mma.h), counted under
``name + "_mxu"``; the plain versions multiply through ``fq8.mul``. The
values are the same on both.

Each kernel has a ``*_plain`` twin over the plain tower (ops/fq.py,
fq2.py, fq12.py) with the same formulas, so the two agree limb for limb;
the dispatcher takes the plain version for CPU tensors only and, for CUDA
tensors, launches the kernel or raises. ``launch_counts`` counts each
kernel's grid launches (a wrapper adds them where it launches, nowhere
else): one per call, and one more per fold level beyond a block's values
(``fp12_product``: 32 in the u64 build, 64 in the mxu build) or per fold
level at all (``g2_mul_sum``, whose lanes pass is the first launch). ``g2_sum_points`` (the sum of Jacobian
points, which the mesh twin's per-shard partials take) runs
``g2_mul_sum``'s fold kernel alone and counts under its name.

The reference is ethereum_consensus_tpu/ops/pairing.py, whose public names
and argument order these are. It pads batches to powers of two with
generator lanes so that jit reuses shapes; the port launches at any n with
the same verdicts and values. Its Miller steps, like these, copy the
native library's (native/bls12_381.cpp), so every Miller value equals the
native ``miller_loop_raw``.

``g1_sum_sets`` is the reference's raw-bytes set aggregation (:616, over
its lazy-field fold :594): B6 (``ops/g1.py``) per set, the sets padded to
the widest set's power of two with infinity lanes as the reference pads
them; its ``sharding`` argument becomes ``mesh``, whose shards each sum a
contiguous slice of the sets on their own device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device_flags, _kernels
from ..crypto.fields import Fq, Fq2, Fq6, Fq12
from ..native import bls as native_bls
from . import fq, fq2, fq8, fq12, g1

__all__ = [
    "BLS_X_ABS",
    "batch_verify_device",
    "finalize_verdict",
    "fp12_product",
    "fp12_product_cuda",
    "fp12_product_plain",
    "g1_affine_from_raw",
    "g1_mul_affine",
    "g1_mul_affine_cuda",
    "g1_mul_affine_plain",
    "g1_mul_batched",
    "g1_sum_sets",
    "g2_affine_from_raw",
    "g2_mul_batched",
    "g2_mul_sum",
    "g2_mul_sum_cuda",
    "g2_mul_sum_plain",
    "g2_sum_points",
    "g2_sum_points_cuda",
    "g2_sum_points_plain",
    "launch_counts",
    "miller_loop",
    "miller_loop_batched",
    "miller_loop_cuda",
    "miller_loop_plain",
    "miller_product_device",
    "scalar_words",
]

BLS_X_ABS = 0xD201000000010000
# the bits below the top bit of |x|, MSB first: the Miller schedule
_X_BITS = [int(b) for b in bin(BLS_X_ABS)[3:]]
SCALAR_WORDS = 4
# points per block of the G2 fold (csrc/pairing.cu kTreeThreads)
TREE_THREADS = 64
# values per block of the u64 Fq12 fold (kFp12FoldValues; the mxu build's 64
# leave fewer partials)
FP12_FOLD_VALUES = 32

KERNELS = ("g1_mul_affine", "g2_mul_sum", "miller_loop", "fp12_product")
# Kernel launches since the counts were last set to 0: the u64 kernels under
# their names, the mxu builds' under name + "_mxu".
launch_counts = {f"{name}{suffix}": 0 for suffix in ("", "_mxu") for name in KERNELS}


# ---------------------------------------------------------------------------
# Host marshalling: raw affine big-endian bytes <-> limb tensors
# ---------------------------------------------------------------------------


def _coords(raws: "list[bytes]", per_point: int) -> torch.Tensor:
    """Raw points of ``per_point`` 48-byte big-endian coordinates ->
    (N, per_point, 12) int32 limbs."""
    words = np.frombuffer(b"".join(raws), dtype=">u4").reshape(len(raws), per_point, 12)
    limbs = np.ascontiguousarray(words[:, :, ::-1], dtype=np.uint32)
    return torch.from_numpy(limbs.view(np.int32))


def g1_affine_from_raw(raws: "list[bytes]", device="cuda") -> "tuple[torch.Tensor, torch.Tensor]":
    """Affine raw96 G1 points -> (x, y), each (N, 12). Callers exclude
    infinity."""
    xy = _coords(raws, 2).to(device)
    return xy[:, 0], xy[:, 1]


def g2_affine_from_raw(raws: "list[bytes]", device="cuda") -> "tuple[torch.Tensor, torch.Tensor]":
    """Affine raw192 G2 points (x.c0 || x.c1 || y.c0 || y.c1, the native
    library's format) -> (x, y), each (N, 2, 12)."""
    xy = _coords(raws, 4).reshape(len(raws), 2, 2, 12).to(device)
    return xy[:, 0], xy[:, 1]


def scalar_words(scalars: "list[int]", device="cuda", bits: int = 128) -> torch.Tensor:
    """Blinders below 2^bits (bits <= 128) -> (N, 4) int32 words."""
    if not 0 < bits <= 32 * SCALAR_WORDS:
        raise ValueError(f"bits must be in 1..{32 * SCALAR_WORDS}, got {bits}")
    if any(not 0 <= s < (1 << bits) for s in scalars):
        raise ValueError(f"a scalar is outside [0, 2^{bits})")
    data = b"".join(int(s).to_bytes(4 * SCALAR_WORDS, "little") for s in scalars)
    words = np.frombuffer(data, dtype="<u4").reshape(len(scalars), SCALAR_WORDS)
    return torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# Plain PyTorch version: G1 Jacobian points (..., 3, 24) on the formulas of
# ops/g1.py (those of the kernel, fp381_core.h); G2 Jacobian points
# (..., 3, 2, 24) on the reference's formulas, which fix the coordinates of
# the G2 sum. Montgomery limbs of ops/fq.py; the products of a G2 step are
# stacked into one call.
# ---------------------------------------------------------------------------


def _products(pairs):
    """Fp2 products of the (a, b) pairs, in one call."""
    a, b = zip(*(torch.broadcast_tensors(x, y) for x, y in pairs))
    return fq2.mul(torch.stack(a, dim=-3), torch.stack(b, dim=-3)).unbind(-3)


def _g2_double(p):
    """dbl-2009-l (the reference's g2_point_double); infinity stays
    infinity."""
    x, y, z = p.unbind(-3)
    a, b, yz = _products([(x, x), (y, y), (y, z)])
    xb = fq.add(x, b)
    c, xb2 = _products([(b, b), (xb, xb)])
    d = fq.dbl(fq.sub(fq.sub(xb2, a), c))
    e = fq.add(fq.dbl(a), a)
    (f,) = _products([(e, e)])
    x3 = fq.sub(f, fq.dbl(d))
    (em,) = _products([(e, fq.sub(d, x3))])
    y3 = fq.sub(em, fq.dbl(fq.dbl(fq.dbl(c))))
    return torch.stack([x3, y3, fq.dbl(yz)], dim=-3)


def _g2_add(p, q):
    """add-2007-bl with the doubled slopes (2h, 2r) of the reference's
    g2_point_add, and its selects in its order: q at infinity gives p,
    else p at infinity q, else P == -Q infinity, else P == Q the
    doubling."""
    p, q = torch.broadcast_tensors(p, q)
    x1, y1, z1 = p.unbind(-3)
    x2, y2, z2 = q.unbind(-3)
    z1z1, z2z2, zz = _products([(z1, z1), (z2, z2), (z1, z2)])
    u1, u2, s1p, s2p = _products([(x1, z2z2), (x2, z1z1), (y1, z2), (y2, z1)])
    s1, s2 = _products([(s1p, z2z2), (s2p, z1z1)])
    h = fq.sub(u2, u1)
    r = fq.sub(s2, s1)
    hh = fq.dbl(h)
    r2 = fq.dbl(r)
    i4, r2sq = _products([(hh, hh), (r2, r2)])
    j, v, z3 = _products([(h, i4), (u1, i4), (fq.dbl(zz), h)])
    (s1j,) = _products([(s1, j)])
    x3 = fq.sub(fq.sub(r2sq, j), fq.dbl(v))
    (y3m,) = _products([(r2, fq.sub(v, x3))])
    out = torch.stack([x3, fq.sub(y3m, fq.dbl(s1j)), z3], dim=-3)

    def sel(mask):
        return mask[..., None, None, None]

    h_zero, r_zero = fq2.is_zero(h), fq2.is_zero(r)
    same = h_zero & r_zero
    if bool(same.any()):
        out = torch.where(sel(same), _g2_double(p), out)
    out = torch.where(sel(h_zero & ~r_zero), torch.zeros_like(out), out)
    out = torch.where(sel(fq2.is_zero(z1)), q, out)
    return torch.where(sel(fq2.is_zero(z2)), p, out)


def _point_mul(double, add, points, words):
    """[k_i] P_i for (N, 4) scalar words, MSB first from infinity: double,
    then add P where the bit is set (the reference's _mul_scan_g1/_g2)."""
    k = words.to(torch.int64) & 0xFFFFFFFF
    acc = torch.zeros_like(points)
    for bit in range(32 * SCALAR_WORDS - 1, -1, -1):
        acc = double(acc)
        on = ((k[:, bit // 32] >> (bit % 32)) & 1).bool()
        if bool(on.any()):
            on = on.reshape(on.shape + (1,) * (points.dim() - 1))
            acc = torch.where(on, add(acc, points), acc)
    return acc


def _g1_jacobian(points: torch.Tensor) -> torch.Tensor:
    """(N, 2, 12) canonical affine -> (N, 3, 24) Montgomery Jacobian, z = 1."""
    xy = fq8.to_mont(fq.limbs16(points))
    one = fq.const(fq.R % fq.P_INT, points.device).expand_as(xy[:, 0])
    return torch.stack([xy[:, 0], xy[:, 1], one], dim=-2)


def _g2_jacobian(points: torch.Tensor) -> torch.Tensor:
    """(N, 2, 2, 12) canonical affine -> (N, 3, 2, 24) Montgomery Jacobian."""
    xy = fq8.to_mont(fq.limbs16(points))
    return torch.stack([xy[:, 0], xy[:, 1], fq2.one((points.shape[0],), points.device)], dim=-3)


def _canonical(values: torch.Tensor) -> torch.Tensor:
    return fq.limbs32(fq8.from_mont(values))


def _check(name: str, tensors: dict) -> int:
    """The lane count of int32 tensors of the given trailing shapes, all on
    one device, with one leading lane axis."""
    n, device = None, None
    for label, (t, shape) in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, got {t.dtype}")
        if t.dim() != 1 + len(shape) or tuple(t.shape[1:]) != shape or t.shape[0] < 1:
            raise ValueError(f"{name}: {label} must be (N, {', '.join(map(str, shape))}) "
                             f"with N >= 1, got {tuple(t.shape)}")
        if n is not None and (t.shape[0] != n or t.device != device):
            raise ValueError(f"{name}: the inputs must share N and the device")
        n, device = t.shape[0], t.device
    return n


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _library() -> str:
    """The build of csrc/pairing.cu that the selected multiplier runs."""
    return "pairing_mxu" if fq8.get_multiplier() == "mxu" else "pairing"


def _launch(kernel: str, fn_name: str, *args) -> None:
    """Call the C entry ``fn_name`` of csrc/pairing.cu with ``args``
    (tensors as device pointers) on the current stream: the u64 build, or
    under the "mxu" multiplier the mxu build (one warp a lane, fp_mma.h);
    count each grid launch it made for ``kernel`` (the folds launch once per
    level), the mxu build's under ``kernel + "_mxu"``."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{kernel}: the kernel needs CUDA tensors, got {device}")
    if not all(t.is_contiguous() and t.device == device for t in tensors):
        raise ValueError(f"{kernel}: the tensors must be contiguous on one device")
    name = _library()
    lib = _kernels.load(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
    if rc <= 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {-rc}")
    launch_counts[kernel + "_mxu" if name == "pairing_mxu" else kernel] += rc


def _fold_work(count: int, per_block: int = TREE_THREADS) -> int:
    """Items that a fold of ``per_block`` items a block writes between its
    levels."""
    total = 0
    while count > 1:
        count = -(-count // per_block)
        if count > 1:
            total += count
    return total


# ---------------------------------------------------------------------------
# Kernel 1: G1 blinder multiplication, affine out
# ---------------------------------------------------------------------------


def g1_mul_affine_plain(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """(N, 2, 12) affine, (N, 4) scalars -> (N, 2, 12) affine [k_i] P_i."""
    _check("g1_mul_affine", {"points": (points, (2, 12)), "scalars": (scalars, (4,))})
    x, y, z = _point_mul(g1.point_double, g1.point_add, _g1_jacobian(points),
                         scalars).unbind(-2)
    z_inv = fq8.inv(z)
    z_inv2 = fq8.mul(z_inv, z_inv)
    ax, z_inv3 = fq8.mul(torch.stack([x, z_inv2], dim=-2),
                         torch.stack([z_inv2, z_inv], dim=-2)).unbind(-2)
    return _canonical(torch.stack([ax, fq8.mul(y, z_inv3)], dim=-2))


def g1_mul_affine_cuda(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    n = _check("g1_mul_affine", {"points": (points, (2, 12)), "scalars": (scalars, (4,))})
    out = torch.empty_like(points)
    _launch("g1_mul_affine", "g1_mul_affine_launch", points, scalars, n, out)
    return out


def g1_mul_affine(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if points.device.type == "cpu":
        return g1_mul_affine_plain(points, scalars)
    return g1_mul_affine_cuda(points, scalars)


def g1_mul_batched(points, scalars: "list[int]", bits: int = 128):
    """(x, y) affine G1 lanes times per-lane scalars -> (x, y) affine: the
    reference's g1_mul_batched followed by its _g1_jacobian_to_affine."""
    x, y = points
    out = g1_mul_affine(torch.stack([x, y], dim=1).contiguous(),
                        scalar_words(scalars, x.device, bits))
    return out[:, 0], out[:, 1]


# ---------------------------------------------------------------------------
# Kernel 2: G2 blinder multiplication and the sum
# ---------------------------------------------------------------------------


def g2_mul_batched(points, scalars: "list[int]", bits: int = 128) -> torch.Tensor:
    """(x, y) affine G2 lanes times per-lane scalars -> (N, 3, 2, 12)
    canonical Jacobian, limb for limb the reference's g2_mul_batched
    (plain PyTorch on the points' device)."""
    x, y = points
    affine = torch.stack([x, y], dim=1)
    words = scalar_words(scalars, x.device, bits)
    return _canonical(_point_mul(_g2_double, _g2_add, _g2_jacobian(affine), words))


def _g2_fold(jac: torch.Tensor) -> torch.Tensor:
    """The fold of (N, 3, 2, 24) Montgomery points: neighbours at strides
    1, 2, 4, ..., infinity past the last lane (the reference's XOR-fold
    tree and the kernel's)."""
    while jac.shape[0] > 1:
        if jac.shape[0] % 2:
            jac = torch.cat([jac, torch.zeros_like(jac[:1])])
        jac = _g2_add(jac[0::2], jac[1::2])
    return jac[0]


def g2_sum_points_plain(points: torch.Tensor) -> torch.Tensor:
    """Sum an (N, 3, 2, 12) batch of canonical Jacobian G2 points ->
    (3, 2, 12), limb for limb the reference's g2_sum_points."""
    _check("g2_sum_points", {"points": (points, (3, 2, 12))})
    return _canonical(_g2_fold(fq8.to_mont(fq.limbs16(points))))


def g2_sum_points_cuda(points: torch.Tensor) -> torch.Tensor:
    """The sum by ``g2_mul_sum``'s fold kernel, counted as its launches."""
    n = _check("g2_sum_points", {"points": (points, (3, 2, 12))})
    work = torch.empty((max(_fold_work(n), 1), 3, 2, 12), dtype=torch.int32, device=points.device)
    out = torch.empty((3, 2, 12), dtype=torch.int32, device=points.device)
    _launch("g2_mul_sum", "g2_sum_launch", points, n, work, out)
    return out


def g2_sum_points(points: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if points.device.type == "cpu":
        return g2_sum_points_plain(points)
    return g2_sum_points_cuda(points.contiguous())


def g2_mul_sum_plain(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """(N, 2, 2, 12) affine, (N, 4) scalars -> (3, 2, 12) Jacobian
    sum_i [k_i] Q_i."""
    _check("g2_mul_sum", {"points": (points, (2, 2, 12)), "scalars": (scalars, (4,))})
    return _canonical(_g2_fold(_point_mul(_g2_double, _g2_add, _g2_jacobian(points),
                                          scalars)))


def g2_mul_sum_cuda(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    n = _check("g2_mul_sum", {"points": (points, (2, 2, 12)), "scalars": (scalars, (4,))})
    # the n lanes' points (one lane lands in out), then the fold's levels
    items = 0 if n == 1 else n + _fold_work(n)
    work = torch.empty((max(items, 1), 3, 2, 12), dtype=torch.int32, device=points.device)
    out = torch.empty((3, 2, 12), dtype=torch.int32, device=points.device)
    _launch("g2_mul_sum", "g2_mul_sum_launch", points, scalars, n, work, out)
    return out


def g2_mul_sum(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if points.device.type == "cpu":
        return g2_mul_sum_plain(points, scalars)
    return g2_mul_sum_cuda(points, scalars)


# ---------------------------------------------------------------------------
# Kernel 3: the Miller loop
# ---------------------------------------------------------------------------


def _double_step(f, t, xp, yp):
    """Tangent line and doubling, fused (native miller_double_step)."""
    x, y, z = t.unbind(-3)
    a, b, z2, yz = _products([(x, x), (y, y), (z, z), (y, z)])
    xb = fq.add(x, b)
    c, z3c, x3c, xb2 = _products([(b, b), (z2, z), (a, x), (xb, xb)])
    e = fq.add(fq.dbl(a), a)
    yz3, ez2 = _products([(y, z3c), (e, z2)])
    ly, c12 = fq8.mul(torch.stack([fq.dbl(yz3), ez2], dim=-3),
                     torch.stack([yp, xp], dim=-2)[..., None, :]).unbind(-3)
    c00 = fq.neg(fq2.mul_by_xi(ly))
    c11 = fq.sub(fq.dbl(b), fq.add(fq.dbl(x3c), x3c))
    f = fq12.fp12_mul_by_line(f, c00, c11, c12)
    d = fq.dbl(fq.sub(fq.sub(xb2, a), c))
    (esq,) = _products([(e, e)])
    x3 = fq.sub(fq.sub(esq, d), d)
    (em,) = _products([(e, fq.sub(d, x3))])
    y3 = fq.sub(em, fq.dbl(fq.dbl(fq.dbl(c))))
    return f, torch.stack([x3, y3, fq.dbl(yz)], dim=-3)


def _add_step(f, t, xp, yp, xq, yq):
    """Secant line through T and Q and the mixed addition, fused (native
    miller_add_step)."""
    x, y, z = t.unbind(-3)
    (z2,) = _products([(z, z)])
    z3c, u2 = _products([(z2, z), (xq, z2)])
    (s2,) = _products([(yq, z3c)])
    lam_n = fq.sub(y, s2)
    (lam_d,) = _products([(fq.sub(x, u2), z)])
    ly, c12 = fq8.mul(torch.stack([lam_d, lam_n], dim=-3),
                     torch.stack([yp, xp], dim=-2)[..., None, :]).unbind(-3)
    c00 = fq.neg(fq2.mul_by_xi(ly))
    t1, t2 = _products([(yq, lam_d), (lam_n, xq)])
    f = fq12.fp12_mul_by_line(f, c00, fq.sub(t1, t2), c12)
    h = fq.sub(u2, x)
    rr = fq.dbl(fq.sub(s2, y))
    zh = fq.add(z, h)
    hh, rrsq, zh2 = _products([(h, h), (rr, rr), (zh, zh)])
    i4 = fq.dbl(fq.dbl(hh))
    j, v = _products([(h, i4), (x, i4)])
    x3 = fq.sub(fq.sub(fq.sub(rrsq, j), v), v)
    ym, yj = _products([(rr, fq.sub(v, x3)), (y, j)])
    y3 = fq.sub(ym, fq.dbl(yj))
    z3 = fq.sub(fq.sub(zh2, z2), hh)
    return f, torch.stack([x3, y3, z3], dim=-3)


def miller_loop_plain(xp, yp, xq, yq) -> torch.Tensor:
    """G1 affine xp, yp (N, 12) and G2 affine xq, yq (N, 2, 12) ->
    (N, 2, 3, 2, 12) canonical f_{|x|,Q_i}(P_i), conjugated."""
    n = _check("miller_loop", {"xp": (xp, (12,)), "yp": (yp, (12,)), "xq": (xq, (2, 12)),
                               "yq": (yq, (2, 12))})
    xp, yp, xq, yq = (fq8.to_mont(fq.limbs16(v)) for v in (xp, yp, xq, yq))
    t = torch.stack([xq, yq, fq2.one((n,), xp.device)], dim=-3)
    f = fq12.fp12_one((n,), xp.device)
    for bit in _X_BITS:
        f = fq12.fp12_sqr(f)
        f, t = _double_step(f, t, xp, yp)
        if bit:
            f, t = _add_step(f, t, xp, yp, xq, yq)
    return _canonical(fq12.fp12_conj(f))


def miller_loop_cuda(xp, yp, xq, yq) -> torch.Tensor:
    n = _check("miller_loop", {"xp": (xp, (12,)), "yp": (yp, (12,)), "xq": (xq, (2, 12)),
                               "yq": (yq, (2, 12))})
    out = torch.empty((n, 2, 3, 2, 12), dtype=torch.int32, device=xp.device)
    _launch("miller_loop", "miller_loop_launch", xp, yp, xq, yq, n, out)
    return out


def miller_loop(xp, yp, xq, yq) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if xp.device.type == "cpu":
        return miller_loop_plain(xp, yp, xq, yq)
    return miller_loop_cuda(xp, yp, xq, yq)


def miller_loop_batched(xp, yp, xq, yq) -> torch.Tensor:
    """N Miller loops, each equal to the native ``miller_loop_raw`` of its
    pair (the reference's name; any contiguity)."""
    return miller_loop(*(v.contiguous() for v in (xp, yp, xq, yq)))


# ---------------------------------------------------------------------------
# Kernel 4: the Fq12 product
# ---------------------------------------------------------------------------


def fp12_product_plain(fs: torch.Tensor) -> torch.Tensor:
    """(N, 2, 3, 2, 12) canonical Fq12 values -> their product (2, 3, 2, 12)."""
    _check("fp12_product", {"fs": (fs, (2, 3, 2, 12))})
    vals = fq8.to_mont(fq.limbs16(fs))
    while vals.shape[0] > 1:
        if vals.shape[0] % 2:
            vals = torch.cat([vals, fq12.fp12_one((1,), fs.device)])
        vals = fq12.fp12_mul(vals[0::2], vals[1::2])
    return _canonical(vals[0])


def fp12_product_cuda(fs: torch.Tensor) -> torch.Tensor:
    n = _check("fp12_product", {"fs": (fs, (2, 3, 2, 12))})
    work = torch.empty((max(_fold_work(n, FP12_FOLD_VALUES), 1), 2, 3, 2, 12), dtype=torch.int32,
                       device=fs.device)
    out = torch.empty((2, 3, 2, 12), dtype=torch.int32, device=fs.device)
    _launch("fp12_product", "fp12_product_launch", fs, n, work, out)
    return out


def fp12_product(fs: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if fs.device.type == "cpu":
        return fp12_product_plain(fs)
    return fp12_product_cuda(fs.contiguous())


def miller_product_device(g1_raws: "list[bytes]", g2_raws: "list[bytes]",
                          device="cuda") -> "list[int]":
    """prod_i miller(P_i, Q_i) over finite raw affine pairs, as 12
    canonical ints (the native library's final-exponentiation handoff)."""
    if not g1_raws or len(g1_raws) != len(g2_raws):
        raise ValueError("need as many G1 as G2 points, at least one")
    fs = miller_loop_batched(*g1_affine_from_raw(g1_raws, device),
                             *g2_affine_from_raw(g2_raws, device))
    return fq.to_ints(fp12_product(fs))


# ---------------------------------------------------------------------------
# The RLC batch verdict
# ---------------------------------------------------------------------------


def _g2_point_to_raw(point: torch.Tensor) -> "tuple[bytes, bool]":
    """One (3, 2, 12) canonical Jacobian G2 point -> (raw192 affine,
    is_infinity); the O(1) conversion runs on the host with Python ints."""
    x0, x1, y0, y1, z0, z1 = fq.to_ints(point)
    if z0 == 0 and z1 == 0:
        return b"\x00" * 192, True
    p = fq.P_INT
    norm_inv = pow((z0 * z0 + z1 * z1) % p, -1, p)
    zi0, zi1 = (z0 * norm_inv) % p, (-z1 * norm_inv) % p
    s0 = (zi0 * zi0 - zi1 * zi1) % p
    s1 = (2 * zi0 * zi1) % p
    c0 = (s0 * zi0 - s1 * zi1) % p
    c1 = (s0 * zi1 + s1 * zi0) % p
    ax0 = (x0 * s0 - x1 * s1) % p
    ax1 = (x0 * s1 + x1 * s0) % p
    ay0 = (y0 * c0 - y1 * c1) % p
    ay1 = (y0 * c1 + y1 * c0) % p
    return b"".join(v.to_bytes(48, "big") for v in (ax0, ax1, ay0, ay1)), False


def _neg_g1_generator_raw() -> bytes:
    raw = native_bls.g1_generator_raw()
    y = (fq.P_INT - int.from_bytes(raw[48:], "big")) % fq.P_INT
    return raw[:48] + y.to_bytes(48, "big")


def _fq12(values: "list[int]") -> Fq12:
    f2 = [Fq2(Fq(values[2 * i]), Fq(values[2 * i + 1])) for i in range(6)]
    return Fq12(Fq6(*f2[:3]), Fq6(*f2[3:]))


def _fq12_ints(value: Fq12) -> "list[int]":
    return [c for c6 in (value.c0, value.c1) for c2 in (c6.c0, c6.c1, c6.c2)
            for c in (c2.c0.n, c2.c1.n)]


def _final_exp_is_one(f_ints: "list[int]") -> bool:
    """The native final-exponentiation verdict on 12 canonical ints."""
    return native_bls.fp12_final_exp_is_one(b"".join(v.to_bytes(48, "big") for v in f_ints))


def _extra_pair(s_raw: bytes, device) -> tuple:
    """The extra pair (-G, S) as one Miller lane: xp, yp (1, 12), xq, yq
    (1, 2, 12)."""
    return (*g1_affine_from_raw([_neg_g1_generator_raw()], device),
            *g2_affine_from_raw([s_raw], device))


def finalize_verdict(f_total: torch.Tensor, s_raw: bytes, s_inf: bool, device="cuda") -> bool:
    """Close an RLC batch from its device partials (the mesh twin's):
    multiply the Miller product ``f_total`` (2, 3, 2, 12) by the extra
    pair's Miller value e(-G, sum_i [r_i] sig_i), which runs through the
    Miller kernel at n = 1, and ask the native library for the
    final-exponentiation verdict."""
    f_ints = fq.to_ints(f_total)
    if not s_inf:
        f_extra = miller_loop_batched(*_extra_pair(s_raw, device))
        # one Fq12 product on the host, as the reference takes it
        f_ints = _fq12_ints(_fq12(f_ints) * _fq12(fq.to_ints(f_extra[0])))
    return _final_exp_is_one(f_ints)


def g1_sum_sets(raw_sets: "list[list[bytes]]", mesh=None) -> "list[tuple[bytes, bool]]":
    """S independent G1 point sums: raw96 affine inputs (all-zero is
    infinity), ``(raw96, is_inf)`` outputs. Sets pad to the widest set's
    power of two with infinity lanes, as the reference's do. With ``mesh``
    (``parallel.Mesh``) the set axis splits over its shards, each shard's
    sets summed by B6 (``ops/g1.py g1_sum_sets``) on its device; without one
    the sets run on the routed device (``ops.install(device=...)``)."""
    if not raw_sets:
        return []
    widest = max(max(len(s) for s in raw_sets), 1)
    width = 1 << (widest - 1).bit_length()
    padded = [list(s) + [b"\x00" * 96] * (width - len(s)) for s in raw_sets]
    devices = mesh.devices if mesh is not None else (torch.device(_device_flags.DEVICE),)
    per = -(-len(padded) // len(devices))
    out: "list[tuple[bytes, bool]]" = []
    for i, device in enumerate(devices):
        shard = padded[i * per:(i + 1) * per]
        if shard:
            points, offsets = g1.sets_to_csr(shard)
            out.extend(g1.jacobian_to_affine(g1.g1_sum_sets(points.to(device),
                                                            offsets.to(device))))
    return out


def batch_verify_device(pk_raws: "list[bytes]", h_raws: "list[bytes]",
                        sig_raws: "list[bytes]", scalars: "list[int]",
                        device="cuda") -> bool:
    """The RLC batch verdict prod_i e([r_i] pk_i, H_i) e(-G, sum_i [r_i] sig_i) == 1.

    pk_raws: per-set aggregate pubkeys (raw96 affine, not the identity:
    the caller rejects identity aggregates); h_raws: per-set message
    points (raw192 affine, hash_to_g2 output); sig_raws: per-set
    signatures (raw192 affine); scalars: per-set 128-bit blinders, not
    zero. The O(N) group work runs in the four kernels on ``device`` (the
    plain versions for ``"cpu"``); the extra pair (-G, S) is the Miller
    launch's lane n (no lane when S is infinity), so the product over the
    n + 1 values closes the batch."""
    n = len(pk_raws)
    if not n or not len(h_raws) == len(sig_raws) == len(scalars) == n:
        raise ValueError("need one pubkey, message point, signature and scalar per set")
    xp, yp = g1_mul_batched(g1_affine_from_raw(pk_raws, device), scalars)
    sig = torch.stack(g2_affine_from_raw(sig_raws, device), dim=1).contiguous()
    s_raw, s_inf = _g2_point_to_raw(g2_mul_sum(sig, scalar_words(scalars, device)))
    lanes = [xp, yp, *g2_affine_from_raw(h_raws, device)]
    if not s_inf:
        lanes = [torch.cat([v, e]) for v, e in zip(lanes, _extra_pair(s_raw, device))]
    fs = miller_loop_batched(*lanes)
    return _final_exp_is_one(fq.to_ints(fp12_product(fs)))
