"""BLS12-381 G1 set sums (pubkey aggregation): the CUDA kernel and its
plain version.

The data-parallel piece of ``fast_aggregate_verify`` and of batched
signature-set verification (crypto/bls.rs:114) is the sum of each set's
G1 public keys. The kernel (``csrc/g1_sum.cu``) sums S ragged sets in two
grid launches: the 128 lanes of every set, a crew of 4 threads a lane and
4 blocks a set, then a fold block a set.

Layout at the tensor boundary:
  - points ``(K, 2, 12)`` int32: canonical affine x and y of every key of
    every set, concatenated set after set, 12 limbs of 32 bits each, least
    significant first (int32 tensors carry the uint32 bit patterns); all
    zero is the point at infinity;
  - offsets ``(S + 1,)`` int64: set s is points[offsets[s]:offsets[s+1]];
  - result ``(S, 3, 12)`` int32: each sum as canonical Jacobian (X, Y, Z)
    limbs, Z = 0 for infinity. ``jacobian_to_affine`` gives the affine
    raw96 bytes on the host, one inversion per set.

Two paths with identical Jacobian output:
  - ``g1_sum_sets_cuda``: the kernel;
  - ``g1_sum_sets_plain``: int64 tensor limbs (16 bits each, so that limb
    products fit), the same formulas and the same order of additions as
    the kernel's 128 lanes and its fold.
``g1_sum_sets`` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises. Under the "mxu" multiplier
(``fq8.set_multiplier``, ``EC_PAIRING_MULT``) the plain version's products
are ``fq8.mont7r``'s and the kernel is the mxu build of ``csrc/g1_sum.cu``
(one warp a lane on the int8 tensor-core product), with the same sums;
``aggregate_pubkeys_device``, the single-set sum, stays on u64 under both,
as the reference's strict-field twin does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..telemetry import device as _obs
from . import fq, fq8
from .fq import P_INT

__all__ = [
    "P_INT",
    "aggregate_pubkey_sets_device",
    "aggregate_pubkeys_device",
    "g1_sum_sets",
    "g1_sum_sets_cuda",
    "g1_sum_sets_plain",
    "jacobian_to_affine",
    "launch_count",
    "point_add",
    "point_double",
    "points_from_raw",
    "sets_to_csr",
]

# lanes a set of the kernel: the plain version folds the same lanes
THREADS = 128
# int32 words of the u64 build's scratch a set: its 128 lanes' sums, 3 x 12
# limbs each
SCRATCH_WORDS_PER_SET = THREADS * 36

# Kernel launches since the counts were last set to 0 (``g1_sum_sets_cuda``
# adds one per launch and nowhere else): the u64 build's, and the mxu
# build's.
launch_count = 0
launch_count_mxu = 0


# ---------------------------------------------------------------------------
# Host marshalling: raw96 bytes <-> limb tensors
# ---------------------------------------------------------------------------


def points_from_raw(raws: "list[bytes]") -> torch.Tensor:
    """Affine raw96 points (x||y, 48-byte big-endian each) -> (K, 2, 12)
    int32 limbs. One numpy reinterpret: a 48-byte big-endian coordinate
    is its 12 32-bit limbs, most significant first."""
    k = len(raws)
    words = np.frombuffer(b"".join(raws), dtype=">u4").reshape(k, 2, 12)
    limbs = np.ascontiguousarray(words[:, :, ::-1], dtype=np.uint32)
    return torch.from_numpy(limbs.view(np.int32))


def sets_to_csr(raw_sets: "list[list[bytes]]") -> "tuple[torch.Tensor, torch.Tensor]":
    """Ragged raw96 sets -> (points (K, 2, 12) int32, offsets (S+1,) int64)
    on the CPU."""
    offsets = np.zeros(len(raw_sets) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(s) for s in raw_sets])
    return points_from_raw([raw for s in raw_sets for raw in s]), torch.from_numpy(offsets)


def _limb_ints(row: np.ndarray) -> int:
    return int.from_bytes(row.astype("<u4").tobytes(), "little")


def jacobian_to_affine(sums: torch.Tensor) -> "list[tuple[bytes, bool]]":
    """(S, 3, 12) canonical Jacobian limbs -> S (affine raw96, is_infinity).
    The inversion runs on the host with Python integers: O(S) and
    branchy, the wrong shape for the card."""
    rows = _obs.d2h("ops.g1.point_to_raw", sums).view(np.uint32)
    out = []
    for row in rows:
        z = _limb_ints(row[2])
        if z == 0:
            out.append((b"\x00" * 96, True))
            continue
        z_inv = pow(z, -1, P_INT)
        z2 = z_inv * z_inv % P_INT
        ax = _limb_ints(row[0]) * z2 % P_INT
        ay = _limb_ints(row[1]) * z2 * z_inv % P_INT
        out.append((ax.to_bytes(48, "big") + ay.to_bytes(48, "big"), False))
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch version: the points over the field of ops/fq.py (24 x 16-bit
# limbs in int64, Montgomery form with the kernel's R = 2^384).
# ---------------------------------------------------------------------------

def _products(*pairs):
    """The field products of the (a, b) pairs, stacked into one call of the
    selected multiplier's product (``fq8.mul``)."""
    a, b = zip(*(torch.broadcast_tensors(x, y) for x, y in pairs))
    return fq8.mul(torch.stack(a), torch.stack(b)).unbind(0)


def point_double(p: torch.Tensor) -> torch.Tensor:
    """dbl-2009-l on (..., 3, 24) Montgomery Jacobian points (fp381_core.h
    g1_double; the G1 set sums and the pairing's blinder multiplication)."""
    x, y, z = p.unbind(-2)
    a, b, yz = _products((x, x), (y, y), (y, z))
    xb = fq.add(x, b)
    c, xb2 = _products((b, b), (xb, xb))
    d = fq.sub(fq.sub(xb2, a), c)
    d = fq.add(d, d)
    e = fq.add(fq.add(a, a), a)
    (f,) = _products((e, e))
    x3 = fq.sub(f, fq.add(d, d))
    c8 = fq.add(c, c)
    c8 = fq.add(c8, c8)
    c8 = fq.add(c8, c8)
    (ed,) = _products((e, fq.sub(d, x3)))
    return torch.stack([x3, fq.sub(ed, c8), fq.add(yz, yz)], dim=-2)


def point_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """add-2007-bl with the kernel's branches as selects: q at infinity
    gives p, p at infinity gives q, P == Q doubles, P == -Q is infinity.
    The doubling is computed only where some lane needs it."""
    p, q = torch.broadcast_tensors(p, q)
    x1, y1, z1 = p.unbind(-2)
    x2, y2, z2 = q.unbind(-2)
    z1z1, z2z2, y1z2, y2z1, z1z2 = _products((z1, z1), (z2, z2), (y1, z2), (y2, z1), (z1, z2))
    u1, u2, s1, s2 = _products((x1, z2z2), (x2, z1z1), (y1z2, z2z2), (y2z1, z1z1))
    h = fq.sub(u2, u1)
    r = fq.sub(s2, s1)
    hh, rr = _products((h, h), (r, r))
    hhh, v, z3 = _products((h, hh), (u1, hh), (z1z2, h))
    x3 = fq.sub(fq.sub(rr, hhh), fq.add(v, v))
    rv, s1h = _products((r, fq.sub(v, x3)), (s1, hhh))
    out = torch.stack([x3, fq.sub(rv, s1h), z3], dim=-2)
    h_zero = fq.is_zero(h)[..., None, None]
    r_zero = fq.is_zero(r)[..., None, None]
    same = h_zero & r_zero
    if bool(same.any()):
        out = torch.where(same, point_double(p), out)
    out = torch.where(h_zero & ~r_zero, torch.zeros_like(out), out)
    out = torch.where(fq.is_zero(z1)[..., None, None], q, out)
    return torch.where(fq.is_zero(z2)[..., None, None], p, out)


def _check(points: torch.Tensor, offsets: torch.Tensor) -> int:
    if points.dtype != torch.int32 or offsets.dtype != torch.int64:
        raise TypeError(
            f"points must be int32 and offsets int64, got {points.dtype}, {offsets.dtype}"
        )
    if points.dim() != 3 or tuple(points.shape[1:]) != (2, 12):
        raise ValueError(f"points must be (K, 2, 12), got {tuple(points.shape)}")
    if offsets.dim() != 1 or offsets.shape[0] < 2:
        raise ValueError(f"offsets must be (S + 1,) with S >= 1, got {tuple(offsets.shape)}")
    if points.device != offsets.device:
        raise ValueError("points and offsets must be on one device")
    # the kernel reads points[offsets[s]:offsets[s + 1]] unchecked
    if bool((offsets[0] < 0) | (offsets[-1] > points.shape[0])
            | (offsets[1:] < offsets[:-1]).any()):
        raise ValueError(f"offsets must rise from 0 to at most K = {points.shape[0]}")
    return offsets.shape[0] - 1


def g1_sum_sets_plain(points: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """S set sums in plain PyTorch: (K, 2, 12), (S+1,) -> (S, 3, 12) int32
    canonical Jacobian limbs, equal limb for limb to the kernel's."""
    n_sets = _check(points, offsets)
    device = points.device
    begin, end = offsets[:-1], offsets[1:]
    lane = torch.arange(THREADS, dtype=torch.int64, device=device)
    # one infinity row at the end stands in for every out-of-set lane
    pts = torch.cat([fq.limbs16(points), torch.zeros((1, 2, fq.LIMBS), dtype=torch.int64,
                                                      device=device)])
    pad = pts.shape[0] - 1
    acc = torch.zeros((n_sets, THREADS, 3, fq.LIMBS), dtype=torch.int64, device=device)
    steps = int(((end - begin).max().item() + THREADS - 1) // THREADS)
    one = fq.const(fq.R % P_INT, device)
    for j in range(steps):
        k = begin[:, None] + lane[None, :] + j * THREADS
        valid = k < end[:, None]
        xy = pts[torch.where(valid, k, pad)]
        live = ~(fq.is_zero(xy[..., 0, :]) & fq.is_zero(xy[..., 1, :]))
        jac = torch.stack([fq8.to_mont(xy[..., 0, :]), fq8.to_mont(xy[..., 1, :]),
                           one.expand_as(xy[..., 0, :])], dim=-2)
        jac = torch.where(live[..., None, None], jac, torch.zeros_like(jac))
        acc = torch.where(valid[..., None, None], point_add(acc, jac), acc)
    stride = THREADS // 2
    while stride:
        acc = torch.cat([point_add(acc[:, :stride], acc[:, stride : 2 * stride]),
                         acc[:, stride:]], dim=1)
        stride //= 2
    return fq.limbs32(fq8.from_mont(acc[:, 0]))


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def g1_sum_sets_cuda(points: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """S set sums on the card (csrc/g1_sum.cu): (K, 2, 12) int32 points and
    (S+1,) int64 offsets, contiguous CUDA tensors -> (S, 3, 12) int32."""
    n_sets = _check(points, offsets)
    if points.device.type != "cuda":
        raise ValueError(f"g1_sum_sets_cuda needs CUDA tensors, got {points.device}")
    if not (points.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("points and offsets must be contiguous")
    return _launch(points, offsets, n_sets)


def _library() -> str:
    """The build of csrc/g1_sum.cu that the selected multiplier runs."""
    return "g1_sum_mxu" if fq8.get_multiplier() == "mxu" else "g1_sum"


def _launch(points: torch.Tensor, offsets: torch.Tensor, n_sets: int) -> torch.Tensor:
    """The launch alone, on inputs ``g1_sum_sets_cuda`` has checked (the
    offsets check waits for the card, so kernel timings call this
    directly): the u64 build's two grid launches (the lanes' chains, then
    the fold), with their scratch, or the mxu build's one under "mxu"."""
    global launch_count, launch_count_mxu
    name = _library()
    mxu = name == "g1_sum_mxu"
    lib = _kernels.load(name)
    out = torch.empty((n_sets, 3, 12), dtype=torch.int32, device=points.device)
    scratch = None if mxu else torch.empty((n_sets * SCRATCH_WORDS_PER_SET,), dtype=torch.int32,
                                           device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = lib.g1_sum_sets_launch(points.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                                    None if mxu else scratch.data_ptr(), n_sets, stream)
    if rc != 0:
        raise RuntimeError(f"g1_sum_sets kernel launch failed: CUDA error {rc}")
    if mxu:
        with _kernels.LAUNCH_LOCK:
            launch_count_mxu += 1
        _obs.launch("g1_sum_sets_mxu")
    else:
        with _kernels.LAUNCH_LOCK:
            launch_count += 2
        _obs.launch("g1_sum_sets", 2)
    return out


def g1_sum_sets(points: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if points.device.type == "cpu":
        return g1_sum_sets_plain(points, offsets)
    return g1_sum_sets_cuda(points, offsets)


# ---------------------------------------------------------------------------
# Entry points on raw96 keys
# ---------------------------------------------------------------------------


def aggregate_pubkey_sets_device(
    raw_sets: "list[list[bytes]]", device="cuda"
) -> "list[tuple[bytes, bool]]":
    """S independent pubkey aggregations, one launch: the batch boundary of
    verify_signature_sets (one aggregation per signature set). Ragged sets
    go to the kernel as CSR (no padding); on a CPU device the plain version
    runs."""
    if not raw_sets:
        return []
    points, offsets = _obs.h2d("ops.g1.points_from_raw", *sets_to_csr(raw_sets), device=device)
    return jacobian_to_affine(g1_sum_sets(points, offsets))


def aggregate_pubkeys_device(raws: "list[bytes]", device="cuda") -> "tuple[bytes, bool]":
    """Sum N affine raw96 G1 points on the card; returns (raw96, is_inf).
    The device twin of the aggregation loop inside fast_aggregate_verify
    (crypto/bls.rs:114)."""
    if not raws:
        return b"\x00" * 96, True
    with fq8.pinned("u64"):
        return aggregate_pubkey_sets_device([raws], device=device)[0]


# The dispatcher through the device observatory's call ledger, under the
# name of the reference's XLA program it stands for.
g1_sum_sets = _obs.observe_jit(g1_sum_sets, "ops.g1._tree_reduce_segmented", ("uint32",))
