"""BLS12-381 G1 set sums (pubkey aggregation): the CUDA kernel and its
plain version.

The data-parallel piece of ``fast_aggregate_verify`` and of batched
signature-set verification (crypto/bls.rs:114) is the sum of each set's
G1 public keys. The kernel (``csrc/g1_sum.cu``) sums S ragged sets in one
launch, one block per set.

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
    the kernel's 128 threads and its shared-memory fold.
``g1_sum_sets`` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels

__all__ = [
    "P_INT",
    "aggregate_pubkey_sets_device",
    "aggregate_pubkeys_device",
    "g1_sum_sets",
    "g1_sum_sets_cuda",
    "g1_sum_sets_plain",
    "jacobian_to_affine",
    "launch_count",
    "points_from_raw",
    "sets_to_csr",
]

# the BLS12-381 base field modulus
P_INT = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaaab",
    16,
)

# threads per block of the kernel: the plain version folds the same lanes
THREADS = 128

# Kernel launches since the count was last set to 0 (``g1_sum_sets_cuda``
# adds one per launch and nowhere else).
launch_count = 0


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
    rows = sums.cpu().numpy().view(np.uint32)
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
# Plain PyTorch version: Fp in 24 x 16-bit limbs held in int64, Montgomery
# form with R = 2^384 (the kernel's R), fully reduced after every operation.
# Carries and borrows resolve with whole-tensor steps (a few parallel
# rounds, then a carry-lookahead), not one limb at a time: on the card each
# tensor op is a launch.
# ---------------------------------------------------------------------------

_L = 24
_MASK16 = 0xFFFF
_R = 1 << 384
_N_PRIME = (-pow(P_INT, -1, _R)) % _R  # -p^-1 mod R
_CONSTS: dict = {}


def _const(value: int, device) -> torch.Tensor:
    key = (value, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor([(value >> (16 * i)) & _MASK16 for i in range(_L)],
                         dtype=torch.int64, device=device)
        _CONSTS[key] = t
    return t


def _nearest_below(stop: torch.Tensor, value: torch.Tensor, inclusive: bool) -> torch.Tensor:
    """For each limb i, ``value`` at the nearest limb j < i (j <= i when
    ``inclusive``) where ``stop`` holds, or 0 where there is none: the
    carry or borrow that reaches limb i through a run of propagating
    limbs."""
    n = stop.shape[-1]
    idx = torch.arange(n, device=stop.device).expand_as(stop)
    last = torch.cummax(torch.where(stop, idx, -1), dim=-1).values
    if not inclusive:
        last = torch.nn.functional.pad(last[..., :-1], (1, 0), value=-1)
    found = torch.gather(value, -1, last.clamp(min=0))
    return torch.where(last >= 0, found, 0)


def _carry(t: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """Non-negative limbs below 2^48 -> (16-bit limbs, carry out of the
    top limb). Four parallel rounds leave every limb at most 2^16; the last
    carries (0 or 1) then resolve by lookahead."""
    top = torch.zeros(t.shape[:-1], dtype=torch.int64, device=t.device)
    for _ in range(4):
        c = t >> 16
        top = top + c[..., -1]
        t = (t & _MASK16) + torch.nn.functional.pad(c[..., :-1], (1, 0))
    generate = t >> 16  # limb == 2^16: a carry out whatever comes in
    propagate = t == _MASK16  # a carry out only if one comes in
    t = (t + _nearest_below(~propagate, generate, inclusive=False)) & _MASK16
    return t, top + _nearest_below(~propagate, generate, inclusive=True)[..., -1]


def _sub_limbs(a: torch.Tensor, b: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """a - b mod 2^384 on 16-bit limbs; returns (limbs, borrow 0/1)."""
    d = a - b
    generate = (d < 0).to(torch.int64)  # a borrow out whatever comes in
    stop = d != 0  # a zero limb passes the incoming borrow on
    borrow_in = _nearest_below(stop, generate, inclusive=False)
    out = (d - borrow_in) & _MASK16
    return out, _nearest_below(stop, generate, inclusive=True)[..., -1]


def _reduce_once(t: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """t + top * 2^384 (< 2p) minus p when it is at least p."""
    d, borrow = _sub_limbs(t, _const(P_INT, t.device))
    keep = (top == 0) & (borrow == 1)
    return torch.where(keep[..., None], t, d)


def _fadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce_once(*_carry(a + b))


def _fsub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d, borrow = _sub_limbs(a, b)
    return _carry(d + borrow[..., None] * _const(P_INT, a.device))[0]


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of limb vectors (..., n) x (..., m) -> (..., n+m)
    column sums, unnormalized (each below 2^37 for 16-bit limbs). The outer
    product's row i is shifted right by i (pad, flatten, re-fold) so that
    each column k sums the terms a_i b_(k-i)."""
    a, b = torch.broadcast_tensors(a[..., :, None], b[..., None, :])
    n, m = a.shape[-2], a.shape[-1]
    rows = torch.nn.functional.pad(a * b, (0, n)).flatten(-2)[..., : n * (m + n - 1)]
    cols = rows.unflatten(-1, (n, m + n - 1)).sum(dim=-2)
    return torch.nn.functional.pad(cols, (0, 1))


def _fmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-384 mod p (Montgomery REDC with the whole R):
    m = (T mod R) * (-p^-1) mod R, then (T + m p) / R < 2p."""
    t, _ = _carry(_product(a, b))
    m, _ = _carry(_product(t[..., :_L], _const(_N_PRIME, a.device))[..., :_L])
    u, _ = _carry(t + _product(m, _const(P_INT, a.device)))
    return _reduce_once(u[..., _L:], torch.zeros_like(u[..., 0]))


def _is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def _g1_double(p: torch.Tensor) -> torch.Tensor:
    """dbl-2009-l on (..., 3, 24) Montgomery Jacobian points."""
    x, y, z = p.unbind(-2)
    a = _fmul(x, x)
    b = _fmul(y, y)
    c = _fmul(b, b)
    xb = _fadd(x, b)
    d = _fsub(_fsub(_fmul(xb, xb), a), c)
    d = _fadd(d, d)
    e = _fadd(_fadd(a, a), a)
    f = _fmul(e, e)
    x3 = _fsub(f, _fadd(d, d))
    c8 = _fadd(c, c)
    c8 = _fadd(c8, c8)
    c8 = _fadd(c8, c8)
    y3 = _fsub(_fmul(e, _fsub(d, x3)), c8)
    yz = _fmul(y, z)
    return torch.stack([x3, y3, _fadd(yz, yz)], dim=-2)


def _g1_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """add-2007-bl with the kernel's branches as selects: q at infinity
    gives p, p at infinity gives q, P == Q doubles, P == -Q is infinity."""
    x1, y1, z1 = p.unbind(-2)
    x2, y2, z2 = q.unbind(-2)
    z1z1 = _fmul(z1, z1)
    z2z2 = _fmul(z2, z2)
    u1 = _fmul(x1, z2z2)
    u2 = _fmul(x2, z1z1)
    s1 = _fmul(_fmul(y1, z2), z2z2)
    s2 = _fmul(_fmul(y2, z1), z1z1)
    h = _fsub(u2, u1)
    r = _fsub(s2, s1)
    hh = _fmul(h, h)
    hhh = _fmul(h, hh)
    v = _fmul(u1, hh)
    x3 = _fsub(_fsub(_fmul(r, r), hhh), _fadd(v, v))
    y3 = _fsub(_fmul(r, _fsub(v, x3)), _fmul(s1, hhh))
    z3 = _fmul(_fmul(z1, z2), h)
    out = torch.stack([x3, y3, z3], dim=-2)
    h_zero = _is_zero(h)[..., None, None]
    r_zero = _is_zero(r)[..., None, None]
    out = torch.where(h_zero & r_zero, _g1_double(p), out)
    out = torch.where(h_zero & ~r_zero, torch.zeros_like(out), out)
    out = torch.where(_is_zero(z1)[..., None, None], q, out)
    return torch.where(_is_zero(z2)[..., None, None], p, out)


def _to_limbs16(limbs32: torch.Tensor) -> torch.Tensor:
    v = limbs32.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([v & _MASK16, v >> 16], dim=-1).flatten(-2)


def _to_limbs32(limbs16: torch.Tensor) -> torch.Tensor:
    pairs = limbs16.unflatten(-1, (-1, 2))
    v = pairs[..., 0] | (pairs[..., 1] << 16)
    return (v - ((v & 0x80000000) << 1)).to(torch.int32)


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
    pts = torch.cat([_to_limbs16(points), torch.zeros((1, 2, _L), dtype=torch.int64,
                                                      device=device)])
    pad = pts.shape[0] - 1
    acc = torch.zeros((n_sets, THREADS, 3, _L), dtype=torch.int64, device=device)
    steps = int(((end - begin).max().item() + THREADS - 1) // THREADS)
    one = _const(_R % P_INT, device)
    r2 = _const(_R * _R % P_INT, device)
    for j in range(steps):
        k = begin[:, None] + lane[None, :] + j * THREADS
        valid = k < end[:, None]
        xy = pts[torch.where(valid, k, pad)]
        live = ~(_is_zero(xy[..., 0, :]) & _is_zero(xy[..., 1, :]))
        jac = torch.stack([_fmul(xy[..., 0, :], r2), _fmul(xy[..., 1, :], r2),
                           one.expand_as(xy[..., 0, :])], dim=-2)
        jac = torch.where(live[..., None, None], jac, torch.zeros_like(jac))
        acc = torch.where(valid[..., None, None], _g1_add(acc, jac), acc)
    stride = THREADS // 2
    while stride:
        acc = torch.cat([_g1_add(acc[:, :stride], acc[:, stride : 2 * stride]),
                         acc[:, stride:]], dim=1)
        stride //= 2
    unit = torch.zeros(_L, dtype=torch.int64, device=device)
    unit[0] = 1
    return _to_limbs32(_fmul(acc[:, 0], unit))


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


def _launch(points: torch.Tensor, offsets: torch.Tensor, n_sets: int) -> torch.Tensor:
    """The launch alone, on inputs ``g1_sum_sets_cuda`` has checked (the
    offsets check waits for the card, so kernel timings call this
    directly)."""
    global launch_count
    lib = _kernels.load("g1_sum")
    out = torch.empty((n_sets, 3, 12), dtype=torch.int32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = lib.g1_sum_sets_launch(points.data_ptr(), offsets.data_ptr(),
                                    out.data_ptr(), n_sets, stream)
    if rc != 0:
        raise RuntimeError(f"g1_sum_sets kernel launch failed: CUDA error {rc}")
    launch_count += 1
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
    points, offsets = sets_to_csr(raw_sets)
    return jacobian_to_affine(g1_sum_sets(points.to(device), offsets.to(device)))


def aggregate_pubkeys_device(raws: "list[bytes]", device="cuda") -> "tuple[bytes, bool]":
    """Sum N affine raw96 G1 points on the card; returns (raw96, is_inf).
    The device twin of the aggregation loop inside fast_aggregate_verify
    (crypto/bls.rs:114)."""
    if not raws:
        return b"\x00" * 96, True
    return aggregate_pubkey_sets_device([raws], device=device)[0]
