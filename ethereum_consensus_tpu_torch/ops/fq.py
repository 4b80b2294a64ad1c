"""The BLS12-381 base field Fp in plain PyTorch: the arithmetic under the
plain versions of the G1 set-sum kernel (ops/g1.py) and of the pairing
kernels (ops/fq2.py, ops/fq12.py, ops/pairing.py).

An element is a ``(..., 24)`` int64 tensor of 16-bit limbs, least
significant first, in Montgomery form with R = 2^384: the value the
kernels hold in 12 x 32-bit limbs (csrc/fp381_core.h), split so that limb
products fit in int64. Every operation returns a fully reduced value in
[0, p). Carries and borrows resolve with whole-tensor steps (a few
parallel rounds, then a carry-lookahead), not one limb at a time: on the
card each tensor op is a launch.

At the kernel boundary values are canonical (not Montgomery) ``(..., 12)``
int32 tensors carrying the uint32 limb bit patterns; ``limbs16`` and
``limbs32`` convert between the two layouts, ``to_mont`` and ``from_mont``
between the two forms.

The reference's pairing stack runs on a lazy field (ethereum_consensus_tpu
ops/fql.py: 24 x 16-bit columns that may overflow between
multiplications, R' = 2^416) because XLA could not compile the strict
field's compare-and-subtract chains into a Miller loop. Neither the card's
compiler nor PyTorch has that trouble, so the port keeps this one strict
field on both sides. Only the canonical integers leave either package, and
they are equal; ``convert.lv_to_ints`` reads the reference's lazy columns.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.fields import P

__all__ = [
    "LIMBS",
    "P_INT",
    "R",
    "add",
    "const",
    "dbl",
    "from_ints",
    "from_mont",
    "inv",
    "is_zero",
    "limbs16",
    "limbs32",
    "mul",
    "neg",
    "sub",
    "to_ints",
    "to_mont",
]

P_INT = P  # the BLS12-381 base field modulus
LIMBS = 24
R = 1 << 384
_MASK16 = 0xFFFF
_N_PRIME = (-pow(P_INT, -1, R)) % R  # -p^-1 mod R
_CONSTS: dict = {}
_IDX: dict = {}


def const(value: int, device) -> torch.Tensor:
    """``value`` as 24 16-bit limbs on ``device`` (cached)."""
    key = (value, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor([(value >> (16 * i)) & _MASK16 for i in range(LIMBS)],
                         dtype=torch.int64, device=device)
        _CONSTS[key] = t
    return t


def _nearest_below(stop: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """For each limb i, ``value`` at the nearest limb j <= i where ``stop``
    holds, or 0 where there is none: the carry or borrow that leaves limb i
    through a run of propagating limbs (shift it by one limb for the one
    that reaches limb i)."""
    key = (stop.shape[-1], stop.device)
    idx = _IDX.get(key)
    if idx is None:
        idx = _IDX[key] = torch.arange(1, stop.shape[-1] + 1, device=stop.device)
    last = torch.cummax(torch.where(stop, idx, 0), dim=-1).values
    return torch.gather(torch.constant_pad_nd(value, (1, 0)), -1, last)


def _rounds(t: torch.Tensor, rounds: int) -> torch.Tensor:
    """``rounds`` parallel carry rounds on non-negative limbs: the same
    integer, each limb then below 2^16 plus the carry from below (the
    carry out of the top limb is dropped)."""
    for _ in range(rounds):
        c = t >> 16
        t = t & _MASK16
        t[..., 1:] += c[..., :-1]
    return t


def _carry(t: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """Limbs of at most 2^16 (``t`` is overwritten) -> (16-bit limbs,
    carry out of the top limb). A limb of 2^16 carries out whatever comes
    in, one of 2^16 - 1 only when a carry comes in: the carries resolve by
    lookahead."""
    out = _nearest_below(t != _MASK16, t >> 16)
    t[..., 1:] += out[..., :-1]
    return t & _MASK16, out[..., -1]


def _sub_limbs(a: torch.Tensor, b: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """a - b mod 2^384 on 16-bit limbs; returns (limbs, borrow 0/1)."""
    d = a - b
    # a negative limb borrows whatever comes in, a zero one passes it on
    out = _nearest_below(d != 0, (d < 0).to(torch.int64))
    d[..., 1:] -= out[..., :-1]
    return d & _MASK16, out[..., -1]


def _reduce_once(t: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """t + top * 2^384 (< 2p) minus p when it is at least p."""
    d, borrow = _sub_limbs(t, const(P_INT, t.device))
    keep = (top == 0) & (borrow == 1)
    return torch.where(keep[..., None], t, d)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce_once(*_carry(_rounds(a + b, 1)))


def dbl(a: torch.Tensor) -> torch.Tensor:
    return add(a, a)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d, borrow = _sub_limbs(a, b)
    return _carry(_rounds(d + borrow[..., None] * const(P_INT, a.device), 1))[0]


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of limb vectors (..., n) x (..., m) -> (..., n+m)
    column sums, unnormalized. The outer product's row i is shifted right
    by i (pad, flatten, re-fold) so that each column k sums the terms
    a_i b_(k-i)."""
    a, b = torch.broadcast_tensors(a[..., :, None], b[..., None, :])
    n, m = a.shape[-2], a.shape[-1]
    rows = torch.constant_pad_nd(a * b, (0, n)).flatten(-2)[..., : n * (m + n - 1)]
    cols = rows.unflatten(-1, (n, m + n - 1)).sum(dim=-2)
    return torch.constant_pad_nd(cols, (0, 1))


def _const_product(a: torch.Tensor, value: int, columns: int) -> torch.Tensor:
    """The first ``columns`` column sums of ``a`` (..., 24) times the
    constant ``value``: one float64 matrix product with the constant's
    shifted rows, exact because every product and partial sum is an
    integer below 2^53 (the callers keep them below 2^43)."""
    key = ("shifted", value, columns, str(a.device))
    rows = _CONSTS.get(key)
    if rows is None:
        k = torch.arange(columns)[None, :] - torch.arange(LIMBS)[:, None]
        padded = torch.constant_pad_nd(const(value, "cpu"), (0, 1))
        rows = padded[torch.where((k >= 0) & (k < LIMBS), k, LIMBS)]
        rows = _CONSTS[key] = rows.to(device=a.device, dtype=torch.float64)
    return (a.to(torch.float64) @ rows).to(torch.int64)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-384 mod p (Montgomery REDC with the whole R):
    m = (T mod R) * (-p^-1) mod R, then (T + m p) / R < 2p.

    Only the last sum is carried out exactly. T's columns (below 2^37)
    take one carry round, which leaves the integer and so T mod R as they
    were, with limbs below 2^22; m's take three, which drop the multiples
    of R and leave limbs of at most 2^16, so m < R (1 + 2^-15) and
    (T + m p) / R < p^2 / R + p (1 + 2^-15) < 2p. Every column sum stays
    below 2^43."""
    t = _rounds(_product(a, b), 1)
    m = _rounds(_const_product(t[..., :LIMBS], _N_PRIME, LIMBS), 3)
    u, _ = _carry(_rounds(t + _const_product(m, P_INT, 2 * LIMBS), 3))
    return _reduce_once(u[..., LIMBS:], torch.zeros_like(u[..., 0]))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


# p - 2, MSB first: the exponent of the Fermat inversion
_P_MINUS_2_BITS = [int(b) for b in bin(P_INT - 2)[2:]]


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p - 2) (Montgomery in, Montgomery out): the inverse, 0 for 0.
    Square and multiply from the top bit, as the kernels do."""
    acc = a
    for bit in _P_MINUS_2_BITS[1:]:
        acc = mul(acc, acc)
        if bit:
            acc = mul(acc, a)
    return acc


def to_mont(a: torch.Tensor) -> torch.Tensor:
    return mul(a, const(R * R % P_INT, a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    return mul(a, const(1, a.device))


def limbs16(limbs32: torch.Tensor) -> torch.Tensor:
    """(..., 12) int32 bit patterns -> (..., 24) int64 16-bit limbs."""
    v = limbs32.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([v & _MASK16, v >> 16], dim=-1).flatten(-2)


def limbs32(limbs16: torch.Tensor) -> torch.Tensor:
    """(..., 24) 16-bit limbs -> (..., 12) int32 bit patterns."""
    pairs = limbs16.unflatten(-1, (-1, 2))
    v = pairs[..., 0] | (pairs[..., 1] << 16)
    return (v - ((v & 0x80000000) << 1)).to(torch.int32)


def from_ints(values, device="cpu") -> torch.Tensor:
    """Integers in [0, p) -> ``(len(values), 12)`` int32 canonical limbs."""
    data = b"".join(int(v).to_bytes(48, "little") for v in values)
    words = np.frombuffer(data, dtype="<u4").reshape(len(values), 12)
    return torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(device)


def to_ints(limbs: torch.Tensor) -> "list[int]":
    """``(..., 12)`` int32 canonical limbs -> their integers, row-major."""
    rows = limbs.detach().cpu().reshape(-1, 12).numpy().view(np.uint32)
    data = rows.astype("<u4").tobytes()
    return [int.from_bytes(data[48 * i : 48 * (i + 1)], "little") for i in range(len(rows))]
