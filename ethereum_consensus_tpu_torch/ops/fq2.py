"""Fq2 = Fq[u]/(u^2 + 1) in plain PyTorch, batched over leading axes: the
tower under the plain versions of the pairing kernels (ops/pairing.py).

An element is a ``(..., 2, 24)`` int64 tensor: c0 then c1, each in the
Montgomery 16-bit limbs of ops/fq.py. Independent products are stacked
into one call of ``fq8.mul`` (the selected multiplier's product: ``fq.mul``
under "u64", ``fq8.mont7r_plain`` under "mxu"; ``mul`` on a stacked
``(..., k, 2, 24)`` tensor computes k products at once), so a whole Fq6
product is one field multiplication call: on the card each tensor op is a
launch. Sums,
differences and negation are limbwise: ``fq.add``, ``fq.sub`` and
``fq.neg`` serve Fq2 tensors as they are.

The reference is ethereum_consensus_tpu/ops/fq2.py (the same names and
component order, on its lazy field); canonical values agree exactly.
"""

from __future__ import annotations

import torch

from . import fq, fq8

__all__ = [
    "conj",
    "from_ints",
    "inv",
    "is_zero",
    "mul",
    "mul_by_xi",
    "mul_many",
    "one",
    "square",
    "to_ints",
]


def one(batch_shape=(), device="cpu") -> torch.Tensor:
    base = torch.stack([fq.const(fq.R % fq.P_INT, device), fq.const(0, device)])
    return base.expand(*batch_shape, 2, fq.LIMBS).clone()


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook: c0 = a0 b0 - a1 b1, c1 = a0 b1 + a1 b0, the four
    products in one field multiplication call."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a.unbind(-2)
    b0, b1 = b.unbind(-2)
    t = fq8.mul(torch.stack([a0, a1, a0, a1], dim=-2), torch.stack([b0, b1, b1, b0], dim=-2))
    return torch.stack([fq.sub(t[..., 0, :], t[..., 1, :]),
                        fq.add(t[..., 2, :], t[..., 3, :])], dim=-2)


def mul_many(pairs: "list[tuple[torch.Tensor, torch.Tensor]]") -> "list[torch.Tensor]":
    """All the listed products in one ``mul`` call."""
    a, b = zip(*(torch.broadcast_tensors(x, y) for x, y in pairs))
    return list(mul(torch.stack(a, dim=-3), torch.stack(b, dim=-3)).unbind(-3))


def square(a: torch.Tensor) -> torch.Tensor:
    """c0 = a0^2 - a1^2, c1 = 2 a0 a1: three products in one call."""
    a0, a1 = a.unbind(-2)
    t = fq8.mul(torch.stack([a0, a1, a0], dim=-2), torch.stack([a0, a1, a1], dim=-2))
    return torch.stack([fq.sub(t[..., 0, :], t[..., 1, :]),
                        fq.dbl(t[..., 2, :])], dim=-2)


def mul_by_xi(a: torch.Tensor) -> torch.Tensor:
    """a * (u + 1) = (a0 - a1) + (a0 + a1) u."""
    a0, a1 = a.unbind(-2)
    return torch.stack([fq.sub(a0, a1), fq.add(a0, a1)], dim=-2)


def conj(a: torch.Tensor) -> torch.Tensor:
    a0, a1 = a.unbind(-2)
    return torch.stack([a0, fq.neg(a1)], dim=-2)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return fq.is_zero(a[..., 0, :]) & fq.is_zero(a[..., 1, :])


def inv(a: torch.Tensor) -> torch.Tensor:
    """1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2); 0 for 0."""
    a0, a1 = a.unbind(-2)
    t = fq8.mul(a, a)
    norm_inv = fq8.inv(fq.add(t[..., 0, :], t[..., 1, :]))
    return fq8.mul(torch.stack([a0, fq.neg(a1)], dim=-2), norm_inv[..., None, :])


def from_ints(c0: int, c1: int, device="cpu") -> torch.Tensor:
    """Canonical (c0, c1) -> a (2, 24) Montgomery element."""
    return fq.to_mont(fq.limbs16(fq.from_ints([c0, c1], device)))


def to_ints(a: torch.Tensor) -> "tuple[int, int]":
    """A (2, 24) Montgomery element -> canonical (c0, c1)."""
    c0, c1 = fq.to_ints(fq.limbs32(fq.from_mont(a)))
    return c0, c1
