"""Fq6 and Fq12 in plain PyTorch, batched over leading axes: the tower of
the plain Miller loop and Fq12 product (ops/pairing.py).

    Fq6  = Fq2[v]/(v^3 - xi),  xi = u + 1
    Fq12 = Fq6[w]/(w^2 - v)

An Fq6 element is a ``(..., 3, 2, 24)`` int64 tensor (the v-powers, each
an Fq2 of ops/fq2.py); Fq12 is ``(..., 2, 3, 2, 24)`` with the w-half
first: the component order of the reference (ethereum_consensus_tpu
ops/fq12.py, whose names these are) and of crypto/fields.py. Sums and
differences are limbwise (``fq.add``, ``fq.sub`` on the whole tensor);
products gather their independent Fq2 products into one stacked call.
"""

from __future__ import annotations

import torch

from . import fq, fq2

__all__ = [
    "fp6_mul",
    "fp6_mul_by_v",
    "fp12_conj",
    "fp12_from_ints",
    "fp12_mul",
    "fp12_mul_by_line",
    "fp12_one",
    "fp12_sqr",
    "fp12_to_ints",
]


# the nine schoolbook products a_i b_j of one Fq6 product, grouped by the
# coefficient they feed: c0 = a0b0 + xi(a1b2 + a2b1),
# c1 = a0b1 + a1b0 + xi(a2b2), c2 = a0b2 + a1b1 + a2b0
_SEL_A = [0, 1, 2, 0, 1, 2, 0, 1, 2]
_SEL_B = [0, 2, 1, 1, 0, 2, 2, 1, 0]


def fp6_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    p = fq2.mul(a[..., _SEL_A, :, :], b[..., _SEL_B, :, :])
    s = fq.add(p[..., [1, 3, 6], :, :], p[..., [2, 4, 7], :, :])
    x = fq2.mul_by_xi(torch.stack([s[..., 0, :, :], p[..., 5, :, :]], dim=-3))
    return fq.add(torch.stack([p[..., 0, :, :], s[..., 1, :, :], s[..., 2, :, :]], dim=-3),
                   torch.stack([x[..., 0, :, :], x[..., 1, :, :], p[..., 8, :, :]], dim=-3))


def fp6_mul_by_v(a: torch.Tensor) -> torch.Tensor:
    """(a0, a1, a2) -> (xi a2, a0, a1)."""
    a0, a1, a2 = a.unbind(-3)
    return torch.stack([fq2.mul_by_xi(a2), a0, a1], dim=-3)


def fp12_one(batch_shape=(), device="cpu") -> torch.Tensor:
    out = torch.zeros(*batch_shape, 2, 3, 2, fq.LIMBS, dtype=torch.int64, device=device)
    out[..., 0, 0, 0, :] = fq.const(fq.R % fq.P_INT, device)
    return out


def fp12_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba over the w-halves: three Fq6 products in one call."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a.unbind(-4)
    b0, b1 = b.unbind(-4)
    t0, t1, t2 = fp6_mul(torch.stack([a0, a1, fq.add(a0, a1)], dim=-4),
                         torch.stack([b0, b1, fq.add(b0, b1)], dim=-4)).unbind(-4)
    return torch.stack([fq.add(t0, fp6_mul_by_v(t1)), fq.sub(fq.sub(t2, t0), t1)], dim=-4)


def fp12_sqr(a: torch.Tensor) -> torch.Tensor:
    """Complex squaring: u = a0 a1, t = (a0 + a1)(a0 + v a1) - u;
    c0 = t - v u, c1 = 2u."""
    a0, a1 = a.unbind(-4)
    u, t = fp6_mul(torch.stack([a0, fq.add(a0, a1)], dim=-4),
                   torch.stack([a1, fq.add(a0, fp6_mul_by_v(a1))], dim=-4)).unbind(-4)
    t = fq.sub(t, u)
    return torch.stack([fq.sub(t, fp6_mul_by_v(u)), fq.dbl(u)], dim=-4)


def fp12_conj(a: torch.Tensor) -> torch.Tensor:
    """a^(p^6): negate the w-half."""
    a0, a1 = a.unbind(-4)
    return torch.stack([a0, fq.neg(a1)], dim=-4)


def fp12_mul_by_line(f: torch.Tensor, c00: torch.Tensor, c11: torch.Tensor,
                     c12: torch.Tensor) -> torch.Tensor:
    """f (A + B w) with A = (c00, 0, 0), B = (0, c11, c12): the sparse
    Miller-line product of the reference and of the native library."""
    f0, f1 = f.unbind(-4)
    h0, h1, h2 = f0.unbind(-3)
    g0, g1, g2 = f1.unbind(-3)
    p = fq2.mul_many([(h0, c00), (h1, c00), (h2, c00),
                      (g1, c12), (g2, c11),
                      (g0, c11), (g2, c12),
                      (g0, c12), (g1, c11)])
    t0 = torch.stack(p[:3], dim=-3)
    s = fq.add(torch.stack([p[3], p[7]], dim=-3), torch.stack([p[4], p[8]], dim=-3))
    t1 = torch.stack([fq2.mul_by_xi(s[..., 0, :, :]),
                      fq.add(p[5], fq2.mul_by_xi(p[6])), s[..., 1, :, :]], dim=-3)
    t2 = fp6_mul(fq.add(f0, f1), torch.stack(torch.broadcast_tensors(c00, c11, c12), dim=-3))
    return torch.stack([fq.add(t0, fp6_mul_by_v(t1)), fq.sub(fq.sub(t2, t0), t1)], dim=-4)


def fp12_to_ints(a: torch.Tensor) -> "list[int]":
    """A (2, 3, 2, 24) Montgomery element -> 12 canonical ints in
    (c0.a0.c0, c0.a0.c1, c0.a1.c0, ..., c1.a2.c1) order."""
    return fq.to_ints(fq.limbs32(fq.from_mont(a)))


def fp12_from_ints(vals, device="cpu") -> torch.Tensor:
    """Inverse of ``fp12_to_ints``."""
    return fq.to_mont(fq.limbs16(fq.from_ints(list(vals), device))).reshape(2, 3, 2, fq.LIMBS)
