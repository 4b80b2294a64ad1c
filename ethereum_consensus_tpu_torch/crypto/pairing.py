"""Optimal ate pairing for BLS12-381.

The verification core of the BLS signature scheme — the role blst's pairing
engine plays for the reference (ethereum-consensus/src/crypto/bls.rs
verify/aggregate_verify paths).

Design: G2 points are untwisted into E(Fq12) and the Miller loop runs with
affine line functions over Fq12. This trades speed for transparency — the
oracle must be obviously correct; batched/device acceleration lives a level
up (multi-pairing products share one final exponentiation).

Untwist (tower Fq12 = Fq6[w]/(w²-v), Fq6 = Fq2[v]/(v³-ξ), ξ = u+1):
    ψ(x', y') = (x'·v²/ξ, y'·v·w/ξ)
which maps E'(Fq2): y² = x³ + 4ξ onto E(Fq12): y² = x³ + 4.
"""

from __future__ import annotations

from .curves import G1Point, G2Point
from .fields import BLS_X, Fq2, Fq6, Fq12, P, R

__all__ = ["pairing", "miller_loop", "multi_miller_loop", "final_exponentiation"]


_XI_INV = Fq2.from_ints(1, 1).inverse()


def _untwist(q: G2Point) -> tuple[Fq12, Fq12]:
    """Affine G2 point → affine coordinates in E(Fq12)."""
    xq, yq = q.to_affine()
    x12 = Fq12(Fq6(Fq2.zero(), Fq2.zero(), xq * _XI_INV), Fq6.zero())
    y12 = Fq12(Fq6.zero(), Fq6(Fq2.zero(), yq * _XI_INV, Fq2.zero()))
    return x12, y12


def _embed_g1(p: G1Point) -> tuple[Fq12, Fq12]:
    xp, yp = p.to_affine()
    def lift(a):
        return Fq12(Fq6(Fq2(a, a.__class__(0)), Fq2.zero(), Fq2.zero()), Fq6.zero())
    return lift(xp), lift(yp)


def _line(x1: Fq12, y1: Fq12, x2: Fq12, y2: Fq12, xt: Fq12, yt: Fq12) -> Fq12:
    """Evaluate the line through (x1,y1),(x2,y2) at (xt,yt).

    Doubling when the points coincide; vertical line when x1==x2, y1!=y2.
    """
    if x1 == x2 and y1 == y2:
        # tangent: m = 3x²/(2y)
        num = x1.square()
        num = num + num + num
        den = y1 + y1
        m = num * den.inverse()
        return m * (xt - x1) - (yt - y1)
    if x1 == x2:
        return xt - x1
    m = (y2 - y1) * (x2 - x1).inverse()
    return m * (xt - x1) - (yt - y1)


def _point_add(a, b):
    """Affine addition on E(Fq12). For the order-r inputs the Miller loop
    feeds in, intermediate multiples [k]Q with 0 < k ≤ |x| ≪ r can never be
    the identity or each other's negatives, so no infinity handling is
    needed (asserted for defense in depth)."""
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        assert y1 == y2, "Miller loop hit P + (-P); inputs not in the r-subgroup"
        num = x1.square()
        num = num + num + num
        den = y1 + y1
        m = num * den.inverse()
    else:
        m = (y2 - y1) * (x2 - x1).inverse()
    x3 = m.square() - x1 - x2
    y3 = m * (x1 - x3) - y1
    return (x3, y3)


def miller_loop(q: G2Point, p: G1Point) -> Fq12:
    """f_{|x|,Q}(P) for the BLS parameter, conjugated for the negative x."""
    if q.is_infinity() or p.is_infinity():
        return Fq12.one()
    xq, yq = _untwist(q)
    xp, yp = _embed_g1(p)

    f = Fq12.one()
    rx, ry = xq, yq
    for bit in bin(BLS_X)[3:]:  # MSB already consumed by initializing R = Q
        f = f.square() * _line(rx, ry, rx, ry, xp, yp)
        rx, ry = _point_add((rx, ry), (rx, ry))
        if bit == "1":
            f = f * _line(rx, ry, xq, yq, xp, yp)
            rx, ry = _point_add((rx, ry), (xq, yq))
    # BLS parameter x is negative: f ← conj(f) (p^6-power Frobenius).
    return f.conjugate()


def multi_miller_loop(pairs: list[tuple[G1Point, G2Point]]) -> Fq12:
    """Product of Miller loops — shares the (expensive) final exponentiation
    across all pairs; this is the shape batched verification wants."""
    f = Fq12.one()
    for p, q in pairs:
        if p.is_infinity() or q.is_infinity():
            continue
        f = f * miller_loop(q, p)
    return f


def pairing_product_is_one(pairs: list[tuple[G1Point, G2Point]]) -> bool:
    """Π e(Pi, Qi) == 1 with one shared final exponentiation — the single
    verification primitive every BLS/KZG check reduces to."""
    return final_exponentiation(multi_miller_loop(pairs)).is_one()


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((p^12 - 1)/r).

    Easy part via Frobenius/conjugation; the hard part uses a plain square-
    and-multiply over (p^4 - p^2 + 1)/r (clarity over the Karabina cyclotomic
    decomposition — the oracle is not the hot path).
    """
    # easy: f^(p^6 - 1) = conj(f) * f^-1 ; then ^(p^2 + 1)
    f1 = f.conjugate() * f.inverse()
    f2 = f1.frobenius_n(2) * f1
    # hard: ^((p^4 - p^2 + 1) / r)
    hard = (P**4 - P**2 + 1) // R
    return f2.pow(hard)


def pairing(p: G1Point, q: G2Point) -> Fq12:
    """e(P, Q) for P ∈ G1, Q ∈ G2."""
    return final_exponentiation(miller_loop(q, p))
