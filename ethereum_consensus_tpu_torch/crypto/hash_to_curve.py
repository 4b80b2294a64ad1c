"""Hash-to-curve for G2: BLS12381G2_XMD:SHA-256_SSWU_RO_ (RFC 9380).

This is how messages become signable G2 points in the min_pk BLS scheme —
the role blst's `hash_to_g2` plays for the reference
(ethereum-consensus/src/crypto/bls.rs sign/verify paths, which pass the
Ethereum ciphersuite DST).

Pipeline: expand_message_xmd(SHA-256) → hash_to_field (two Fq2 elements) →
simplified SWU onto the 3-isogenous curve E'' → derived 3-isogeny onto the
G2 twist E' (constants in g2_isogeny.py, re-derived by Vélu's formulas in
_isogeny_derive.py) → point addition → cofactor clearing by h_eff.
"""

from __future__ import annotations

import hashlib

from .curves import G2Point
from .fields import Fq, Fq2, P
from . import g2_isogeny as iso

__all__ = [
    "ETH_DST",
    "expand_message_xmd",
    "hash_to_field_fq2",
    "map_to_curve_sswu",
    "iso_map_to_g2_curve",
    "hash_to_g2",
]

# Ethereum 2.0 BLS ciphersuite domain separation tag.
ETH_DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

_B_IN_BYTES = 32  # SHA-256 output
_R_IN_BYTES = 64  # SHA-256 block
_L = 64  # bytes per field-element component (ceil((381 + 128)/8))

# SSWU curve E'': y² = x³ + A'x + B', and Z (RFC 9380 §8.8.2)
_A = Fq2(Fq(0), Fq(240))
_B = Fq2(Fq(1012), Fq(1012))
_Z = Fq2(Fq(P - 2), Fq(P - 1))  # -(2 + u)
_NEG_B_OVER_A = -(_B * _A.inverse())
_B_OVER_ZA = _B * (_Z * _A).inverse()


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 expand_message_xmd with SHA-256."""
    ell = (len_in_bytes + _B_IN_BYTES - 1) // _B_IN_BYTES
    if ell > 255 or len_in_bytes > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xmd parameter overflow")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = b"\x00" * _R_IN_BYTES
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    blocks = [b1]
    for i in range(2, ell + 1):
        prev = blocks[-1]
        xored = bytes(a ^ b for a, b in zip(b0, prev))
        blocks.append(hashlib.sha256(xored + i.to_bytes(1, "big") + dst_prime).digest())
    return b"".join(blocks)[:len_in_bytes]


def hash_to_field_fq2(msg: bytes, count: int, dst: bytes = ETH_DST) -> list[Fq2]:
    """RFC 9380 §5.2 hash_to_field for m=2, L=64."""
    len_in_bytes = count * 2 * _L
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        comps = []
        for j in range(2):
            offset = _L * (j + i * 2)
            tv = uniform[offset : offset + _L]
            comps.append(Fq(int.from_bytes(tv, "big")))
        out.append(Fq2(comps[0], comps[1]))
    return out


def map_to_curve_sswu(u: Fq2) -> tuple[Fq2, Fq2]:
    """Simplified SWU map onto E'' (RFC 9380 §6.6.2), returning affine (x, y)."""
    zu2 = _Z * u.square()  # Z·u²
    tv = zu2.square() + zu2  # Z²u⁴ + Zu²
    if tv.is_zero():
        # exceptional case: x1 = B / (Z·A)
        x1 = _B_OVER_ZA
    else:
        x1 = _NEG_B_OVER_A * (Fq2.one() + tv.inverse())
    gx1 = x1.square() * x1 + _A * x1 + _B
    y1 = gx1.sqrt()
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = zu2 * x1
        gx2 = x2.square() * x2 + _A * x2 + _B
        y2 = gx2.sqrt()
        if y2 is None:
            raise AssertionError("SSWU: neither g(x1) nor g(x2) is square")
        x, y = x2, y2
    if y.sgn0() != u.sgn0():
        y = -y
    return x, y


def iso_map_to_g2_curve(x: Fq2, y: Fq2) -> G2Point:
    """Apply the derived 3-isogeny E'' → E' to an affine E'' point."""

    def horner(coeffs: list[Fq2], v: Fq2) -> Fq2:
        acc = Fq2.zero()
        for c in reversed(coeffs):
            acc = acc * v + c
        return acc

    x_num = horner(iso.X_NUM, x)
    x_den = horner(iso.X_DEN, x)
    y_num = horner(iso.Y_NUM, x)
    y_den = horner(iso.Y_DEN, x)
    # x == kernel x0 maps to the identity; SSWU outputs are uniformly random
    # so this is cryptographically unreachable, but guard anyway.
    if x_den.is_zero() or y_den.is_zero():
        return G2Point.infinity()
    xo = x_num * x_den.inverse()
    yo = y * y_num * y_den.inverse()
    return G2Point.from_affine(xo, yo)


def hash_to_g2(msg: bytes, dst: bytes = ETH_DST) -> G2Point:
    """Full RFC 9380 hash_to_curve for the G2 ciphersuite."""
    u0, u1 = hash_to_field_fq2(msg, 2, dst)
    q0 = iso_map_to_g2_curve(*map_to_curve_sswu(u0))
    q1 = iso_map_to_g2_curve(*map_to_curve_sswu(u1))
    return (q0 + q1).clear_cofactor()
