"""BLS12-381 curve groups G1 (over Fq) and G2 (over Fq2).

Jacobian-coordinate arithmetic, scalar multiplication, subgroup checks,
cofactor clearing, and the ZCash serialization format (48-byte compressed
G1 / 96-byte compressed G2 with compression/infinity/sign flag bits) that
the reference's `blst` wrapper exposes
(ethereum-consensus/src/crypto/bls.rs:{PublicKey,Signature}).

Curve equations:  E : y^2 = x^3 + 4 over Fq
                  E': y^2 = x^3 + 4(u+1) over Fq2 (the sextic twist)
"""

from __future__ import annotations

from .fields import Fq, Fq2, P, R

__all__ = [
    "G1Point",
    "G2Point",
    "G1_GENERATOR",
    "G2_GENERATOR",
    "H_EFF_G2",
    "InvalidPointError",
]

# Standard generators (from the BLS12-381 specification).
_G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
_G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

_G2_X0 = 0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8
_G2_X1 = 0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E
_G2_Y0 = 0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801
_G2_Y1 = 0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE

# Effective cofactor for G2 cofactor clearing (h_eff, RFC 9380 §8.8.2).
H_EFF_G2 = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551

# G1 cofactor (not needed for clearing via the map, kept for reference).
H_G1 = 0x396C8C005555E1568C00AAAB0000AAAB


class InvalidPointError(ValueError):
    """Encoding does not describe a valid curve point."""


class _JacobianPoint:
    """Shared Jacobian-coordinate arithmetic. Field ops are duck-typed over
    Fq / Fq2; subclasses fix the field, the curve constant b, and codec."""

    __slots__ = ("x", "y", "z")

    # subclasses set these
    FIELD = None
    B = None

    def __init__(self, x, y, z):
        self.x = x
        self.y = y
        self.z = z

    # -- constructors -------------------------------------------------------
    @classmethod
    def infinity(cls):
        f = cls.FIELD
        return cls(f.one(), f.one(), f.zero())

    @classmethod
    def from_affine(cls, x, y):
        return cls(x, y, cls.FIELD.one())

    def is_infinity(self) -> bool:
        return self.z.is_zero()

    def to_affine(self):
        """Returns (x, y) or None for the point at infinity."""
        if self.is_infinity():
            return None
        zinv = self.z.inverse()
        z2 = zinv.square()
        return (self.x * z2, self.y * z2 * zinv)

    # -- group law ----------------------------------------------------------
    def double(self):
        if self.is_infinity():
            return self
        x, y, z = self.x, self.y, self.z
        a = x.square()
        b = y.square()
        c = b.square()
        d = (x + b).square() - a - c
        d = d + d
        e = a + a + a
        f = e.square()
        x3 = f - d - d
        c8 = c + c
        c8 = c8 + c8
        c8 = c8 + c8
        y3 = e * (d - x3) - c8
        z3 = (y * z) + (y * z)
        return type(self)(x3, y3, z3)

    def __add__(self, other):
        if self.is_infinity():
            return other
        if other.is_infinity():
            return self
        x1, y1, z1 = self.x, self.y, self.z
        x2, y2, z2 = other.x, other.y, other.z
        z1z1 = z1.square()
        z2z2 = z2.square()
        u1 = x1 * z2z2
        u2 = x2 * z1z1
        s1 = y1 * z2 * z2z2
        s2 = y2 * z1 * z1z1
        if u1 == u2:
            if s1 == s2:
                return self.double()
            return type(self).infinity()
        h = u2 - u1
        i = (h + h).square()
        j = h * i
        r = s2 - s1
        r = r + r
        v = u1 * i
        x3 = r.square() - j - v - v
        y3 = r * (v - x3) - (s1 * j) - (s1 * j)
        z3 = ((z1 * z2) + (z1 * z2)) * h
        return type(self)(x3, y3, z3)

    def __neg__(self):
        return type(self)(self.x, -self.y, self.z)

    def __sub__(self, other):
        return self + (-other)

    def __eq__(self, other) -> bool:
        if type(self) is not type(other):
            return NotImplemented
        # cross-multiply to compare projective classes
        if self.is_infinity() or other.is_infinity():
            return self.is_infinity() and other.is_infinity()
        z1z1 = self.z.square()
        z2z2 = other.z.square()
        if self.x * z2z2 != other.x * z1z1:
            return False
        return self.y * z2z2 * other.z == other.y * z1z1 * self.z

    def __hash__(self):
        aff = self.to_affine()
        return hash((type(self).__name__, None if aff is None else (aff[0], aff[1])))

    def __mul__(self, scalar: int):
        """Scalar multiplication (double-and-add, MSB-first)."""
        if scalar < 0:
            return (-self) * (-scalar)
        result = type(self).infinity()
        if scalar == 0 or self.is_infinity():
            return result
        addend = self
        for bit in bin(scalar)[2:]:
            result = result.double()
            if bit == "1":
                result = result + addend
        return result

    __rmul__ = __mul__

    # -- validation ---------------------------------------------------------
    def is_on_curve(self) -> bool:
        if self.is_infinity():
            return True
        x, y = self.to_affine()
        return y.square() == x.square() * x + self.B

    def in_subgroup(self) -> bool:
        """Order-r subgroup membership (scalar-mul check; the oracle favors
        clarity over the endomorphism fast path)."""
        return (self * R).is_infinity()

    def __repr__(self) -> str:
        aff = self.to_affine()
        if aff is None:
            return f"{type(self).__name__}(infinity)"
        return f"{type(self).__name__}({aff[0]!r}, {aff[1]!r})"


# -- serialization flag bits (ZCash BLS12-381 format) ------------------------
# In the most significant byte of the encoding:
_COMPRESSED_FLAG = 0x80
_INFINITY_FLAG = 0x40
_SIGN_FLAG = 0x20


def _fq_is_lexicographically_largest(y: Fq) -> bool:
    return y.n > (P - 1) // 2


def _fq2_is_lexicographically_largest(y: Fq2) -> bool:
    # compare c1 first, then c0 (ZCash convention)
    if y.c1.n != 0:
        return y.c1.n > (P - 1) // 2
    return y.c0.n > (P - 1) // 2


class G1Point(_JacobianPoint):
    FIELD = Fq
    B = Fq(4)

    def serialize(self) -> bytes:
        """48-byte compressed encoding."""
        if self.is_infinity():
            out = bytearray(48)
            out[0] = _COMPRESSED_FLAG | _INFINITY_FLAG
            return bytes(out)
        x, y = self.to_affine()
        out = bytearray(x.n.to_bytes(48, "big"))
        out[0] |= _COMPRESSED_FLAG
        if _fq_is_lexicographically_largest(y):
            out[0] |= _SIGN_FLAG
        return bytes(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "G1Point":
        """Decode 48-byte compressed encoding; validates curve membership
        and subgroup (matching blst's `key_validate`-adjacent behavior)."""
        if len(data) != 48:
            raise InvalidPointError(f"G1 compressed encoding must be 48 bytes, got {len(data)}")
        flags = data[0]
        if not flags & _COMPRESSED_FLAG:
            raise InvalidPointError("uncompressed G1 encodings are not supported")
        if flags & _INFINITY_FLAG:
            if any(data[1:]) or flags & ~(_COMPRESSED_FLAG | _INFINITY_FLAG):
                raise InvalidPointError("malformed G1 infinity encoding")
            return cls.infinity()
        xn = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
        if xn >= P:
            raise InvalidPointError("G1 x coordinate not in field")
        x = Fq(xn)
        y2 = x.square() * x + cls.B
        y = y2.sqrt()
        if y is None:
            raise InvalidPointError("G1 x coordinate not on curve")
        if _fq_is_lexicographically_largest(y) != bool(flags & _SIGN_FLAG):
            y = -y
        point = cls.from_affine(x, y)
        if not point.in_subgroup():
            raise InvalidPointError("G1 point not in the order-r subgroup")
        return point


class G2Point(_JacobianPoint):
    FIELD = Fq2
    B = Fq2(Fq(4), Fq(4))  # 4(u+1)

    def serialize(self) -> bytes:
        """96-byte compressed encoding (c1 || c0 big-endian)."""
        if self.is_infinity():
            out = bytearray(96)
            out[0] = _COMPRESSED_FLAG | _INFINITY_FLAG
            return bytes(out)
        x, y = self.to_affine()
        out = bytearray(x.c1.n.to_bytes(48, "big") + x.c0.n.to_bytes(48, "big"))
        out[0] |= _COMPRESSED_FLAG
        if _fq2_is_lexicographically_largest(y):
            out[0] |= _SIGN_FLAG
        return bytes(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "G2Point":
        if len(data) != 96:
            raise InvalidPointError(f"G2 compressed encoding must be 96 bytes, got {len(data)}")
        flags = data[0]
        if not flags & _COMPRESSED_FLAG:
            raise InvalidPointError("uncompressed G2 encodings are not supported")
        if flags & _INFINITY_FLAG:
            if any(data[1:]) or flags & ~(_COMPRESSED_FLAG | _INFINITY_FLAG):
                raise InvalidPointError("malformed G2 infinity encoding")
            return cls.infinity()
        x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
        x0 = int.from_bytes(data[48:96], "big")
        if x0 >= P or x1 >= P:
            raise InvalidPointError("G2 x coordinate not in field")
        x = Fq2(Fq(x0), Fq(x1))
        y2 = x.square() * x + cls.B
        y = y2.sqrt()
        if y is None:
            raise InvalidPointError("G2 x coordinate not on curve")
        if _fq2_is_lexicographically_largest(y) != bool(flags & _SIGN_FLAG):
            y = -y
        point = cls.from_affine(x, y)
        if not point.in_subgroup():
            raise InvalidPointError("G2 point not in the order-r subgroup")
        return point

    def clear_cofactor(self) -> "G2Point":
        """Map onto the order-r subgroup via the effective cofactor."""
        return self * H_EFF_G2

    def psi(self) -> "G2Point":
        """The untwist-Frobenius-twist endomorphism (for future fast subgroup
        checks); not used by the oracle paths yet."""
        raise NotImplementedError


G1_GENERATOR = G1Point.from_affine(Fq(_G1_X), Fq(_G1_Y))
G2_GENERATOR = G2Point.from_affine(
    Fq2(Fq(_G2_X0), Fq(_G2_X1)), Fq2(Fq(_G2_Y0), Fq(_G2_Y1))
)
