"""BLS12-381 field tower: Fq, Fq2, Fq6, Fq12, and the scalar field Fr.

This is the arithmetic substrate for the BLS signature scheme and KZG
commitments — the role the `blst` C/assembly library plays for the reference
(wrapped at ethereum-consensus/src/crypto/bls.rs). Implemented from the
curve parameters (BLS12-381: p, r, non-residues) as a pure-Python oracle;
the batched device paths in ops/ are checked against this.

Tower construction (standard for BLS12-381):
    Fq2  = Fq[u]  / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - (u + 1))
    Fq12 = Fq6[w] / (w^2 - v)
"""

from __future__ import annotations

__all__ = ["P", "R", "Fq", "Fq2", "Fq6", "Fq12", "Fr", "frobenius_coeffs_c1"]

# Base field modulus (381 bits).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Scalar field modulus (curve order, 255 bits).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter x (negative: x = -0xd201000000010000).
BLS_X = 0xD201000000010000
BLS_X_IS_NEGATIVE = True


class Fq:
    """Prime field element mod P."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % P

    def __add__(self, other: "Fq") -> "Fq":
        return Fq(self.n + other.n)

    def __sub__(self, other: "Fq") -> "Fq":
        return Fq(self.n - other.n)

    def __mul__(self, other: "Fq") -> "Fq":
        return Fq(self.n * other.n)

    def __neg__(self) -> "Fq":
        return Fq(-self.n)

    def __eq__(self, other) -> bool:
        return isinstance(other, Fq) and self.n == other.n

    def __hash__(self):
        return hash(("Fq", self.n))

    def square(self) -> "Fq":
        return Fq(self.n * self.n)

    def inverse(self) -> "Fq":
        if self.n == 0:
            raise ZeroDivisionError("Fq inverse of zero")
        return Fq(pow(self.n, P - 2, P))

    def pow(self, e: int) -> "Fq":
        return Fq(pow(self.n, e, P))

    def sqrt(self) -> "Fq | None":
        # P ≡ 3 (mod 4): candidate = self^((P+1)/4)
        cand = Fq(pow(self.n, (P + 1) // 4, P))
        return cand if cand.square() == self else None

    def is_zero(self) -> bool:
        return self.n == 0

    def sgn0(self) -> int:
        return self.n & 1

    @classmethod
    def zero(cls) -> "Fq":
        return cls(0)

    @classmethod
    def one(cls) -> "Fq":
        return cls(1)

    def __repr__(self) -> str:
        return f"Fq(0x{self.n:x})"


class Fq2:
    """Fq[u]/(u^2+1): c0 + c1*u."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq, c1: Fq):
        self.c0 = c0
        self.c1 = c1

    @classmethod
    def from_ints(cls, a: int, b: int) -> "Fq2":
        return cls(Fq(a), Fq(b))

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o: "Fq2") -> "Fq2":
        # Karatsuba: (a0+a1u)(b0+b1u) = a0b0 - a1b1 + ((a0+a1)(b0+b1)-a0b0-a1b1)u
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fq2(t0 - t1, t2 - t0 - t1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash(("Fq2", self.c0.n, self.c1.n))

    def square(self) -> "Fq2":
        # (a+bu)^2 = (a+b)(a-b) + 2ab·u
        a, b = self.c0, self.c1
        t0 = (a + b) * (a - b)
        t1 = a * b
        return Fq2(t0, t1 + t1)

    def scalar_mul(self, k: Fq) -> "Fq2":
        return Fq2(self.c0 * k, self.c1 * k)

    def mul_by_nonresidue(self) -> "Fq2":
        # ξ = u + 1: (a+bu)(1+u) = (a-b) + (a+b)u
        return Fq2(self.c0 - self.c1, self.c0 + self.c1)

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def inverse(self) -> "Fq2":
        # 1/(a+bu) = (a-bu)/(a^2+b^2)
        norm = self.c0.square() + self.c1.square()
        inv = norm.inverse()
        return Fq2(self.c0 * inv, -(self.c1 * inv))

    def pow(self, e: int) -> "Fq2":
        result = Fq2.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def frobenius(self) -> "Fq2":
        # x -> x^p = conjugate in Fq2
        return self.conjugate()

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero()

    def sgn0(self) -> int:
        # RFC 9380 sgn0 for m=2: sign of c0 unless c0 == 0, then c1
        s0 = self.c0.n & 1
        z0 = 1 if self.c0.n == 0 else 0
        s1 = self.c1.n & 1
        return s0 | (z0 & s1)

    def sqrt(self) -> "Fq2 | None":
        """Square root in Fq2 (p ≡ 3 mod 4 algorithm)."""
        if self.is_zero():
            return self
        # a1 = self^((p-3)/4); alpha = a1^2 * self; x0 = a1*self
        a1 = self.pow((P - 3) // 4)
        alpha = a1.square() * self
        x0 = a1 * self
        if alpha == Fq2(Fq(P - 1), Fq.zero()):  # alpha == -1
            return Fq2(-x0.c1, x0.c0)  # i * x0
        b = (alpha + Fq2.one()).pow((P - 1) // 2)
        cand = b * x0
        return cand if cand.square() == self else None

    @classmethod
    def zero(cls) -> "Fq2":
        return cls(Fq.zero(), Fq.zero())

    @classmethod
    def one(cls) -> "Fq2":
        return cls(Fq.one(), Fq.zero())

    def __repr__(self) -> str:
        return f"Fq2(0x{self.c0.n:x}, 0x{self.c1.n:x})"


# Frobenius coefficients for Fq6/Fq12: ξ^((p^i - 1)/k) precomputed lazily.
_XI = Fq2.from_ints(1, 1)


def _xi_pow(exp_num: int, exp_den: int, power_of_p: int) -> Fq2:
    """ξ^((p^power_of_p - 1) * exp_num / exp_den)."""
    e = (pow(P, power_of_p) - 1) * exp_num // exp_den
    return _XI.pow(e)


class _FrobeniusTables:
    """Lazily computed Frobenius twist coefficients."""

    def __init__(self):
        self._c1_6: list[Fq2] | None = None  # for Fq6 c1 coefficients
        self._c2_6: list[Fq2] | None = None  # for Fq6 c2 coefficients
        self._c1_12: list[Fq2] | None = None  # for Fq12

    @property
    def fq6_c1(self) -> list[Fq2]:
        if self._c1_6 is None:
            self._c1_6 = [_XI.pow((pow(P, i) - 1) // 3) for i in range(6)]
        return self._c1_6

    @property
    def fq6_c2(self) -> list[Fq2]:
        if self._c2_6 is None:
            self._c2_6 = [_XI.pow(2 * (pow(P, i) - 1) // 3) for i in range(6)]
        return self._c2_6

    @property
    def fq12_c1(self) -> list[Fq2]:
        if self._c1_12 is None:
            self._c1_12 = [_XI.pow((pow(P, i) - 1) // 6) for i in range(12)]
        return self._c1_12


_FROB = _FrobeniusTables()


def frobenius_coeffs_c1(i: int) -> Fq2:
    return _FROB.fq12_c1[i % 12]


class Fq6:
    """Fq2[v]/(v^3 - ξ): c0 + c1*v + c2*v^2."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0 = c0
        self.c1 = c1
        self.c2 = c2

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __eq__(self, o) -> bool:
        return (
            isinstance(o, Fq6)
            and self.c0 == o.c0
            and self.c1 == o.c1
            and self.c2 == o.c2
        )

    def __hash__(self):
        return hash(("Fq6", self.c0, self.c1, self.c2))

    def __mul__(self, o: "Fq6") -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self) -> "Fq6":
        return self * self

    def mul_by_nonresidue(self) -> "Fq6":
        # v * (c0 + c1 v + c2 v^2) = ξ·c2 + c0 v + c1 v^2
        return Fq6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def scalar_mul2(self, k: Fq2) -> "Fq6":
        return Fq6(self.c0 * k, self.c1 * k, self.c2 * k)

    def inverse(self) -> "Fq6":
        a, b, c = self.c0, self.c1, self.c2
        t0 = a.square() - (b * c).mul_by_nonresidue()
        t1 = c.square().mul_by_nonresidue() - a * b
        t2 = b.square() - a * c
        denom = (a * t0 + (c * t1 + b * t2).mul_by_nonresidue()).inverse()
        return Fq6(t0 * denom, t1 * denom, t2 * denom)

    def frobenius(self) -> "Fq6":
        return Fq6(
            self.c0.frobenius(),
            self.c1.frobenius() * _FROB.fq6_c1[1],
            self.c2.frobenius() * _FROB.fq6_c2[1],
        )

    def frobenius_n(self, n: int) -> "Fq6":
        out = self
        for _ in range(n):
            out = out.frobenius()
        return out

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    @classmethod
    def zero(cls) -> "Fq6":
        return cls(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @classmethod
    def one(cls) -> "Fq6":
        return cls(Fq2.one(), Fq2.zero(), Fq2.zero())


class Fq12:
    """Fq6[w]/(w^2 - v): c0 + c1*w."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0 = c0
        self.c1 = c1

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash(("Fq12", self.c0, self.c1))

    def __mul__(self, o: "Fq12") -> "Fq12":
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        c0 = t0 + t1.mul_by_nonresidue()
        c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - t0 - t1
        return Fq12(c0, c1)

    def square(self) -> "Fq12":
        # (a + bw)^2 = a^2 + v b^2 + 2abw
        a, b = self.c0, self.c1
        t0 = a * b
        c0 = (a + b) * (a + b.mul_by_nonresidue()) - t0 - t0.mul_by_nonresidue()
        return Fq12(c0, t0 + t0)

    def conjugate(self) -> "Fq12":
        return Fq12(self.c0, -self.c1)

    def inverse(self) -> "Fq12":
        denom = (self.c0.square() - self.c1.square().mul_by_nonresidue()).inverse()
        return Fq12(self.c0 * denom, -(self.c1 * denom))

    def pow(self, e: int) -> "Fq12":
        result = Fq12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def frobenius(self) -> "Fq12":
        c0 = self.c0.frobenius()
        c1f = self.c1.frobenius()
        coeff = _FROB.fq12_c1[1]
        c1 = Fq6(c1f.c0 * coeff, c1f.c1 * coeff, c1f.c2 * coeff)
        return Fq12(c0, c1)

    def frobenius_n(self, n: int) -> "Fq12":
        out = self
        for _ in range(n % 12):
            out = out.frobenius()
        return out

    def is_one(self) -> bool:
        return self == Fq12.one()

    @classmethod
    def zero(cls) -> "Fq12":
        return cls(Fq6.zero(), Fq6.zero())

    @classmethod
    def one(cls) -> "Fq12":
        return cls(Fq6.one(), Fq6.zero())


class Fr:
    """Scalar field element mod R (the curve order) — used by KZG polynomial
    math; plain ints are used for scalars elsewhere."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % R

    def __add__(self, o: "Fr") -> "Fr":
        return Fr(self.n + o.n)

    def __sub__(self, o: "Fr") -> "Fr":
        return Fr(self.n - o.n)

    def __mul__(self, o: "Fr") -> "Fr":
        return Fr(self.n * o.n)

    def __neg__(self) -> "Fr":
        return Fr(-self.n)

    def __eq__(self, o) -> bool:
        return isinstance(o, Fr) and self.n == o.n

    def __hash__(self):
        return hash(("Fr", self.n))

    def inverse(self) -> "Fr":
        if self.n == 0:
            raise ZeroDivisionError("Fr inverse of zero")
        return Fr(pow(self.n, R - 2, R))

    def pow(self, e: int) -> "Fr":
        return Fr(pow(self.n, e, R))

    def is_zero(self) -> bool:
        return self.n == 0

    @classmethod
    def zero(cls) -> "Fr":
        return cls(0)

    @classmethod
    def one(cls) -> "Fr":
        return cls(1)

    def __repr__(self) -> str:
        return f"Fr(0x{self.n:x})"
