"""Host-side reference field arithmetic for BN254 (plain Python integers).

This is the ground truth the CUDA kernels and their plain PyTorch versions
(ops/field.py, ops/field_kernels.py) are validated against, and the arithmetic used on the tiny host-side paths
(final proof assembly, pairing-based verification).

The reference delegates all of this to ark-ff/ark-bn254 (reference:
Cargo.toml:25-28); here it is first-party code.
"""

from __future__ import annotations

from ..constants import Q, FQ12_MODULUS_COEFFS

# ---------------------------------------------------------------------------
# Plain modular helpers (used in bulk host paths; no class overhead)
# ---------------------------------------------------------------------------


def fq_inv(a: int) -> int:
    return pow(a, -1, Q)


# ---------------------------------------------------------------------------
# Fq2 = Fq[u]/(u^2+1) as (c0, c1) int tuples
# ---------------------------------------------------------------------------

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u
    return (
        (a[0] * b[0] - a[1] * b[1]) % Q,
        (a[0] * b[1] + a[1] * b[0]) % Q,
    )


def fq2_square(a):
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    return (
        ((a[0] + a[1]) * (a[0] - a[1])) % Q,
        (2 * a[0] * a[1]) % Q,
    )


def fq2_mul_scalar(a, k: int):
    return ((a[0] * k) % Q, (a[1] * k) % Q)


def fq2_inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
    norm_inv = pow((a[0] * a[0] + a[1] * a[1]) % Q, -1, Q)
    return ((a[0] * norm_inv) % Q, (-a[1] * norm_inv) % Q)


def fq2_is_zero(a) -> bool:
    return a[0] == 0 and a[1] == 0


# ---------------------------------------------------------------------------
# FQ12 = Fq[w]/(w^12 - 18 w^6 + 82), used only by the pairing (verification).
# Coefficient-list representation in the style of classic bn128 references.
# ---------------------------------------------------------------------------


class FQ12:
    __slots__ = ("coeffs",)
    DEGREE = 12

    def __init__(self, coeffs):
        if len(coeffs) != self.DEGREE:
            raise ValueError("FQ12 needs 12 coefficients")
        self.coeffs = tuple(c % Q for c in coeffs)

    @classmethod
    def one(cls) -> "FQ12":
        return cls((1,) + (0,) * 11)

    @classmethod
    def zero(cls) -> "FQ12":
        return cls((0,) * 12)

    def __add__(self, other: "FQ12") -> "FQ12":
        return FQ12([a + b for a, b in zip(self.coeffs, other.coeffs)])

    def __sub__(self, other: "FQ12") -> "FQ12":
        return FQ12([a - b for a, b in zip(self.coeffs, other.coeffs)])

    def __neg__(self) -> "FQ12":
        return FQ12([-a for a in self.coeffs])

    def __mul__(self, other):
        if isinstance(other, int):
            return FQ12([a * other for a in self.coeffs])
        # Schoolbook 12x12 polynomial product, then reduce by
        # w^12 = 18 w^6 - 82 (FQ12_MODULUS_COEFFS).
        b = [0] * 23
        for i, ci in enumerate(self.coeffs):
            if ci == 0:
                continue
            for j, cj in enumerate(other.coeffs):
                b[i + j] += ci * cj
        for exp in range(22, 11, -1):
            top = b[exp]
            if top == 0:
                continue
            b[exp] = 0
            base = exp - 12
            for i, c in enumerate(FQ12_MODULUS_COEFFS):
                if c:
                    b[base + i] -= top * c
        return FQ12(b[:12])

    __rmul__ = __mul__

    @staticmethod
    def _reduce(b: list) -> "FQ12":
        """Reduce a degree-<23 coefficient list by w^12 = 18 w^6 - 82."""
        for exp in range(22, 11, -1):
            top = b[exp]
            if top == 0:
                continue
            b[exp] = 0
            base = exp - 12
            for i, c in enumerate(FQ12_MODULUS_COEFFS):
                if c:
                    b[base + i] -= top * c
        return FQ12(b[:12])

    def square(self) -> "FQ12":
        """Symmetric schoolbook square: ~half the coefficient products of
        a general multiply (the Miller loop and final exponentiation are
        squaring-dominated)."""
        c = self.coeffs
        b = [0] * 23
        for i in range(12):
            ci = c[i]
            if ci == 0:
                continue
            b[2 * i] += ci * ci
            for j in range(i + 1, 12):
                if c[j]:
                    b[i + j] += 2 * ci * c[j]
        return self._reduce(b)

    def mul_sparse(self, items) -> "FQ12":
        """Multiply by a sparse operand given as [(w-power, Fq coeff), ...]
        — a pairing line function has <=5 nonzero coefficients, so this is
        12*len(items) products instead of 144."""
        c = self.coeffs
        b = [0] * 23
        for idx, v in items:
            if v:
                for i, ci in enumerate(c):
                    if ci:
                        b[i + idx] += ci * v
        return self._reduce(b)

    def inv(self) -> "FQ12":
        # Extended Euclid over Fq[w] against the modulus polynomial.
        lm, hm = [1] + [0] * 12, [0] * 13
        low = list(self.coeffs) + [0]
        # monic modulus polynomial w^12 - 18 w^6 + 82
        high = [82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0, 1]
        while _deg(low):
            r = _poly_rounded_div(high, low)
            r += [0] * (13 - len(r))
            nm = list(hm)
            new = list(high)
            for i in range(13):
                for j in range(13 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % Q for x in nm]
            new = [x % Q for x in new]
            lm, low, hm, high = nm, new, lm, low
        c = pow(low[0], -1, Q)
        return FQ12([(x * c) % Q for x in lm[:12]])

    def __truediv__(self, other: "FQ12") -> "FQ12":
        return self * other.inv()

    def __pow__(self, e: int) -> "FQ12":
        if e < 0:
            return self.inv() ** (-e)
        result = FQ12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def __eq__(self, other) -> bool:
        return isinstance(other, FQ12) and self.coeffs == other.coeffs

    def __hash__(self):
        return hash(self.coeffs)

    def is_zero(self) -> bool:
        return all(c == 0 for c in self.coeffs)

    def __repr__(self):
        return f"FQ12({list(self.coeffs)})"


def _deg(p) -> int:
    d = len(p) - 1
    while d and p[d] == 0:
        d -= 1
    return d


def _poly_rounded_div(a, b):
    dega, degb = _deg(a), _deg(b)
    temp = list(a)
    out = [0] * (dega - degb + 1)
    binv = pow(b[degb], -1, Q)
    for i in range(dega - degb, -1, -1):
        out[i] = (out[i] + temp[degb + i] * binv) % Q
        for c in range(degb + 1):
            temp[c + i] = (temp[c + i] - out[i] * b[c]) % Q
    return out
