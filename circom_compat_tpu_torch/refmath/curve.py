"""Host-side reference elliptic-curve arithmetic for BN254 G1 and G2.

Ground truth for the CUDA curve kernels (ops/curve_kernels.py) and the host path
for final proof assembly. Replaces the reference's use of ark-ec/ark-bn254
(reference: Cargo.toml:26-28; G1Affine/G2Affine in src/zkey.rs:39).

Points are affine tuples; None is the point at infinity:
  G1: (x, y) with ints mod Q
  G2: ((x0, x1), (y0, y1)) with Fq2 coefficient tuples
"""

from __future__ import annotations

from ..constants import Q, R_SCALAR, B_G1, B_G2, G1_GEN, G2_GEN
from . import field as F


class _CurveOps:
    """Affine short-Weierstrass group law generic over the coefficient field."""

    def __init__(self, add, sub, mul, neg, inv, sq, zero, one, b, is_zero):
        self.fadd, self.fsub, self.fmul, self.fneg = add, sub, mul, neg
        self.finv, self.fsq = inv, sq
        self.zero, self.one, self.b = zero, one, b
        self.fis_zero = is_zero

    def is_on_curve(self, p) -> bool:
        if p is None:
            return True
        x, y = p
        lhs = self.fsq(y)
        rhs = self.fadd(self.fmul(self.fsq(x), x), self.b)
        return lhs == rhs

    def neg(self, p):
        if p is None:
            return None
        return (p[0], self.fneg(p[1]))

    def add(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        if x1 == x2:
            if y1 == y2:
                return self.double(p1)
            return None
        m = self.fmul(self.fsub(y2, y1), self.finv(self.fsub(x2, x1)))
        x3 = self.fsub(self.fsub(self.fsq(m), x1), x2)
        y3 = self.fsub(self.fmul(m, self.fsub(x1, x3)), y1)
        return (x3, y3)

    def double(self, p):
        if p is None:
            return None
        x, y = p
        if self.fis_zero(y):
            return None
        m = self.fmul(
            self.fadd(self.fadd(self.fsq(x), self.fsq(x)), self.fsq(x)),
            self.finv(self.fadd(y, y)),
        )
        x3 = self.fsub(self.fsq(m), self.fadd(x, x))
        y3 = self.fsub(self.fmul(m, self.fsub(x, x3)), y)
        return (x3, y3)

    def mul(self, p, k: int):
        # NOTE: k is NOT reduced mod r here. For subgroup points that would
        # be harmless, but points of larger order (e.g. subgroup-membership
        # checks multiplying a candidate by r itself) would silently become
        # p*0 — which made g2_in_correct_subgroup vacuously true (round-2
        # bug fix, caught by test_wrong_subgroup_g2_rejected).
        return self.jac_to_affine(self.jac_mul(p, k))

    def jac_mul(self, p, k: int):
        """Double-and-add entirely in Jacobian coordinates: ONE field
        inversion at most (in jac_to_affine) instead of one per point op —
        the affine ladder made the G2 subgroup check ~380 Fq inversions."""
        if p is None or k == 0:
            return None
        if k < 0:
            p = self.neg(p)
            k = -k
        addend = (p[0], p[1], self.one)
        acc = None
        while k:
            if k & 1:
                acc = self.jac_add(acc, addend)
            k >>= 1
            if k:
                addend = self.jac_double(addend)
        return acc

    # ---- Jacobian helpers (no per-op field inversion) --------------------

    def jac_double(self, acc):
        if acc is None:
            return None
        c = self
        X, Y, Z = acc
        A = c.fsq(X)
        B = c.fsq(Y)
        C_ = c.fsq(B)
        D = c.fsub(c.fsub(c.fsq(c.fadd(X, B)), A), C_)
        D = c.fadd(D, D)
        E = c.fadd(c.fadd(A, A), A)
        F = c.fsq(E)
        X3 = c.fsub(F, c.fadd(D, D))
        eight_c = c.fadd(C_, C_)
        eight_c = c.fadd(eight_c, eight_c)
        eight_c = c.fadd(eight_c, eight_c)
        Y3 = c.fsub(c.fmul(E, c.fsub(D, X3)), eight_c)
        Z3 = c.fmul(c.fadd(Y, Y), Z)
        return (X3, Y3, Z3)

    def jac_mixed_add(self, acc, q_affine):
        """acc (Jacobian|None) + q (affine|None), madd-2007-bl."""
        c = self
        if q_affine is None:
            return acc
        x2, y2 = q_affine
        if acc is None:
            return (x2, y2, c.one)
        X1, Y1, Z1 = acc
        Z1Z1 = c.fsq(Z1)
        U2 = c.fmul(x2, Z1Z1)
        S2 = c.fmul(y2, c.fmul(Z1, Z1Z1))
        if U2 == X1:
            if S2 == Y1:
                return self.jac_double(acc)
            return None
        H = c.fsub(U2, X1)
        HH = c.fsq(H)
        I = c.fadd(c.fadd(HH, HH), c.fadd(HH, HH))
        J = c.fmul(H, I)
        r = c.fsub(S2, Y1)
        r = c.fadd(r, r)
        V = c.fmul(X1, I)
        X3 = c.fsub(c.fsub(c.fsq(r), J), c.fadd(V, V))
        YJ = c.fmul(Y1, J)
        Y3 = c.fsub(c.fmul(r, c.fsub(V, X3)), c.fadd(YJ, YJ))
        Z3 = c.fsub(c.fsub(c.fsq(c.fadd(Z1, H)), Z1Z1), HH)
        return (X3, Y3, Z3)

    def jac_add(self, p, q):
        """General Jacobian + Jacobian (add-2007-bl), None = infinity."""
        if p is None:
            return q
        if q is None:
            return p
        c = self
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1 = c.fsq(Z1)
        Z2Z2 = c.fsq(Z2)
        U1 = c.fmul(X1, Z2Z2)
        U2 = c.fmul(X2, Z1Z1)
        S1 = c.fmul(Y1, c.fmul(Z2, Z2Z2))
        S2 = c.fmul(Y2, c.fmul(Z1, Z1Z1))
        if U1 == U2:
            if S1 == S2:
                return self.jac_double(p)
            return None
        H = c.fsub(U2, U1)
        HH = c.fsq(H)
        HHH = c.fmul(H, HH)
        V = c.fmul(U1, HH)
        r = c.fsub(S2, S1)
        X3 = c.fsub(c.fsub(c.fsq(r), HHH), c.fadd(V, V))
        Y3 = c.fsub(c.fmul(r, c.fsub(V, X3)), c.fmul(S1, HHH))
        Z3 = c.fmul(c.fmul(Z1, Z2), H)
        return (X3, Y3, Z3)

    def jac_to_affine(self, acc):
        if acc is None:
            return None
        c = self
        X, Y, Z = acc
        if c.fis_zero(Z):
            return None
        zinv = c.finv(Z)
        zinv2 = c.fsq(zinv)
        return (c.fmul(X, zinv2), c.fmul(Y, c.fmul(zinv2, zinv)))

    def msm(self, points, scalars):
        """Host reference MSM: per-point Jacobian double-and-add, one final
        affine conversion (the device MSM lives in ops/msm.py)."""
        acc = None
        for p, s in zip(points, scalars):
            s %= R_SCALAR
            if s == 0 or p is None:
                continue
            # Jacobian double-and-add, LSB first with an affine addend table
            # replaced by doubling the running point.
            addend = (p[0], p[1], self.one)
            term = None
            k = s
            while k:
                if k & 1:
                    term = self.jac_add(term, addend)
                k >>= 1
                if k:
                    addend = self.jac_double(addend)
            acc = self.jac_add(acc, term)
        return self.jac_to_affine(acc)


def _fq_add(a, b):
    return (a + b) % Q


def _fq_sub(a, b):
    return (a - b) % Q


def _fq_mul(a, b):
    return (a * b) % Q


def _fq_neg(a):
    return (-a) % Q


def _fq_sq(a):
    return (a * a) % Q


G1 = _CurveOps(
    _fq_add, _fq_sub, _fq_mul, _fq_neg, F.fq_inv, _fq_sq,
    0, 1, B_G1, lambda a: a == 0,
)

G2 = _CurveOps(
    F.fq2_add, F.fq2_sub, F.fq2_mul, F.fq2_neg, F.fq2_inv, F.fq2_square,
    F.FQ2_ZERO, F.FQ2_ONE, B_G2, F.fq2_is_zero,
)

# Subgroup check for G2 requires multiplying by the group order; G1 points on
# the curve are automatically in the subgroup (cofactor 1 for BN254 G1).


def g1_generator():
    return G1_GEN


def g2_generator():
    return G2_GEN


class FixedBaseLadder:
    """Fast repeated scalar-mul of one base point: precomputed 2^i multiples
    plus Jacobian accumulation (no per-add field inversion). Used by the
    dev-mode trusted setup (models/setup.py) which performs ~5 * n_vars
    scalar muls of the generators."""

    def __init__(self, curve: _CurveOps, base, bits: int = 256):
        self.c = curve
        self.table = []
        p = base
        for _ in range(bits):
            self.table.append(p)
            p = curve.double(p)

    def mul(self, k: int):
        c = self.c
        acc = None
        i = 0
        k %= R_SCALAR
        while k:
            if k & 1:
                acc = c.jac_mixed_add(acc, self.table[i])
            k >>= 1
            i += 1
        return c.jac_to_affine(acc)


def g1_in_correct_subgroup(p) -> bool:
    return G1.is_on_curve(p)


def g2_in_correct_subgroup(p) -> bool:
    # [r]p computed in Jacobian: infinity shows up as None (cancellation in
    # jac_add) with no inversion needed at all.
    return G2.is_on_curve(p) and G2.jac_mul(p, R_SCALAR) is None
