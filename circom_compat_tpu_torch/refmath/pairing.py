"""Host-side BN254 optimal-ate pairing for Groth16 verification.

Verification is O(1) per proof, so it stays on the host (SURVEY.md section 7:
"pairing can live host-side"). Replaces the reference's use of ark_ec pairing
inside ark-groth16's verify (reference: src/zkey.rs:868-872).

Implementation follows the classic bn128 construction for the Miller
loop: G2 points are untwisted into FQ12, affine line functions over
ATE_LOOP_COUNT, two Frobenius-twisted extra lines. The final
exponentiation is the BN cyclotomic decomposition — easy part
(p^6-1)(p^2+1) then the Devegili–Scott–Dominguez hard-part addition
chain for (p^4-p^2+1)/r with Frobenius maps evaluated as precomputed
Fq-linear maps in the polynomial basis — ~300 FQ12 multiplications
instead of a naive 3046-bit exponentiation (~15x faster verify).
"""

from __future__ import annotations

from functools import lru_cache

from ..constants import BN_X, Q, R_SCALAR, ATE_LOOP_COUNT, LOG_ATE_LOOP_COUNT
from .field import FQ12

# w in FQ12
_W = FQ12((0, 1) + (0,) * 10)
_W2 = _W * _W
_W3 = _W2 * _W

FINAL_EXPONENT = (Q**12 - 1) // R_SCALAR


def _embed_fq(x: int) -> FQ12:
    return FQ12((x,) + (0,) * 11)


def twist(pt):
    """Map a G2 point ((x0,x1),(y0,y1)) into the curve over FQ12."""
    if pt is None:
        return None
    (x0, x1), (y0, y1) = pt
    # Change of basis: Fq2 = Fq[u]/(u^2+1) embeds into FQ12 via u -> w^6 + 9
    nx = FQ12(((x0 - 9 * x1) % Q,) + (0,) * 5 + (x1,) + (0,) * 5)
    ny = FQ12(((y0 - 9 * y1) % Q,) + (0,) * 5 + (y1,) + (0,) * 5)
    return (nx * _W2, ny * _W3)


def cast_g1(pt):
    if pt is None:
        return None
    return (_embed_fq(pt[0]), _embed_fq(pt[1]))


def _linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 at point t (all over FQ12)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (3 * (x1 * x1)) / (2 * y1)
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return _double(p1)
    if x1 == x2:
        return None
    m = (y2 - y1) / (x2 - x1)
    x3 = m * m - x1 - x2
    return (x3, m * (x1 - x3) - y1)


def _double(p):
    x, y = p
    m = (3 * (x * x)) / (2 * y)
    x3 = m * m - 2 * x
    return (x3, m * (x - x3) - y)


def miller_loop(q_twisted, p_cast) -> FQ12:
    """Miller loop producing an unreduced pairing value in FQ12."""
    if q_twisted is None or p_cast is None:
        return FQ12.one()
    r = q_twisted
    f = FQ12.one()
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        f = f * f * _linefunc(r, r, p_cast)
        r = _double(r)
        if ATE_LOOP_COUNT & (1 << i):
            f = f * _linefunc(r, q_twisted, p_cast)
            r = _add(r, q_twisted)
    # Frobenius-twisted points: pi(Q) and -pi^2(Q)
    q1 = (q_twisted[0] ** Q, q_twisted[1] ** Q)
    nq2 = (q1[0] ** Q, -(q1[1] ** Q))
    f = f * _linefunc(r, q1, p_cast)
    r = _add(r, q1)
    f = f * _linefunc(r, nq2, p_cast)
    return f


# ---------------------------------------------------------------------------
# Frobenius endomorphism and the decomposed final exponentiation
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def _frob1_rows():
    """(w^p)^i for i in 0..11 as coefficient tuples: f -> f^p is Fq-linear
    (Fq coefficients are Frobenius-fixed), so it is the linear extension
    of w -> w^p. The one-time w**Q is a 254-bit FQ12 pow."""
    v1 = _W ** Q
    rows = [FQ12.one()]
    for _ in range(11):
        rows.append(rows[-1] * v1)
    return tuple(r.coeffs for r in rows)


def frobenius(f: FQ12, j: int = 1) -> FQ12:
    """f^(p^j) via j applications of the precomputed linear map
    (144 Fq multiplications each — vs a 254-bit pow)."""
    rows = _frob1_rows()
    for _ in range(j):
        out = [0] * 12
        for ci, row in zip(f.coeffs, rows):
            if ci:
                for k in range(12):
                    if row[k]:
                        out[k] += ci * row[k]
        f = FQ12(out)
    return f


def final_exponentiate(f: FQ12) -> FQ12:
    """f^((q^12-1)/r), decomposed.

    Easy part (p^6-1)(p^2+1), then the Devegili–Scott–Dominguez addition
    chain ("Implementing cryptographic pairings over Barreto–Naehrig
    curves") whose exponent L satisfies
    (p^6-1)(p^2+1) * L  ==  (q^12-1)/r   (mod q^12-1)
    — an integer identity checked symbolically and cross-checked against
    the naive exponentiation on random values in tests/test_pairing.py.
    In the cyclotomic subgroup (post easy part) inversion is free:
    m^-1 = m^(p^6) = frobenius(m, 6)."""
    # easy: f^((p^6-1)(p^2+1))
    m = frobenius(f, 6) * f.inv()  # ^(p^6 - 1)
    m = frobenius(m, 2) * m  # ^(p^2 + 1)

    def conj(a: FQ12) -> FQ12:  # cyclotomic inverse
        return frobenius(a, 6)

    fu = m**BN_X
    fu2 = fu**BN_X
    fu3 = fu2**BN_X
    y0 = frobenius(m, 1) * frobenius(m, 2) * frobenius(m, 3)
    y1 = conj(m)
    y2 = frobenius(fu2, 2)
    y3 = conj(frobenius(fu, 1))
    y4 = conj(fu * frobenius(fu2, 1))
    y5 = conj(fu2)
    y6 = conj(fu3 * frobenius(fu3, 1))
    t0 = y6 * y6 * y4 * y5
    t1 = y3 * y5 * t0
    t0 = t0 * y2
    t1 = t1 * t1 * t0
    t1 = t1 * t1
    t0 = t1 * y1
    t1 = t1 * y0
    t0 = t0 * t0
    return t0 * t1


# ---------------------------------------------------------------------------
# Fast Miller loop: twisted-point arithmetic on Fq2 components
#
# The twisted curve's points live in the (Fq2·w^2, Fq2·w^3) subspaces, so
# the group law runs entirely on Fq2 pairs (slopes cost one Fq inversion
# instead of an FQ12 extended-Euclid — the naive loop's dominant term) and
# each line function is a 5-coefficient sparse FQ12 multiply. Identical
# output to miller_loop(twist(q), cast_g1(p)) (tests/test_pairing_fast.py).
# ---------------------------------------------------------------------------

from .field import (  # noqa: E402  (grouped with their use site)
    fq2_inv,
    fq2_mul,
    fq2_mul_scalar,
    fq2_neg,
    fq2_square,
    fq2_sub,
)


def _fq12_from_fq2(e, k: int) -> FQ12:
    """E(e)·w^k for e = (e0, e1) in Fq2, matching twist()'s embedding:
    positions k and k+6 carry (e0 - 9·e1, e1)."""
    coeffs = [0] * 12
    coeffs[k] = (e[0] - 9 * e[1]) % Q
    coeffs[k + 6] = e[1]
    return FQ12(coeffs)


def _fq2_from_fq12(f: FQ12, k: int):
    """Inverse of _fq12_from_fq2 for values supported on {k, k+6}."""
    e1 = f.coeffs[k + 6]
    return ((f.coeffs[k] + 9 * e1) % Q, e1)


def _frob_twisted(pt, j: int):
    """pi^j on a twisted point held as Fq2 components: embed, apply the
    linear Frobenius map, decompose (the w^2/w^3 subspaces are stable)."""
    x, y = pt
    return (
        _fq2_from_fq12(frobenius(_fq12_from_fq2(x, 2), j), 2),
        _fq2_from_fq12(frobenius(_fq12_from_fq2(y, 3), j), 3),
    )


def _line_with_slope(s, x1, y1, xp: int, yp: int):
    """Sparse coefficients of the line of slope s through twisted (x1, y1)
    evaluated at the G1 point (xp, yp):
    line = s·w·xp - E(s·x1)·w^3 - yp + E(y1)·w^3 (the FQ12 slope is s·w:
    dy in w^3, dx in w^2)."""
    sxp = fq2_mul_scalar(s, xp)
    t = fq2_sub(y1, fq2_mul(s, x1))
    return (
        (0, (-yp) % Q),
        (1, (sxp[0] - 9 * sxp[1]) % Q),
        (7, sxp[1]),
        (3, (t[0] - 9 * t[1]) % Q),
        (9, t[1]),
    )


def _dbl_step(p, xp: int, yp: int):
    """(tangent line items at p, [2]p) — the slope's Fq2 inversion is
    computed once and shared by both."""
    x, y = p
    s = fq2_mul(
        fq2_mul_scalar(fq2_square(x), 3), fq2_inv(fq2_mul_scalar(y, 2))
    )
    x3 = fq2_sub(fq2_square(s), fq2_mul_scalar(x, 2))
    p3 = (x3, fq2_sub(fq2_mul(s, fq2_sub(x, x3)), y))
    return _line_with_slope(s, x, y, xp, yp), p3


def _add_step(p1, p2, xp: int, yp: int):
    """(line items through p1, p2; p1 + p2), sharing one slope inversion.
    p1 != ±p2 is guaranteed in the ate loop (r is never ±q mid-loop for
    r-torsion inputs); the vertical case is kept for completeness."""
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return _dbl_step(p1, xp, yp)
    if x1 == x2:
        nx = fq2_neg(x1)
        items = ((0, xp % Q), (2, (nx[0] - 9 * nx[1]) % Q), (8, nx[1]))
        return items, None
    s = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_square(s), x1), x2)
    p3 = (x3, fq2_sub(fq2_mul(s, fq2_sub(x1, x3)), y1))
    return _line_with_slope(s, x1, y1, xp, yp), p3


def miller_loop_fq2(g2_pt, g1_pt) -> FQ12:
    """Miller loop over raw affine inputs (G2 as ((x0,x1),(y0,y1)) Fq2
    pairs, G1 as (x, y) ints) — same value as
    miller_loop(twist(g2_pt), cast_g1(g1_pt))."""
    if g2_pt is None or g1_pt is None:
        return FQ12.one()
    q = (tuple(g2_pt[0]), tuple(g2_pt[1]))
    xp, yp = g1_pt
    r = q
    f = FQ12.one()
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        items, r = _dbl_step(r, xp, yp)
        f = f.square().mul_sparse(items)
        if ATE_LOOP_COUNT & (1 << i):
            items, r = _add_step(r, q, xp, yp)
            f = f.mul_sparse(items)
    q1 = _frob_twisted(q, 1)
    q2 = _frob_twisted(q1, 1)
    nq2 = (q2[0], fq2_neg(q2[1]))
    items, r = _add_step(r, q1, xp, yp)
    f = f.mul_sparse(items)
    items, _ = _add_step(r, nq2, xp, yp)
    return f.mul_sparse(items)


def pairing(g2_pt, g1_pt) -> FQ12:
    """Full reduced pairing e(g1_pt, g2_pt) (args: G2 affine, G1 affine)."""
    return final_exponentiate(miller_loop_fq2(g2_pt, g1_pt))


def multi_pairing(pairs) -> FQ12:
    """Product of pairings e(P_i, Q_i) over (g1, g2) pairs with ONE final exp."""
    f = FQ12.one()
    for g1_pt, g2_pt in pairs:
        if g1_pt is None or g2_pt is None:
            continue
        f = f * miller_loop_fq2(g2_pt, g1_pt)
    return final_exponentiate(f)
