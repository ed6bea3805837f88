"""BN254 G1/G2 points on the card: codecs and the plain complete group law.

Points are homogeneous projective (X, Y, Z) in one tensor of Montgomery
words: G1 (..., 3, 8), G2 (..., 3, 2, 8) with Fq2 coefficients (c0, c1).
The identity is (0, 1, 0). Affine query points come in the zkey's form,
G1 (..., 2, 8) and G2 (..., 2, 2, 8), with all-zero rows for infinity.

proj_add / proj_madd / proj_double are the complete Renes-Costello-Batina
formulas (algorithms 7, 8 and 9 for a = 0): 12M + 2 mul_b3, 11M + 2 mul_b3
and 6M + 2S + mul_b3, with no case split, valid for doubling, the identity
and P + (-P). mul_b3 is x -> 3b x: 9x by an add chain on G1, and the
constant 3b' = 9/(9+u) on the G2 twist. They run on 16-bit limbs in int64
(ops/field.py) with lazy reduction and are the plain versions of
csrc/curve_kernels.cu, which performs the same operations in the same
order.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..constants import Q
from ..refmath import field as rf
from . import field as fl
from . import limbs as limb_codec

FQ = fl.FQ


def _b3_g2() -> tuple:
    """3b' for y^2 = x^3 + 3/(9+u): 9/(9+u) = (81 - 9u)/82, Montgomery
    (c0, c1), and c0 + c1 reduced mod q (the Karatsuba sum)."""
    inv82 = pow(82, -1, Q)
    c0 = (81 * inv82 % Q) * (1 << 256) % Q
    c1 = ((-9 * inv82) % Q) * (1 << 256) % Q
    return c0, c1, (c0 + c1) % Q


B3_G2 = _b3_g2()


class _FqOps:
    """Lazy Fq on (..., 16) limbs."""

    coord = ()

    @staticmethod
    def add(a, b):
        return fl.add_lazy(FQ, a, b)

    @staticmethod
    def sub(a, b):
        return fl.sub_lazy(FQ, a, b)

    @staticmethod
    def mul(a, b):
        return fl.mont_mul_lazy(FQ, a, b)

    @classmethod
    def mul_b3(cls, a):
        x2 = cls.add(a, a)
        x4 = cls.add(x2, x2)
        x8 = cls.add(x4, x4)
        return cls.add(x8, a)


class _Fq2Ops:
    """Lazy Fq2 on (..., 2, 16) limbs; add/sub act per coefficient."""

    coord = (2,)
    add = _FqOps.add
    sub = _FqOps.sub

    @staticmethod
    def mul(a, b):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        v0 = _FqOps.mul(a0, b0)
        v1 = _FqOps.mul(a1, b1)
        s = _FqOps.mul(_FqOps.add(a0, a1), _FqOps.add(b0, b1))
        return torch.stack((_FqOps.sub(v0, v1), _FqOps.sub(_FqOps.sub(s, v0), v1)), dim=-2)

    @staticmethod
    def mul_b3(a):
        c0, c1, cs = (FQ.limbs(c, a.device) for c in B3_G2)
        a0, a1 = a[..., 0, :], a[..., 1, :]
        v0 = _FqOps.mul(c0, a0)
        v1 = _FqOps.mul(c1, a1)
        s = _FqOps.mul(cs, _FqOps.add(a0, a1))
        return torch.stack((_FqOps.sub(v0, v1), _FqOps.sub(_FqOps.sub(s, v0), v1)), dim=-2)


def field_ops(g2: bool):
    return _Fq2Ops if g2 else _FqOps


def _xyz(p, F):
    axis = -2 - len(F.coord)
    return p.select(axis, 0), p.select(axis, 1), p.select(axis, 2)


def _join(F, x, y, z):
    return torch.stack((x, y, z), dim=-2 - len(F.coord))


def proj_add(F, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P + Q on limb points (RCB algorithm 7, a = 0)."""
    X1, Y1, Z1 = _xyz(p, F)
    X2, Y2, Z2 = _xyz(q, F)
    t0 = F.mul(X1, X2)
    t1 = F.mul(Y1, Y2)
    t2 = F.mul(Z1, Z2)
    t3 = F.mul(F.add(X1, Y1), F.add(X2, Y2))
    t3 = F.sub(t3, F.add(t0, t1))
    t4 = F.mul(F.add(Y1, Z1), F.add(Y2, Z2))
    t4 = F.sub(t4, F.add(t1, t2))
    Y3 = F.mul(F.add(X1, Z1), F.add(X2, Z2))
    Y3 = F.sub(Y3, F.add(t0, t2))
    t0 = F.add(F.add(t0, t0), t0)
    t2 = F.mul_b3(t2)
    Z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    Y3 = F.mul_b3(Y3)
    X3 = F.sub(F.mul(t3, t1), F.mul(t4, Y3))
    Y3 = F.add(F.mul(t1, Z3), F.mul(Y3, t0))
    Z3 = F.add(F.mul(Z3, t4), F.mul(t0, t3))
    return _join(F, X3, Y3, Z3)


def proj_double(F, p: torch.Tensor) -> torch.Tensor:
    """2P on limb points (RCB algorithm 9, a = 0): 6M + 2S + mul_b3, complete
    like proj_add."""
    X, Y, Z = _xyz(p, F)
    t0 = F.mul(Y, Y)
    Z3 = F.add(t0, t0)
    Z3 = F.add(Z3, Z3)
    Z3 = F.add(Z3, Z3)
    t1 = F.mul(Y, Z)
    t2 = F.mul_b3(F.mul(Z, Z))
    X3 = F.mul(t2, Z3)
    Y3 = F.add(t0, t2)
    xy = F.mul(X, Y)
    Z3 = F.mul(t1, Z3)
    t2 = F.add(F.add(t2, t2), t2)
    t0 = F.sub(t0, t2)
    Y3 = F.add(X3, F.mul(t0, Y3))
    t1 = F.mul(t0, xy)
    return _join(F, F.add(t1, t1), Y3, Z3)


def proj_madd(F, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P + Q with Q affine-encoded (Z2 = one, or the identity with Z2 = 0):
    RCB algorithm 8 plus one select for Q at infinity."""
    X1, Y1, Z1 = _xyz(p, F)
    X2, Y2, Z2 = _xyz(q, F)
    t0 = F.mul(X1, X2)
    t1 = F.mul(Y1, Y2)
    t3 = F.mul(F.add(X2, Y2), F.add(X1, Y1))
    t3 = F.sub(t3, F.add(t0, t1))
    t4 = F.add(F.mul(Y2, Z1), Y1)
    Y3 = F.add(F.mul(X2, Z1), X1)
    t0 = F.add(F.add(t0, t0), t0)
    t2 = F.mul_b3(Z1)
    Z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    Y3 = F.mul_b3(Y3)
    X3 = F.sub(F.mul(t3, t1), F.mul(t4, Y3))
    Y3 = F.add(F.mul(t1, Z3), F.mul(Y3, t0))
    Z3 = F.add(F.mul(Z3, t4), F.mul(t0, t3))
    q_inf = (Z2 == 0).flatten(start_dim=Z2.dim() - 1 - len(F.coord)).all(-1)
    q_inf = q_inf.reshape(q_inf.shape + (1,) * (2 + len(F.coord)))
    return torch.where(q_inf, p, _join(F, X3, Y3, Z3))


# ---------------------------------------------------------------------------
# Codecs (words)
# ---------------------------------------------------------------------------


def _one_words(g2: bool, device) -> torch.Tensor:
    one = FQ.const_words(FQ.one_mont, device)
    if g2:
        return torch.stack((one, torch.zeros_like(one)))
    return one


def proj_identity_const(g2: bool, device=None) -> torch.Tensor:
    """(0, 1, 0) as one point: (3, 8) for G1, (3, 2, 8) for G2."""
    one = _one_words(g2, device)
    zero = torch.zeros_like(one)
    return torch.stack((zero, one, zero))


def affine_to_proj(xy: torch.Tensor, g2: bool) -> torch.Tensor:
    """(..., 2, *coord, 8) affine Montgomery words -> (..., 3, *coord, 8)
    projective; all-zero rows (zkey infinity) map to (0, 1, 0)."""
    cdims = 2 if g2 else 1
    x, y = xy.select(-1 - cdims, 0), xy.select(-1 - cdims, 1)
    inf = (xy == 0).flatten(start_dim=xy.dim() - 1 - cdims).all(-1)
    inf = inf.reshape(inf.shape + (1,) * cdims)
    one = _one_words(g2, xy.device).expand_as(x)
    z = torch.where(inf, torch.zeros_like(x), one)
    y = torch.where(inf, one, y)
    return torch.stack((x, y, z), dim=-1 - cdims)


def decode_g1_proj(points) -> List[Optional[tuple]]:
    """(..., 3, 8) projective words -> canonical affine (x, y) ints or None."""
    arr = np.asarray(points.cpu() if isinstance(points, torch.Tensor) else points)
    vals = limb_codec.words_to_ints(arr.reshape(-1, 3, 8))
    rinv = pow(1 << 256, -1, Q)
    out = []
    for X, Y, Z in vals:
        z = Z * rinv % Q
        if z == 0:
            out.append(None)
            continue
        zinv = pow(z, -1, Q)
        out.append((X * rinv % Q * zinv % Q, Y * rinv % Q * zinv % Q))
    return out


def decode_g2_proj(points) -> list:
    """(..., 3, 2, 8) projective words -> canonical affine G2 or None."""
    arr = np.asarray(points.cpu() if isinstance(points, torch.Tensor) else points)
    vals = limb_codec.words_to_ints(arr.reshape(-1, 3, 2, 8))
    rinv = pow(1 << 256, -1, Q)
    out = []
    for X, Y, Z in vals:
        x, y, z = ((c0 * rinv % Q, c1 * rinv % Q) for c0, c1 in (X, Y, Z))
        if z == (0, 0):
            out.append(None)
            continue
        zinv = rf.fq2_inv(z)
        out.append((rf.fq2_mul(x, zinv), rf.fq2_mul(y, zinv)))
    return out


def encode_g1_affine(points) -> np.ndarray:
    """Canonical affine G1 [(x, y) | None] -> (N, 2, 8) Montgomery words."""
    vals = []
    for p in points:
        vals += [0, 0] if p is None else [(p[0] << 256) % Q, (p[1] << 256) % Q]
    return limb_codec.ints_to_words(vals).reshape(len(points), 2, 8)


def encode_g2_affine(points) -> np.ndarray:
    """Canonical affine G2 -> (N, 2, 2, 8) Montgomery words."""
    vals = []
    for p in points:
        if p is None:
            vals += [0, 0, 0, 0]
        else:
            (x0, x1), (y0, y1) = p
            vals += [(v << 256) % Q for v in (x0, x1, y0, y1)]
    return limb_codec.ints_to_words(vals).reshape(len(points), 2, 2, 8)
