"""Fixed-base point generation, one scalar's multiple of many points, and
batch projective -> affine conversion on the card, for the trusted setup
(models/setup.py) and the phase-2 ceremony (circom/contribute.py).

The setup computes about 5 n_vars generator multiples (G1 * s_i and
G2 * s_i for the QAP evaluations of every variable). The windowed
fixed-base method does them on the card:

  host:  table T[w][d] = G * (d << (8 w)), 32 windows x 256 affine points,
         built once per group and staged once per device;
  card:  out_i = sum_w T[w][digit_w(s_i)], a gather of table rows and one
         mixed point add (point_add, K6/K7) per window over all scalars.

The ceremony multiplies every point of a query section by one host scalar
k (scalar_mul_const): MSB-first double-and-add over the whole section, the
doubling a general point_add of the running sum with itself (the complete
formulas double), the add a mixed point_add only where a bit of k is one,
so about bit_length(k) + popcount(k) launches and no select.

The projective sums become the zkey's affine Montgomery coordinates through
Montgomery's batch inversion: prefix and suffix product scans (Hillis-
Steele passes of the Fq binary kernel) and one host inversion for the whole
batch. Every Fq step is a fr_binary launch over Fq (K1's Fq mode); G2's
Fq2 products are composed from them in the operation order of ops/curve.py.
The copy of circom_compat_tpu/ops/fixed_base.py.

point_add outputs are lazy [0, 2p). Every value is made canonical before
a zero test, a negation or an encoding (the JAX package's round-2 bug fed
lazy coordinates to canonical-only ops and corrupted about half the G2 rows
of a device setup), and an all-zero Z (infinity) becomes an all-zero
affine row.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..constants import Q, R_SCALAR
from ..device import resolve_device
from ..refmath import curve as rc
from . import curve as cv
from . import curve_kernels as ck
from . import field as fl
from . import field_kernels as fk
from . import msm as msm_ops
from . import segments

WINDOW = 8
N_WINDOWS = -(-msm_ops.SCALAR_BITS // WINDOW)
CHUNK = 1 << 19

_HOST_TABLES: Dict[bool, np.ndarray] = {}
_STAGED: Dict[tuple, torch.Tensor] = {}


# ---------------------------------------------------------------------------
# Field helpers over (..., 8) Montgomery words
# ---------------------------------------------------------------------------


def _one(F: fl.FieldSpec, device) -> torch.Tensor:
    return F.words(F.one_mont, device)


def fq(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One Fq binary pass (K1's Fq mode); b may be one (8,) element."""
    return fk.fr_binary(op, a.contiguous(), b.contiguous(), fl.FQ)


def canon(x: torch.Tensor, F: fl.FieldSpec = fl.FQ) -> torch.Tensor:
    """Lazy [0, 2p) Montgomery words -> canonical (< p): a fully reduced
    multiply by the Montgomery one."""
    return fk.fr_binary("mul_canon", x.contiguous(), _one(F, x.device), F)


def fq2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 2, 8) Fq2 product, Karatsuba as ops/curve.py's _Fq2Ops.mul."""
    a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
    v0 = fq("mul", a0, b0)
    v1 = fq("mul", a1, b1)
    s = fq("mul", fq("add", a0, a1), fq("add", b0, b1))
    return torch.stack((fq("sub", v0, v1), fq("sub", fq("sub", s, v0), v1)), dim=-2)


def prefix_products(v: torch.Tensor, F: fl.FieldSpec) -> torch.Tensor:
    """Inclusive product scan of (n, 8) Montgomery words: ceil(log2 n)
    Hillis-Steele passes of the binary kernel."""
    n = v.shape[0]
    flags = torch.zeros(n, dtype=torch.bool, device=v.device)
    flags[:1] = True
    return segments.hillis_steele(lambda x, y: fk.fr_binary("mul", x, y, F), v, flags,
                                  _one(F, v.device))


def suffix_products(v: torch.Tensor, F: fl.FieldSpec) -> torch.Tensor:
    return prefix_products(v.flip(0).contiguous(), F).flip(0).contiguous()


def inv_from_scans(pre: torch.Tensor, suf: torch.Tensor, total_inv: int,
                   F: fl.FieldSpec) -> torch.Tensor:
    """Montgomery's trick: inv_i = P_{i-1} * S_{i+1} / (P_{n-1}), lazy."""
    one = _one(F, pre.device)[None]
    p_shift = torch.cat((one, pre[:-1]))
    s_shift = torch.cat((suf[1:], one))
    tinv = F.words(total_inv * (1 << 256) % F.modulus, pre.device)
    return fk.fr_binary("mul", fk.fr_binary("mul", p_shift, s_shift, F), tinv, F)


def batch_inv_fq(vals: torch.Tensor) -> torch.Tensor:
    """(n, 8) canonical Montgomery Fq -> inverses (lazy); zero rows map to
    zero. One host inversion for the whole batch."""
    zmask = (vals == 0).all(-1, keepdim=True)
    v = torch.where(zmask, _one(fl.FQ, vals.device), vals).contiguous()
    pre = prefix_products(v, fl.FQ)
    suf = suffix_products(v, fl.FQ)
    total = fl.decode(pre[-1:], fl.FQ)[0]
    inv = inv_from_scans(pre, suf, pow(total, -1, Q), fl.FQ)
    return torch.where(zmask, torch.zeros_like(inv), inv)


# ---------------------------------------------------------------------------
# Projective -> affine
# ---------------------------------------------------------------------------


def g1_proj_to_affine(points: torch.Tensor) -> torch.Tensor:
    """(n, 3, 8) projective G1 (lazy coordinates accepted) -> (n, 2, 8)
    canonical affine Montgomery words, all-zero rows for infinity."""
    X, Y, Z = (canon(points[:, i]) for i in range(3))
    zinv = batch_inv_fq(Z)
    xy = torch.stack((fq("mul_canon", X, zinv), fq("mul_canon", Y, zinv)), dim=1)
    inf = (Z == 0).all(-1)[:, None, None]
    return torch.where(inf, torch.zeros_like(xy), xy)


def g2_proj_to_affine(points: torch.Tensor) -> torch.Tensor:
    """(n, 3, 2, 8) projective G2 (lazy coordinates accepted) -> (n, 2, 2, 8)
    canonical affine words. 1/(z0 + z1 u) = (z0 - z1 u) / (z0^2 + z1^2),
    the Fq norms batch-inverted in one pass."""
    X, Y, Z = (canon(points[:, i]) for i in range(3))
    z0, z1 = Z[:, 0], Z[:, 1]
    norm = canon(fq("add", fq("mul", z0, z0), fq("mul", z1, z1)))
    ninv = batch_inv_fq(norm)
    neg_z1 = fq("sub", torch.zeros_like(z1), z1)
    zinv = torch.stack((fq("mul", z0, ninv), fq("mul", neg_z1, ninv)), dim=1)
    xy = torch.stack((canon(fq2_mul(X, zinv)), canon(fq2_mul(Y, zinv))), dim=1)
    inf = (Z == 0).flatten(1).all(-1)[:, None, None, None]
    return torch.where(inf, torch.zeros_like(xy), xy)


def scalar_mul_const(points: torch.Tensor, k: int) -> torch.Tensor:
    """k * P for every point of (n, 3, 8) G1 or (n, 3, 2, 8) G2 words that
    are affine-encoded (Z one, or the identity: cv.affine_to_proj), k a
    host int >= 0; projective (lazy) out. The counterpart of the JAX
    package's curve_jax.scalar_mul_const."""
    if k < 0:
        raise ValueError("scalar_mul_const takes k >= 0")
    g2 = ck.is_g2(points)
    if k == 0:
        ident = cv.proj_identity_const(g2, points.device)
        return ident.expand(points.shape).contiguous()
    points = points.contiguous()
    acc = points.clone()
    for bit in bin(k)[3:]:  # the top bit is the starting copy
        acc = ck.point_add(acc, acc)
        if bit == "1":
            acc = ck.point_add(acc, points, mixed=True)
    return acc


# ---------------------------------------------------------------------------
# Windowed fixed-base multiples of the generators
# ---------------------------------------------------------------------------


def _host_table(group, base) -> List[list]:
    """T[w][d] = base * (d << (WINDOW * w)), affine host points."""
    table = []
    row_base = base
    for _ in range(N_WINDOWS):
        row, acc = [None], None
        for _ in range(1, 1 << WINDOW):
            acc = group.add(acc, row_base)
            row.append(acc)
        table.append(row)
        for _ in range(WINDOW):
            row_base = group.double(row_base)
    return table


def table(g2: bool, device) -> torch.Tensor:
    """The (N_WINDOWS, 256, 2, *coord, 8) affine table of G1's or G2's
    generator on `device`."""
    if g2 not in _HOST_TABLES:
        group, gen = (rc.G2, rc.g2_generator()) if g2 else (rc.G1, rc.g1_generator())
        enc = cv.encode_g2_affine if g2 else cv.encode_g1_affine
        _HOST_TABLES[g2] = np.stack([enc(row) for row in _host_table(group, gen)])
    key = (g2, str(torch.device(device)))
    if key not in _STAGED:
        _STAGED[key] = torch.from_numpy(_HOST_TABLES[g2]).to(device)
    return _STAGED[key]


def fixed_base_points_from_words(scalars: torch.Tensor, g2: bool = False,
                                 chunk: int = CHUNK) -> torch.Tensor:
    """(m, 8) canonical plain Fr words -> [G * s] as (m, 2, *coord, 8)
    canonical affine Montgomery words on the scalars' device, in chunks."""
    dev = scalars.device
    tbl = table(g2, dev)
    to_affine = g2_proj_to_affine if g2 else g1_proj_to_affine
    ident = cv.proj_identity_const(g2, dev)
    out = []
    for start in range(0, scalars.shape[0], chunk):
        sc = scalars[start : start + chunk]
        digits = msm_ops.window_digits(sc, WINDOW)
        acc = ident.expand((sc.shape[0],) + ident.shape).contiguous()
        for w in range(N_WINDOWS):
            acc = ck.point_add(acc, cv.affine_to_proj(tbl[w][digits[w]], g2), mixed=True)
        out.append(to_affine(acc))
    if not out:
        return torch.zeros((0, 2) + ((2,) if g2 else ()) + (8,), dtype=torch.int32, device=dev)
    return torch.cat(out)


def fixed_base_points(scalars: List[int], g2: bool = False, device=None,
                      chunk: int = CHUNK) -> torch.Tensor:
    """[G * s for s in scalars] (Python ints, reduced mod r) as affine words,
    on the card unless device names another."""
    words = torch.from_numpy(fl.encode_plain([s % R_SCALAR for s in scalars])).to(
        resolve_device(device))
    return fixed_base_points_from_words(words, g2, chunk)
