"""Point kernels of the MSM (csrc/curve_kernels.cu) with their plain
PyTorch versions.

  point_add        K6/K7  elementwise P + Q, general or mixed (Q affine)
  point_tile_scan  K8     within-tile segmented inclusive scan of points,
                          mixed leaf form or general
  proof_fold       K10    the proof's A, B2, C from the five MSMs' window
                          sums: Horner folds and the r/s algebra, one launch

Points are (n, 3, 8) G1 or (n, 3, 2, 8) G2 Montgomery words (ops/curve.py).
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Each launch adds one to LAUNCHES[name].
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import _build
from ..constants import R_SCALAR
from . import curve as cv
from . import field as fl
from . import limbs as limb_codec

LAUNCHES = {"point_add_g1": 0, "point_add_g2": 0, "tile_scan_g1": 0, "tile_scan_g2": 0,
            "proof_fold": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def is_g2(p: torch.Tensor) -> bool:
    if p.shape[-3:] == (3, 2, 8):
        return True
    if p.shape[-2:] == (3, 8):
        return False
    raise ValueError(f"not a point tensor: {tuple(p.shape)}")


def _check(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("points must be contiguous, 16-byte aligned int32 words")
        if t.device != tensors[0].device:
            raise ValueError(f"tensors on {tensors[0].device} and {t.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _elem_dims(g2: bool) -> int:
    return 3 if g2 else 2


def point_add_plain(p: torch.Tensor, q: torch.Tensor, mixed: bool = False) -> torch.Tensor:
    F = cv.field_ops(is_g2(p))
    fn = cv.proj_madd if mixed else cv.proj_add
    return fl.limbs_to_words(fn(F, fl.words_to_limbs(p), fl.words_to_limbs(q)))


def point_add(p: torch.Tensor, q: torch.Tensor, mixed: bool = False) -> torch.Tensor:
    """p + q elementwise over leading dims; mixed=True requires q affine-
    encoded (Z = one, or the identity)."""
    g2 = is_g2(p)
    if q.shape != p.shape:
        raise ValueError(f"shapes {tuple(p.shape)} and {tuple(q.shape)}")
    _check(p, q)
    if _build.runs_plain(p):
        return point_add_plain(p, q, mixed)
    out = torch.empty_like(p)
    n = p.numel() // (48 if g2 else 24)
    with torch.cuda.device(p.device):
        rc = _build.lib("curve_kernels").ccf_point_add(
            int(g2), int(mixed), p.data_ptr(), q.data_ptr(), out.data_ptr(), n, _stream(p))
    _build.check(rc, "point_add")
    LAUNCHES["point_add_g2" if g2 else "point_add_g1"] += 1
    return out


def point_tile_scan_plain(vt: torch.Tensor, ft: torch.Tensor, mixed: bool = False):
    g2 = is_g2(vt)
    F = cv.field_ops(g2)
    fn = cv.proj_madd if mixed else cv.proj_add
    T, K = ft.shape
    out = torch.empty_like(vt)
    acc = fl.words_to_limbs(cv.proj_identity_const(g2, vt.device)).expand(
        (T,) + vt.shape[2:-1] + (16,))
    fmask = ft.reshape(T, K, *([1] * _elem_dims(g2)))
    for k in range(K):
        x = fl.words_to_limbs(vt[:, k])
        acc = torch.where(fmask[:, k], x, fn(F, acc, x))
        out[:, k] = fl.limbs_to_words(acc)
    return out, fl.limbs_to_words(acc)


def point_tile_scan(vt: torch.Tensor, ft: torch.Tensor, mixed: bool = False):
    """vt (T, K, *point), ft (T, K) bool -> (out (T, K, *point), carry
    (T, *point)): out[t, k] = ft[t, k] ? vt[t, k] : out[t, k-1] + vt[t, k],
    the sum starting from the identity. mixed=True: every vt[t, k] is
    affine-encoded."""
    g2 = is_g2(vt)
    _check(vt)
    if ft.dtype != torch.bool or ft.shape != vt.shape[:2] or ft.device != vt.device:
        raise ValueError("flags must be a (T, K) bool tensor beside the values")
    if _build.runs_plain(vt):
        return point_tile_scan_plain(vt, ft, mixed)
    T, K = ft.shape
    ft = ft.contiguous()
    out = torch.empty_like(vt)
    carry = torch.empty((T,) + vt.shape[2:], dtype=torch.int32, device=vt.device)
    with torch.cuda.device(vt.device):
        rc = _build.lib("curve_kernels").ccf_point_tile_scan(
            int(g2), int(mixed), vt.data_ptr(), ft.data_ptr(), out.data_ptr(),
            carry.data_ptr(), T, K, _stream(vt))
    _build.check(rc, "point_tile_scan")
    LAUNCHES["tile_scan_g2" if g2 else "tile_scan_g1"] += 1
    return out, carry


LADDER_BITS = 4  # K10's scalar digits (kLadderBits)


def point_double_plain(p: torch.Tensor) -> torch.Tensor:
    """2P elementwise (cv.proj_double), the doubling of K10."""
    F = cv.field_ops(is_g2(p))
    return fl.limbs_to_words(cv.proj_double(F, fl.words_to_limbs(p)))


def _horner_plain(sums: torch.Tensor, c: int) -> torch.Tensor:
    """(n, W, *point) -> (n, *point): sum_w 2^(c w) sums[:, w], most
    significant window first."""
    acc = sums[:, -1]
    for w in reversed(range(sums.shape[1] - 1)):
        for _ in range(c):
            acc = point_double_plain(acc)
        acc = point_add_plain(acc, sums[:, w])
    return acc


def _ladder_digits(scalars: Sequence[int]) -> int:
    """LADDER_BITS-bit digits of the largest scalar."""
    return -(-max(scalars).bit_length() // LADDER_BITS)


def _ladder_plain(p: torch.Tensor, scalars: Sequence[int]) -> torch.Tensor:
    """(n, *point) lanes times n scalars, by windows over the largest
    scalar's digits: a table of j P (j < 2^LADDER_BITS), then a digit at a
    time LADDER_BITS doublings and one add. Row j of the table is 2 T[j/2]
    (j even) or T[(j+1)/2] + T[(j-1)/2], computed here a level at a time
    (rows a .. 2a-2 read rows below a only)."""
    rows = 1 << LADDER_BITS
    table = torch.empty((p.shape[0], rows) + p.shape[1:], dtype=torch.int32, device=p.device)
    table[:, 0] = cv.proj_identity_const(is_g2(p), p.device)
    table[:, 1] = p
    a = 2
    while a < rows:
        b = min(2 * a - 1, rows)
        even, odd = list(range(a + a % 2, b, 2)), list(range(a + 1 - a % 2, b, 2))
        table[:, even] = point_double_plain(table[:, [j // 2 for j in even]])
        if odd:
            table[:, odd] = point_add_plain(table[:, [(j + 1) // 2 for j in odd]],
                                            table[:, [(j - 1) // 2 for j in odd]])
        a = b
    nd = _ladder_digits(scalars)
    if nd == 0:
        return table[:, 0]
    lanes = torch.arange(p.shape[0], device=p.device)

    def row(i):
        return table[lanes, [(k >> (LADDER_BITS * i)) & (rows - 1) for k in scalars]]

    acc = row(nd - 1)
    for i in reversed(range(nd - 1)):
        for _ in range(LADDER_BITS):
            acc = point_double_plain(acc)
        acc = point_add_plain(acc, row(i))
    return acc


def proof_scalars(r: int, s: int) -> list:
    """K10's scalars: r, s and rs, reduced mod the group order."""
    return [r % R_SCALAR, s % R_SCALAR, r * s % R_SCALAR]


def proof_fold_plain(g1_sums, g2_sums, g1_fixed, g2_fixed, r: int, s: int,
                     window_bits: int) -> torch.Tensor:
    """K10's plain version: its operations in its order, its lanes as a
    batch dimension."""
    kr, ks, krs = proof_scalars(r, s)
    fold1 = _horner_plain(g1_sums, window_bits)  # A_msm, B1_msm, L, H
    lad1 = _ladder_plain(g1_fixed[2].expand(3, 3, 8), [kr, ks, krs])  # r, s, rs delta1
    y = fl.words_to_limbs(lad1[2, 1])
    neg = torch.stack((lad1[2, 0], fl.limbs_to_words(fl.sub_lazy(fl.FQ, torch.zeros_like(y), y)),
                       lad1[2, 2]))
    # A, B1 and L + H - rs delta1, two adds each
    part = point_add_plain(fold1[:3], torch.stack((g1_fixed[0], g1_fixed[1], fold1[3])))
    part = point_add_plain(part, torch.stack((lad1[0], lad1[1], neg)))
    sa_rb = _ladder_plain(part[:2], [ks, kr])  # s A, r B1
    c = point_add_plain(point_add_plain(part[2], sa_rb[0]), sa_rb[1])
    b2 = point_add_plain(_horner_plain(g2_sums[None], window_bits)[0], g2_fixed[0])
    b2 = point_add_plain(b2, _ladder_plain(g2_fixed[1:], [ks])[0])
    return torch.cat((part[0].reshape(-1), b2.reshape(-1), c.reshape(-1)))


def proof_fold(g1_sums: torch.Tensor, g2_sums: torch.Tensor, g1_fixed: torch.Tensor,
               g2_fixed: torch.Tensor, r: int, s: int, window_bits: int) -> torch.Tensor:
    """The proof's points from the window sums of its five MSMs: g1_sums
    (4, W, 3, 8) [A, B1, L, H], g2_sums (W, 3, 2, 8) [B2], window w
    weighted 2^(window_bits w); g1_fixed (3, 3, 8) [alpha1, beta1, delta1],
    g2_fixed (2, 3, 2, 8) [beta2, delta2], projective. Returns (96,)
    projective words [A (3, 8), B2 (3, 2, 8), C (3, 8)] (proof_points
    splits them) with
      A = A_msm + alpha1 + r delta1,  B1 = B1_msm + beta1 + s delta1,
      B2 = B2_msm + beta2 + s delta2, C = L + H + s A + r B1 - rs delta1."""
    W = g2_sums.shape[0]
    if (tuple(g1_sums.shape) != (4, W, 3, 8) or tuple(g2_sums.shape) != (W, 3, 2, 8)
            or tuple(g1_fixed.shape) != (3, 3, 8) or tuple(g2_fixed.shape) != (2, 3, 2, 8)
            or W == 0):
        raise ValueError(f"window sums (4, W, 3, 8), (W, 3, 2, 8) and key points (3, 3, 8), "
                         f"(2, 3, 2, 8), not {tuple(g1_sums.shape)}, {tuple(g2_sums.shape)}, "
                         f"{tuple(g1_fixed.shape)}, {tuple(g2_fixed.shape)}")
    g1_sums, g2_sums = g1_sums.contiguous(), g2_sums.contiguous()
    _check(g1_sums, g2_sums, g1_fixed, g2_fixed)
    if _build.runs_plain(g1_sums):
        return proof_fold_plain(g1_sums, g2_sums, g1_fixed, g2_fixed, r, s, window_bits)
    scalars = limb_codec.ints_to_words(proof_scalars(r, s))
    out = torch.empty(96, dtype=torch.int32, device=g1_sums.device)
    with torch.cuda.device(g1_sums.device):
        rc = _build.lib("curve_kernels").ccf_proof_fold(
            g1_sums.data_ptr(), g2_sums.data_ptr(), g1_fixed.data_ptr(), g2_fixed.data_ptr(),
            scalars.ctypes.data, W, window_bits, out.data_ptr(), _stream(g1_sums))
    _build.check(rc, "proof_fold")
    LAUNCHES["proof_fold"] += 1
    return out


def proof_points(words: torch.Tensor):
    """proof_fold's (96,) words -> A (3, 8), B2 (3, 2, 8), C (3, 8)."""
    return words[:24].reshape(3, 8), words[24:72].reshape(3, 2, 8), words[72:].reshape(3, 8)


def _entry_resources(report: dict, prefix: str) -> dict:
    return {group: {mode: report[f"{prefix}_{group}_{mode}"] for mode in ("madd", "add")}
            for group in ("g1", "g2")}


def tile_scan_resources(report: dict) -> dict:
    """{"g1"|"g2": {"madd"|"add": ptxas row}} of the four point_tile_scan
    entry kernels (csrc/curve_kernels.cu, ccf_tile_scan_<group>_<mode>) in a
    ptxas report (_build.ptxas_report); raises if one is missing."""
    return _entry_resources(report, "ccf_tile_scan")


def point_add_resources(report: dict) -> dict:
    """The same for the four point_add entry kernels
    (ccf_point_add_<group>_<mode>)."""
    return _entry_resources(report, "ccf_point_add")
