"""Point kernels of the MSM (csrc/curve_kernels.cu) with their plain
PyTorch versions.

  point_add        K6/K7  elementwise P + Q, general or mixed (Q affine)
  point_tile_scan  K8     within-tile segmented inclusive scan of points,
                          mixed leaf form or general

Points are (n, 3, 8) G1 or (n, 3, 2, 8) G2 Montgomery words (ops/curve.py).
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Each launch adds one to LAUNCHES[name].
"""

from __future__ import annotations

import torch

from .. import _build
from . import curve as cv
from . import field as fl

LAUNCHES = {"point_add_g1": 0, "point_add_g2": 0, "tile_scan_g1": 0, "tile_scan_g2": 0}


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
