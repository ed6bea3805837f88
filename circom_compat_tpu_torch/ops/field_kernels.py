"""Field kernels of the witness map and the setup (csrc/field_kernels.cu)
with their plain PyTorch versions.

  fr_binary           K1   elementwise mul (lazy or canonical), add, sub
                           mod 2p over Fr, or over Fq (field=fl.FQ, the
                           setup's affine conversion and on-curve check);
                           one operand optionally a single broadcast element
  fr_tile_scan        K2   within-tile segmented inclusive scan, lazy add
  ntt_rows            K3   all radix-2 stages of each row (low mode) with
                           fused pre-multiply and post-multiply / -subtract
                      K4   the four-step middle: DIF stages, x mid, DIT
  fr_butterfly_stage  K5a  one radix-2 stage (DIT or DIF) over the whole
                      K5b  vector: the flat NTT chain's high stages

Tensors are (..., 8) int32 words (ops/field.py). A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches the kernel
or raises. Each launch adds one to LAUNCHES[name] (fr_binary over Fq counts
as "f_binary_fq").
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import _build
from . import field as fl

LAUNCHES = {"fr_binary": 0, "f_binary_fq": 0, "fr_tile_scan": 0, "ntt_rows_low": 0,
            "ntt_rows_mid": 0, "fr_butterfly_stage": 0}

_OPS = {"mul": 0, "mul_canon": 1, "add": 2, "sub": 3}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(*tensors: Optional[torch.Tensor]) -> None:
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.dtype != torch.int32 or t.shape[-1] != 8 or not t.is_contiguous():
            raise ValueError(f"expected contiguous (..., 8) int32 words, got {t.dtype} {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError("field tensors must be 16-byte aligned")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K1 fr_binary
# ---------------------------------------------------------------------------


def fr_binary_plain(op: str, a: torch.Tensor, b: torch.Tensor,
                    field: fl.FieldSpec = fl.FR) -> torch.Tensor:
    x, y = fl.words_to_limbs(a), fl.words_to_limbs(b)
    fn = {"mul": fl.mont_mul_lazy, "mul_canon": fl.mont_mul,
          "add": fl.add_lazy, "sub": fl.sub_lazy}[op]
    return fl.limbs_to_words(fn(field, x, y))


def fr_binary(op: str, a: torch.Tensor, b: torch.Tensor,
              field: fl.FieldSpec = fl.FR) -> torch.Tensor:
    """a (..., 8); b the same shape, or one (8,) element broadcast to all.
    field: fl.FR (the witness map) or fl.FQ (point coordinates)."""
    _check(a, b)
    bcast = b.dim() == 1
    if not bcast and b.shape != a.shape:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if field not in (fl.FR, fl.FQ):
        raise ValueError(f"unknown field {field.name}")
    if _build.runs_plain(a):
        return fr_binary_plain(op, a, b, field)
    out = torch.empty_like(a)
    fq = field is fl.FQ
    with torch.cuda.device(a.device):
        rc = _build.lib("field_kernels").ccf_fr_binary(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel() // 8,
            _OPS[op], int(bcast), int(fq), _stream(a))
    _build.check(rc, "fr_binary")
    LAUNCHES["f_binary_fq" if fq else "fr_binary"] += 1
    return out


def fr_to_mont(x: torch.Tensor) -> torch.Tensor:
    """Plain canonical words -> Montgomery form (lazy)."""
    return fr_binary("mul", x, fl.FR.words(fl.FR.r2, x.device))


def fr_from_mont(x: torch.Tensor) -> torch.Tensor:
    """Montgomery (possibly lazy) -> plain CANONICAL words (< r): the form
    digit extraction and serialization need."""
    return fr_binary("mul_canon", x, fl.FR.words(1, x.device))


# ---------------------------------------------------------------------------
# K2 fr_tile_scan
# ---------------------------------------------------------------------------


def fr_tile_scan_plain(vt: torch.Tensor, ft: torch.Tensor):
    T, K = ft.shape
    out = torch.empty_like(vt)
    acc = torch.zeros((T, 16), dtype=torch.int64, device=vt.device)
    for k in range(K):
        x = fl.words_to_limbs(vt[:, k])
        acc = torch.where(ft[:, k : k + 1], x, fl.add_lazy(fl.FR, acc, x))
        out[:, k] = fl.limbs_to_words(acc)
    return out, fl.limbs_to_words(acc)


def fr_tile_scan(vt: torch.Tensor, ft: torch.Tensor):
    """vt (T, K, 8), ft (T, K) bool -> (out (T, K, 8), carry (T, 8)):
    out[t, k] = ft[t, k] ? vt[t, k] : out[t, k-1] + vt[t, k]."""
    _check(vt)
    if ft.dtype != torch.bool or ft.shape != vt.shape[:2] or ft.device != vt.device:
        raise ValueError("flags must be a (T, K) bool tensor beside the values")
    if _build.runs_plain(vt):
        return fr_tile_scan_plain(vt, ft)
    T, K = ft.shape
    ft = ft.contiguous()
    out = torch.empty_like(vt)
    carry = torch.empty((T, 8), dtype=torch.int32, device=vt.device)
    with torch.cuda.device(vt.device):
        rc = _build.lib("field_kernels").ccf_fr_tile_scan(
            vt.data_ptr(), ft.data_ptr(), out.data_ptr(), carry.data_ptr(), T, K,
            _stream(vt))
    _build.check(rc, "fr_tile_scan")
    LAUNCHES["fr_tile_scan"] += 1
    return out, carry


# ---------------------------------------------------------------------------
# K3 / K4 ntt_rows
# ---------------------------------------------------------------------------


def _stage_pairs(s: torch.Tensor, st: int):
    rows, L = s.shape[:2]
    half = 1 << st
    v = s.view(rows, L // (2 * half), 2, half, 16)
    return v[:, :, 0], v[:, :, 1]


def _stage_tw(tw: torch.Tensor, L: int, st: int) -> torch.Tensor:
    half = 1 << st
    idx = torch.arange(half, device=tw.device) * ((L // 2) >> st)
    return tw[idx]  # (half, 16), broadcast over rows and groups


def ntt_rows_plain(x, tw_dif=None, tw_dit=None, pre=None, mid=None, post=None,
                   post_op: str = "mul") -> torch.Tensor:
    F = fl.FR
    rows, L, _ = x.shape
    log_len = L.bit_length() - 1
    s = fl.words_to_limbs(x)
    if pre is not None:
        s = fl.mont_mul_lazy(F, fl.words_to_limbs(pre), s)
    if tw_dif is not None:
        tw = fl.words_to_limbs(tw_dif)
        for st in range(log_len - 1, -1, -1):
            u, v = _stage_pairs(s, st)
            w = _stage_tw(tw, L, st)
            s = torch.stack(
                (fl.add_lazy(F, u, v), fl.mont_mul_lazy(F, w, fl.sub_lazy(F, u, v))), dim=2
            ).reshape(rows, L, 16)
    if mid is not None:
        s = fl.mont_mul_lazy(F, fl.words_to_limbs(mid), s)
    if tw_dit is not None:
        tw = fl.words_to_limbs(tw_dit)
        for st in range(log_len):
            u, v = _stage_pairs(s, st)
            t = fl.mont_mul_lazy(F, _stage_tw(tw, L, st), v)
            s = torch.stack((fl.add_lazy(F, u, t), fl.sub_lazy(F, u, t)), dim=2).reshape(rows, L, 16)
    if post is not None:
        q = fl.words_to_limbs(post)
        s = fl.mont_mul_lazy(F, q, s) if post_op == "mul" else fl.sub_lazy(F, q, s)
    return fl.limbs_to_words(s)


def ntt_rows(x: torch.Tensor, tw_dif=None, tw_dit=None, pre=None, mid=None, post=None,
             post_op: str = "mul") -> torch.Tensor:
    """x (rows, L, 8), L a power of two; tw_* (L/2, 8) tables of the L-th
    root's powers; pre/mid/post (rows, L, 8). Runs: x *= pre; DIF stages
    (tw_dif, natural -> bit-reversed); x *= mid; DIT stages (tw_dit,
    bit-reversed -> natural); then x *= post, or x = post - x for
    post_op="sub". Without `mid` this is K3's low mode, with it K4's."""
    _check(x, tw_dif, tw_dit, pre, mid, post)
    if x.dim() != 3 or x.shape[1] & (x.shape[1] - 1):
        raise ValueError(f"expected (rows, 2^k, 8), got {tuple(x.shape)}")
    rows, L, _ = x.shape
    for t in (pre, mid, post):
        if t is not None and t.shape != x.shape:
            raise ValueError("pre/mid/post must have the shape of x")
    for t in (tw_dif, tw_dit):
        if t is not None and t.shape != (max(L // 2, 1), 8):
            raise ValueError(f"twiddle table must be ({L // 2}, 8)")
    if post_op not in ("mul", "sub"):
        raise ValueError(post_op)
    if _build.runs_plain(x):
        return ntt_rows_plain(x, tw_dif, tw_dit, pre, mid, post, post_op)
    if L > 4096:
        raise ValueError("ntt_rows keeps a row in shared memory: at most 4096 elements")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _build.lib("field_kernels").ccf_ntt_rows(
            x.data_ptr(), out.data_ptr(), _ptr(tw_dif), _ptr(tw_dit), _ptr(pre), _ptr(mid),
            _ptr(post), 0 if post_op == "mul" else 1, rows, L.bit_length() - 1, _stream(x))
    _build.check(rc, "ntt_rows")
    LAUNCHES["ntt_rows_mid" if mid is not None else "ntt_rows_low"] += 1
    return out


# ---------------------------------------------------------------------------
# K5a / K5b fr_butterfly_stage
# ---------------------------------------------------------------------------


def fr_butterfly_plain(u: torch.Tensor, v: torch.Tensor, tw: torch.Tensor, dif: bool):
    """Elementwise radix-2 butterfly over equally shaped (..., 8) words:
    DIT (u + tw v, u - tw v), DIF (u + v, (u - v) tw); lazy in and out."""
    F = fl.FR
    x, y, w = fl.words_to_limbs(u), fl.words_to_limbs(v), fl.words_to_limbs(tw)
    if dif:
        return (fl.limbs_to_words(fl.add_lazy(F, x, y)),
                fl.limbs_to_words(fl.mont_mul_lazy(F, w, fl.sub_lazy(F, x, y))))
    t = fl.mont_mul_lazy(F, w, y)
    return fl.limbs_to_words(fl.add_lazy(F, x, t)), fl.limbs_to_words(fl.sub_lazy(F, x, t))


def _stage_index(n: int, half: int, device):
    """(i0, twiddle index) of the n/2 butterflies of one stage."""
    j = torch.arange(n // 2, device=device)
    pos = j % half
    return (j // half) * (2 * half) + pos, pos * (n // 2 // half)


def fr_butterfly_stage_plain(x: torch.Tensor, table: torch.Tensor, half: int,
                             dif: bool) -> torch.Tensor:
    n = x.shape[0]
    i0, ti = _stage_index(n, half, x.device)
    i1 = i0 + half
    o0, o1 = fr_butterfly_plain(x[i0], x[i1], table[ti], dif)
    out = torch.empty_like(x)
    out[i0], out[i1] = o0, o1
    return out


def fr_butterfly_stage(x: torch.Tensor, table: torch.Tensor, half: int, dif: bool) -> torch.Tensor:
    """One radix-2 stage of an n-point transform over x (n, 8): butterfly j
    pairs i0 = (j // half) * 2 half + j % half with i0 + half and takes
    table[(j % half) * (n / 2 / half)], table (n/2, 8) the n-th root's
    powers. DIT (dif=False) or DIF; returns a new (n, 8) tensor."""
    _check(x, table)
    n = x.shape[0]
    if x.dim() != 2 or n < 2 or n & (n - 1):
        raise ValueError(f"expected (2^k, 8) words, got {tuple(x.shape)}")
    if table.shape != (n // 2, 8):
        raise ValueError(f"twiddle table must be ({n // 2}, 8)")
    if half < 1 or half & (half - 1) or half > n // 2:
        raise ValueError(f"half {half} is not a power of two in [1, {n // 2}]")
    if _build.runs_plain(x):
        return fr_butterfly_stage_plain(x, table, half, dif)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _build.lib("field_kernels").ccf_fr_butterfly_stage(
            x.data_ptr(), table.data_ptr(), out.data_ptr(), n, half.bit_length() - 1,
            int(dif), _stream(x))
    _build.check(rc, "fr_butterfly_stage")
    LAUNCHES["fr_butterfly_stage"] += 1
    return out


class FieldOps(NamedTuple):
    """The witness map's kernel set; PLAIN swaps in the plain versions so a
    caller can hold a whole witness map on the card against them."""

    fr_binary: object
    fr_tile_scan: object
    ntt_rows: object
    fr_butterfly_stage: object


KERNELS = FieldOps(fr_binary, fr_tile_scan, ntt_rows, fr_butterfly_stage)
PLAIN = FieldOps(fr_binary_plain, fr_tile_scan_plain, ntt_rows_plain, fr_butterfly_stage_plain)
