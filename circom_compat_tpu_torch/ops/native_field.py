"""ctypes bridge to hostsrc/field_ops.cpp: bulk host Montgomery ops.

Fills the role of ark-ff's asm backend (reference: Cargo.toml:25) for the
host side of the pipeline: the Montgomery strip of a zkey's coefficient
section (reference semantics: src/zkey.rs:320-325) in 4x64-bit limbs, on
several threads, where ops/limbs.mont_strip_np is the plain numpy version
it is held against; and a host Pippenger G1 MSM.

The library is built by g++ at first use into the package's _build_cache/
(_host_build.py). A missing compiler or a failed build raises: no caller
falls back to numpy.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from .. import _host_build
from ..constants import Q

_LOAD_LOCK = threading.Lock()
_lib = None


def _load_lib():
    global _lib
    with _LOAD_LOCK:
        if _lib is not None:
            return _lib
        lib = _host_build.lib("field_ops")
        lib.mont_strip.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64, ctypes.c_int,
        ]
        lib.mont_mul_const.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64, ctypes.c_int,
        ]
        lib.msm_g1_window_sums.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p, ctypes.c_int,
        ]
        _lib = lib
        return lib


def _limbs64(v: int) -> "ctypes.Array":
    return (ctypes.c_uint64 * 4)(*[(v >> (64 * i)) & ((1 << 64) - 1) for i in range(4)])


def _np64(p: int) -> int:
    return (-pow(p, -1, 1 << 64)) % (1 << 64)


def _nthreads(n: int) -> int:
    return min(os.cpu_count() or 1, max(1, n // 65536))


def mont_strip(values_u16: np.ndarray, p: int) -> np.ndarray:
    """(n, 16) uint16 LE limbs of v -> limbs of v * 2^-256 mod p."""
    lib = _load_lib()
    src = np.ascontiguousarray(values_u16, dtype="<u2")
    out = np.empty_like(src)
    n = src.shape[0]
    if n:
        lib.mont_strip(src.ctypes.data, out.ctypes.data, n, _limbs64(p), _np64(p), _nthreads(n))
    return out


def mont_mul_const(values_u16: np.ndarray, c: int, p: int) -> np.ndarray:
    """(n, 16) uint16 limbs of v -> limbs of v * c * 2^-256 mod p.

    With c in plain form this maps Montgomery-form inputs v = x R to x c
    in plain form; with c = c' R it keeps the Montgomery factor. Callers
    pick the form of c accordingly.
    """
    lib = _load_lib()
    src = np.ascontiguousarray(values_u16, dtype="<u2")
    out = np.empty_like(src)
    n = src.shape[0]
    if n:
        lib.mont_mul_const(src.ctypes.data, out.ctypes.data, n, _limbs64(c), _limbs64(p),
                           _np64(p), _nthreads(n))
    return out


def msm_g1_window_sums_native(xs_u16: np.ndarray, ys_u16: np.ndarray,
                              scalars_plain_u16: np.ndarray, window_bits: int,
                              nthreads: Optional[int] = None) -> np.ndarray:
    """Host Pippenger G1 window sums.

    xs/ys: (n, 16) uint16 affine Montgomery limbs (zkey storage layout, an
    all-zero row is infinity); scalars: (n, 16) uint16 plain canonical.
    Returns (W, 3, 4) uint64 Jacobian Montgomery sums, W = ceil(254 / w).
    """
    lib = _load_lib()
    xs = np.ascontiguousarray(xs_u16, dtype="<u2")
    ys = np.ascontiguousarray(ys_u16, dtype="<u2")
    sc = np.ascontiguousarray(scalars_plain_u16, dtype="<u2")
    n = xs.shape[0]
    out = np.zeros((-(-254 // window_bits), 3, 4), dtype="<u8")
    if n:
        lib.msm_g1_window_sums(xs.ctypes.data, ys.ctypes.data, sc.ctypes.data, n,
                               int(window_bits), _limbs64(Q), _np64(Q),
                               _limbs64((1 << 256) % Q), out.ctypes.data,
                               nthreads or (os.cpu_count() or 1))
    return out


def msm_g1_native(points_u16_xy, scalars, window_bits: int = 13,
                  nthreads: Optional[int] = None):
    """Host MSM: native window sums + exact Horner fold. Returns an affine
    (x, y) int pair, or None for infinity."""
    from ..refmath import curve as rc
    from . import limbs as limb_codec

    xs, ys = points_u16_xy
    sc16 = limb_codec.ints_to_limbs([int(s) for s in scalars], dtype=np.uint16)
    sums = msm_g1_window_sums_native(xs, ys, sc16, window_bits, nthreads)
    r_inv = pow(1 << 256, -1, Q)

    def decode(jac_row):
        X, Y, Z = (int.from_bytes(np.ascontiguousarray(c).tobytes(), "little") * r_inv % Q
                   for c in jac_row)
        if Z == 0:
            return None
        zi = pow(Z, -1, Q)
        return (X * zi * zi % Q, Y * zi * zi % Q * zi % Q)

    acc = None
    for w in reversed(range(sums.shape[0])):
        if acc is not None:
            for _ in range(window_bits):
                acc = rc.G1.double(acc)
        acc = rc.G1.add(acc, decode(sums[w]))
    return acc
