"""Limb codecs between Python ints, bytes and numpy arrays (numpy only).

A field element's wire form is NUM_LIMBS=16 little-endian limbs of
LIMB_BITS=16 bits: exactly the .zkey/.r1cs byte layout. The same bytes read
as little-endian uint32 are the 8 words the CUDA kernels work on
(`words_view`), so no conversion pass stands between a zkey section and the
card.
"""

from __future__ import annotations

import numpy as np

from ..constants import LIMB_BITS, LIMB_MASK, NUM_LIMBS, WORDS

_BYTES_PER_LIMB = LIMB_BITS // 8
_ELEM_BYTES = NUM_LIMBS * _BYTES_PER_LIMB  # 32


def int_to_limbs(x: int, dtype=np.uint32) -> np.ndarray:
    """One field element -> (NUM_LIMBS,) limb vector (little-endian limbs)."""
    if x < 0 or x >> (LIMB_BITS * NUM_LIMBS):
        raise ValueError("value out of 256-bit range")
    return np.array(
        [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(NUM_LIMBS)], dtype=dtype
    )


def limbs_to_int(limbs: np.ndarray) -> int:
    """(NUM_LIMBS,) limb vector -> Python int."""
    acc = 0
    for i in range(NUM_LIMBS - 1, -1, -1):
        acc = (acc << LIMB_BITS) | int(limbs[i])
    return acc


def ints_to_limbs(values, dtype=np.uint32) -> np.ndarray:
    """Iterable of ints -> (N, NUM_LIMBS) limb array (via int.to_bytes into
    one preallocated buffer: the 32-byte LE encoding IS the limb layout)."""
    values = list(values)
    buf = bytearray(len(values) * _ELEM_BYTES)
    mv = memoryview(buf)
    off = 0
    try:
        for v in values:
            mv[off : off + _ELEM_BYTES] = v.to_bytes(_ELEM_BYTES, "little")
            off += _ELEM_BYTES
    except (OverflowError, AttributeError) as e:
        raise ValueError("value out of 256-bit range") from e
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(values), NUM_LIMBS)
    return arr.astype(dtype)  # astype copies: frombuffer views are read-only


def limbs_to_ints(limbs: np.ndarray) -> list:
    """(..., NUM_LIMBS) limb array -> nested list of Python ints."""
    arr = np.asarray(limbs)
    if arr.ndim == 1:
        return limbs_to_int(arr)
    flat = np.ascontiguousarray(arr.reshape(-1, NUM_LIMBS).astype("<u2"))
    raw = flat.tobytes()
    out = [
        int.from_bytes(raw[i * _ELEM_BYTES : (i + 1) * _ELEM_BYTES], "little")
        for i in range(flat.shape[0])
    ]
    return np.array(out, dtype=object).reshape(arr.shape[:-1]).tolist()


def words_view(limbs_u16: np.ndarray) -> np.ndarray:
    """(..., 16) uint16 limbs -> (..., 8) int32 words over the same bytes
    (a copy only where the input is not contiguous little-endian)."""
    arr = np.ascontiguousarray(limbs_u16, dtype="<u2")
    return arr.view("<i4").reshape(arr.shape[:-1] + (WORDS,))


def ints_to_words(values) -> np.ndarray:
    """Iterable of ints in [0, 2^256) -> (N, 8) int32 words."""
    return words_view(ints_to_limbs(values, dtype=np.uint16))


def words_to_ints(words: np.ndarray) -> list:
    """(..., 8) 32-bit words -> nested list of Python ints."""
    arr = np.ascontiguousarray(words).astype("<u4")
    return limbs_to_ints(arr.view("<u2").reshape(arr.shape[:-1] + (NUM_LIMBS,)))


def mont_strip(values: np.ndarray, p: int) -> np.ndarray:
    """Montgomery strip: (n, 16) uint16 limbs of v -> v*R^-1 mod p, on the
    host library's threads (ops/native_field.py, built by g++ at first use;
    a missing compiler raises). mont_strip_np is its plain version."""
    from . import native_field

    return native_field.mont_strip(values, p)


def mont_strip_np(values: np.ndarray, p: int, nprime: int) -> np.ndarray:
    """Vectorized Montgomery strip: (n, 16) uint16 limbs of v -> v*R^-1 mod p.

    uint64 REDC over one (n, 33) work buffer; each work limb accumulates at
    most 16 products < 2^32 plus carries, so it stays < 2^37.
    """
    mask = np.uint64(LIMB_MASK)
    shift = np.uint64(LIMB_BITS)
    p_limbs = int_to_limbs(p).astype(np.uint64)
    pc_limbs = int_to_limbs((1 << 256) - p).astype(np.uint64)
    np_ = np.uint64(nprime)

    n = values.shape[0]
    t = np.zeros((n, 2 * NUM_LIMBS + 1), np.uint64)
    t[:, :NUM_LIMBS] = values
    for i in range(NUM_LIMBS):
        m = (t[:, i] * np_) & mask
        t[:, i : i + NUM_LIMBS] += m[:, None] * p_limbs
        t[:, i + 1] += t[:, i] >> shift  # low 16 bits of limb i now zero

    t = t[:, NUM_LIMBS:]  # (n, 17) result limbs (REDC divides by 2^256)

    def normalize(x):  # in-place ripple; limbs < 2^37 resolve in ~3 passes
        hi = x >> shift
        while hi.any():
            x &= mask
            x[:, 1:] += hi[:, :-1]
            hi = x >> shift
        return x

    t = normalize(t)[:, :NUM_LIMBS]
    # conditional subtract p: t + (2^256 - p) overflows the guard limb iff t >= p
    u17 = np.zeros((n, NUM_LIMBS + 1), np.uint64)
    u17[:, :NUM_LIMBS] = t
    u17[:, :NUM_LIMBS] += pc_limbs
    u17 = normalize(u17)
    ge = u17[:, NUM_LIMBS] != 0
    out = np.where(ge[:, None], u17[:, :NUM_LIMBS], t)
    return out.astype(np.uint16)
