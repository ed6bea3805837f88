"""BN254 Fr/Fq arithmetic: field specs, codecs, and the plain PyTorch
Montgomery arithmetic that every kernel's plain version is built from.

Layout: a field element is 8 little-endian 32-bit words in a `torch.int32`
tensor of shape (..., 8), read as unsigned. That is byte for byte the zkey's
16x16-bit limb form, and Montgomery R = 2^256 either way.

The plain arithmetic runs on 16-bit limbs held in int64, shape (..., 16):
this build of torch has no unsigned 32-bit add, shift or compare, and int64
keeps every CIOS column sum exact (16 steps of two products < 2^32 stay
below 2^38). It is the same algorithm as csrc/field.cuh:

  mont_mul_lazy  CIOS with no final subtraction. For a, b < 2p the result
                 (ab + mp)/R is < 2p because p < R/4 for both Fr and Fq, so
                 values stay closed over the lazy range [0, 2p).
  mont_mul       the same, then one conditional subtraction: canonical.
  add_lazy       a + b, minus 2p if >= 2p.
  add            a + b, minus p if >= p (canonical inputs).
  sub_lazy       a - b + 2p, minus 2p if >= 2p.

The m of each CIOS step makes xy + mp = 0 mod R with m < R; that m is
unique, so 16-bit and 32-bit CIOS produce the same words. The kernels and
these functions therefore agree word for word.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import MONT_R2_Q, MONT_R2_R, MONT_R_Q, MONT_R_R, NUM_LIMBS, Q, R_SCALAR, WORDS
from . import limbs as limb_codec

MASK = 0xFFFF


def _limbs_of(v: int) -> tuple:
    return tuple(int(x) for x in limb_codec.int_to_limbs(v))


@dataclass(frozen=True)
class FieldSpec:
    name: str
    modulus: int
    nprime16: int  # -p^-1 mod 2^16
    nprime32: int  # -p^-1 mod 2^32
    one_mont: int  # R mod p
    r2: int  # R^2 mod p

    def limbs(self, v: int, device) -> torch.Tensor:
        return torch.tensor(_limbs_of(v), dtype=torch.int64, device=device)

    def words(self, v: int, device=None) -> torch.Tensor:
        """One element as an (8,) int32 word tensor."""
        return torch.from_numpy(limb_codec.ints_to_words([v])[0].copy()).to(device)


def _spec(name: str, p: int, r_mod: int, r2: int) -> FieldSpec:
    return FieldSpec(name, p, (-pow(p, -1, 1 << 16)) % (1 << 16),
                     (-pow(p, -1, 1 << 32)) % (1 << 32), r_mod, r2)


FR = _spec("fr", R_SCALAR, MONT_R_R, MONT_R2_R)
FQ = _spec("fq", Q, MONT_R_Q, MONT_R2_Q)


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------


def words_to_limbs(x: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 16) int64 16-bit limbs."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack((u & MASK, u >> 16), dim=-1).reshape(x.shape[:-1] + (NUM_LIMBS,))


def limbs_to_words(t: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 limbs (each < 2^16) -> (..., 8) int32 words."""
    t = t.reshape(t.shape[:-1] + (WORDS, 2))
    w = t[..., 0] | (t[..., 1] << 16)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def encode_plain(values) -> np.ndarray:
    """Python ints -> (N, 8) int32 words, canonical mod r."""
    return limb_codec.ints_to_words([int(v) % R_SCALAR for v in values])


def decode(words, field: FieldSpec, mont: bool = True):
    """(..., 8) words -> nested list of canonical Python ints."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    vals = limb_codec.words_to_ints(np.asarray(words))
    p = field.modulus
    rinv = pow(1 << 256, -1, p)

    def fix(v):
        if isinstance(v, list):
            return [fix(x) for x in v]
        return (v * rinv) % p if mont else v % p

    return fix(vals)


# ---------------------------------------------------------------------------
# Plain arithmetic on (..., 16) int64 limbs
# ---------------------------------------------------------------------------


def _normalize(t: torch.Tensor) -> torch.Tensor:
    """Carry (or borrow: the shift floors) through the limbs, in place."""
    for j in range(NUM_LIMBS - 1):
        t[..., j + 1] += t[..., j] >> 16
        t[..., j] &= MASK
    return t


def _cond_sub(t: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """t - m if t >= m else t; t normalized, m a (16,) limb constant."""
    d = _normalize(t - m)
    ge = (d[..., NUM_LIMBS - 1] >= 0).unsqueeze(-1)
    return torch.where(ge, d & MASK, t)


def mont_mul_lazy(F: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    p = F.limbs(F.modulus, a.device)
    t = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    zero = torch.zeros(a.shape[:-1] + (1,), dtype=torch.int64, device=a.device)
    for i in range(NUM_LIMBS):
        t = t + a * b[..., i : i + 1]
        m = ((t[..., 0:1] & MASK) * F.nprime16) & MASK
        t = t + m * p
        carry = t[..., 0:1] >> 16  # low 16 bits of limb 0 are now zero
        t = torch.cat((t[..., 1:], zero), dim=-1)
        t[..., 0:1] += carry
    return _normalize(t)


def mont_mul(F: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cond_sub(mont_mul_lazy(F, a, b), F.limbs(F.modulus, a.device))


def add_lazy(F: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cond_sub(_normalize(a + b), F.limbs(2 * F.modulus, a.device))


def add(F: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b, minus p if >= p: canonical for canonical inputs."""
    return _cond_sub(_normalize(a + b), F.limbs(F.modulus, a.device))


def sub_lazy(F: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p2 = F.limbs(2 * F.modulus, a.device)
    return _cond_sub(_normalize(a - b + p2), p2)
