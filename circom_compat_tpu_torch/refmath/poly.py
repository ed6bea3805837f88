"""Host-side reference radix-2 NTT over Fr (plain Python ints).

Semantics match arkworks' Radix2EvaluationDomain as used by the reference
witness map (reference: src/circom/qap.rs:60-81): fft maps coefficients in
natural order to evaluations [p(w^0), p(w^1), ...]; ifft is its inverse.
Ground truth for the device NTT (ops/ntt.py).
"""

from __future__ import annotations

from typing import List

from ..constants import R_SCALAR, fr_root_of_unity


def _bit_reverse_permute(a: List[int]) -> None:
    n = len(a)
    log_n = n.bit_length() - 1
    for i in range(n):
        j = int(bin(i)[2:].zfill(log_n)[::-1], 2) if log_n else 0
        if i < j:
            a[i], a[j] = a[j], a[i]


def _ntt_in_place(a: List[int], root: int) -> None:
    n = len(a)
    if n & (n - 1):
        raise ValueError("length must be a power of two")
    _bit_reverse_permute(a)
    length = 2
    while length <= n:
        w_len = pow(root, n // length, R_SCALAR)
        for start in range(0, n, length):
            w = 1
            half = length // 2
            for k in range(start, start + half):
                u = a[k]
                v = a[k + half] * w % R_SCALAR
                a[k] = (u + v) % R_SCALAR
                a[k + half] = (u - v) % R_SCALAR
                w = w * w_len % R_SCALAR
        length <<= 1


def fft(coeffs: List[int]) -> List[int]:
    out = [c % R_SCALAR for c in coeffs]
    _ntt_in_place(out, fr_root_of_unity(len(out)))
    return out


def ifft(evals: List[int]) -> List[int]:
    n = len(evals)
    out = [e % R_SCALAR for e in evals]
    _ntt_in_place(out, pow(fr_root_of_unity(n), -1, R_SCALAR))
    n_inv = pow(n, -1, R_SCALAR)
    return [x * n_inv % R_SCALAR for x in out]


def distribute_powers(coeffs: List[int], g: int) -> List[int]:
    """coeffs[i] *= g^i — arkworks' distribute_powers_and_mul_by_const with
    const 1 (reference: src/circom/qap.rs:69-70)."""
    out = []
    acc = 1
    for c in coeffs:
        out.append(c * acc % R_SCALAR)
        acc = acc * g % R_SCALAR
    return out


