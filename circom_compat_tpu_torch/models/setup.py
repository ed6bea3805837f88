"""Groth16 parameter generation (a dev-mode trusted setup) with the
CircomReduction QAP semantics, on the card.

It mirrors ark_groth16::generate_random_parameters_with_reduction as the
reference tests use it (reference: tests/groth16.rs:22-27), so circuits
can be proved without a snarkjs .zkey. The CircomReduction pieces:

- instance map: the libsnark reduction (reference: src/circom/qap.rs:16-21),
  per-variable QAP evaluations u_i(t), v_i(t), w_i(t) over the Lagrange
  basis at tau, plus the public-input rows a[num_constraints + i] +=
  L_{nc+i}(t). Host Python (qap_instance_map).
- h_query scalars: delta^-1 t^i Lagrange-ified over the 2x domain, odd
  coefficients (reference: src/circom/qap.rs:90-105), computed in closed
  form on the card (_h_scalar_words).

generate_parameters_from_matrices runs the ~5 n_vars generator multiples
on the card (ops/fixed_base.py) and certifies every section before it
returns (on-curve for every row on the card, sampled rows against the
host's exact ladder). generate_parameters is the host path on exact Python
ints: the oracle the tests hold the card's sections against. Both return
the ProvingKey the zkey reader returns. The copy of
circom_compat_tpu/models/setup.py.
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..circom import qap
from ..circom.zkey import G1Section, G2Section, ProvingKey, VerifyingKey
from ..constants import B_G2, MONT_R_INV_Q, Q, R_SCALAR, fr_root_of_unity
from ..device import resolve_device
from ..ops import curve as cv
from ..ops import field as fl
from ..ops import field_kernels as fk
from ..ops import fixed_base as fb
from ..ops import limbs as limb_codec
from ..refmath import curve as rc
from .groth16_device import _Stages

Rows = List[List[Tuple[int, int]]]
ONCURVE_BLOCK = 1 << 22


def _rand_fr(rng) -> int:
    return rng.randrange(1, R_SCALAR)


def _g1_section(points) -> G1Section:
    return G1Section(cv.encode_g1_affine(points).view("<u2").reshape(len(points), 2, 16))


def _g2_section(points) -> G2Section:
    return G2Section(cv.encode_g2_affine(points).view("<u2").reshape(len(points), 4, 16))


def _batch_inv_mod(values: List[int], p: int) -> List[int]:
    """Montgomery's batch-inversion trick: one modular inversion in all."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % p
    inv_total = pow(prefix[n], -1, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_total % p
        inv_total = inv_total * values[i] % p
    return out


def qap_instance_map(matrix_a: Rows, matrix_b: Rows, matrix_c: Rows, num_inputs: int,
                     num_vars: int, t: int) -> Tuple[List[int], List[int], List[int], int]:
    """(a_i(t), b_i(t), c_i(t), zt): the libsnark instance map that
    CircomReduction delegates to (reference: src/circom/qap.rs:16-21)."""
    num_constraints = len(matrix_a)
    domain_size = qap.domain_size_for(num_constraints, num_inputs)
    omega = fr_root_of_unity(domain_size)

    # L_r(t) = zt * w^r / (n * (t - w^r)), the denominators inverted in one
    # batch
    zt = (pow(t, domain_size, R_SCALAR) - 1) % R_SCALAR
    n_inv = pow(domain_size, -1, R_SCALAR)
    w_pows = [1] * domain_size
    for i in range(1, domain_size):
        w_pows[i] = w_pows[i - 1] * omega % R_SCALAR
    denoms = [(t - w) % R_SCALAR for w in w_pows]
    if any(d == 0 for d in denoms):
        raise ValueError("tau is in the evaluation domain; re-draw")
    inv_denoms = _batch_inv_mod(denoms, R_SCALAR)
    zn = zt * n_inv % R_SCALAR
    l_at_t = [zn * w % R_SCALAR * d % R_SCALAR for w, d in zip(w_pows, inv_denoms)]

    a = [0] * num_vars
    b = [0] * num_vars
    c = [0] * num_vars
    for r in range(num_constraints):
        lr = l_at_t[r]
        for coeff, col in matrix_a[r]:
            a[col] = (a[col] + coeff * lr) % R_SCALAR
        for coeff, col in matrix_b[r]:
            b[col] = (b[col] + coeff * lr) % R_SCALAR
        for coeff, col in matrix_c[r]:
            c[col] = (c[col] + coeff * lr) % R_SCALAR
    # public-input rows bind the instance (reference: src/zkey.rs:171-175)
    for i in range(num_inputs):
        a[i] = (a[i] + l_at_t[num_constraints + i]) % R_SCALAR
    return a, b, c, zt


def generate_parameters(circuit, alpha: int, beta: int, gamma: int, delta: int,
                        t: int) -> ProvingKey:
    """Host setup from explicit toxic waste on exact ints. `circuit` is a
    CircomCircuit: to_matrices() -> (A, B, C) row lists [(value, wire)], and
    r1cs.num_inputs (the constant wire included) and r1cs.num_variables."""
    matrix_a, matrix_b, matrix_c = circuit.to_matrices()
    num_inputs, num_vars = circuit.r1cs.num_inputs, circuit.r1cs.num_variables
    domain_size = qap.domain_size_for(len(matrix_a), num_inputs)
    a_t, b_t, c_t, _zt = qap_instance_map(matrix_a, matrix_b, matrix_c, num_inputs, num_vars, t)
    gamma_inv = pow(gamma, -1, R_SCALAR)
    delta_inv = pow(delta, -1, R_SCALAR)
    g1mul = rc.FixedBaseLadder(rc.G1, rc.g1_generator()).mul
    g2mul = rc.FixedBaseLadder(rc.G2, rc.g2_generator()).mul
    combined = [(beta * a_t[i] + alpha * b_t[i] + c_t[i]) % R_SCALAR for i in range(num_vars)]
    h_scalars = qap.h_query_scalars(domain_size - 1, t, delta_inv)
    vk = VerifyingKey(
        alpha_g1=g1mul(alpha), beta_g2=g2mul(beta), gamma_g2=g2mul(gamma),
        delta_g2=g2mul(delta),
        gamma_abc_g1=[g1mul(combined[i] * gamma_inv) for i in range(num_inputs)],
    )
    return ProvingKey(
        vk=vk, beta_g1=g1mul(beta), delta_g1=g1mul(delta),
        a_query=_g1_section([g1mul(v) for v in a_t]),
        b_g1_query=_g1_section([g1mul(v) for v in b_t]),
        b_g2_query=_g2_section([g2mul(v) for v in b_t]),
        h_query=_g1_section([g1mul(v) for v in h_scalars]),
        l_query=_g1_section([g1mul(combined[i] * delta_inv) for i in range(num_inputs, num_vars)]),
        n_vars=num_vars, n_public=num_inputs - 1, domain_size=domain_size,
    )


def _h_scalar_words(domain_size: int, t: int, delta_inverse: int, device) -> torch.Tensor:
    """qap.h_query_scalars in closed form on `device`: (n, 8) canonical
    plain Fr words.

    The reference takes them as iFFT([delta_inv * t^i]) over the 2n domain,
    keeping the odd coefficients (reference: src/circom/qap.rs:90-105). The
    iFFT of a geometric sequence is a geometric sum: with N = 2n, w the
    N-th root of unity and v_i = a t^i for i < N - 1 (the last slot zero),

        coeff_k = a/N * (t^{N-1} w^k - 1) / (t w^{-k} - 1),

    so the odd coefficients k = 2j + 1 are two geometric ladders (bit b of
    j selects a multiply by a power, as torch.where over Fr binary
    launches) and one batch inversion (prefix and suffix product scans and
    one host inverse). The JAX package's iFFT variant (its parity oracle
    and non-power-of-two fallback) is not ported: domain sizes are powers
    of two (qap.domain_size_for)."""
    n = domain_size
    if n < 1 or n & (n - 1):
        raise ValueError(f"setup: domain size {n} is not a power of two")
    N = 2 * n
    tm = t % R_SCALAR
    if pow(tm, N, R_SCALAR) == 1:
        # t inside the 2n domain: a pole of the closed form, and degenerate
        # toxic waste besides
        raise ValueError(f"setup: toxic-waste t is a {N}-th root of unity; pick a new t")
    F = fl.FR
    w = fr_root_of_unity(N)
    w_inv = pow(w, -1, R_SCALAR)
    c_num = pow(tm, N - 1, R_SCALAR) * w % R_SCALAR  # * (w^2)^j over j
    c_den = tm * w_inv % R_SCALAR  # * (w^-2)^j over j
    rho, sigma = w * w % R_SCALAR, w_inv * w_inv % R_SCALAR
    scale = delta_inverse % R_SCALAR * pow(N, -1, R_SCALAR) % R_SCALAR
    log_n = max(n.bit_length() - 1, 1)
    idx = torch.arange(n, device=device)

    def enc(v):
        return F.words(v * (1 << 256) % R_SCALAR, device)

    def ladder(start, ratio):
        acc = enc(start).expand(n, 8).contiguous()
        for b in range(log_n):
            mask = ((idx >> b) & 1).bool()[:, None]
            step = fk.fr_binary("mul", acc, enc(pow(ratio, 1 << b, R_SCALAR)))
            acc = torch.where(mask, step, acc)
        return fk.fr_binary("sub", acc, enc(1))

    den = ladder(c_den, sigma)
    pre = fb.prefix_products(den, F)
    suf = fb.suffix_products(den, F)
    del den
    total = fl.decode(pre[-1:], F)[0]
    if total == 0:
        raise ValueError("setup: degenerate H-denominator product")
    inv_den = fb.inv_from_scans(pre, suf, pow(total, -1, R_SCALAR), F)
    del pre, suf
    num = ladder(c_num, rho)
    return fk.fr_from_mont(fk.fr_binary("mul", fk.fr_binary("mul", num, inv_den), enc(scale)))


class SetupSelfCheckError(AssertionError):
    """A section made on the card disagrees with exact host math."""


def _decode_row_g1(sec: G1Section, i: int):
    x, y = (limb_codec.limbs_to_int(c) for c in sec.limbs[i])
    if x == 0 and y == 0:
        return None
    return (x * MONT_R_INV_Q % Q, y * MONT_R_INV_Q % Q)


def _decode_row_g2(sec: G2Section, i: int):
    raw = [limb_codec.limbs_to_int(c) for c in sec.limbs[i]]
    if all(v == 0 for v in raw):
        return None
    v = [r * MONT_R_INV_Q % Q for r in raw]
    return ((v[0], v[1]), (v[2], v[3]))


def _oncurve_all(name: str, limbs_u16: np.ndarray, g2: bool = False, device=None) -> None:
    """On-curve membership of EVERY row of a section, on the card through
    the Fq binary kernel, in blocks of ONCURVE_BLOCK rows; all-zero rows
    (infinity) are exempt. Raises SetupSelfCheckError naming the first
    offending row."""
    dev = resolve_device(device)
    words = limb_codec.words_view(np.asarray(limbs_u16))
    for lo in range(0, words.shape[0], ONCURVE_BLOCK):
        _oncurve_block(name, torch.from_numpy(words[lo : lo + ONCURVE_BLOCK].copy()).to(dev), lo, g2)


def _mont_q(v: int, device) -> torch.Tensor:
    return fl.FQ.words(v * (1 << 256) % Q, device)


def _oncurve_block(name: str, d: torch.Tensor, base: int, g2: bool) -> None:
    dev = d.device
    if g2:  # y^2 == x^3 + b' over Fq2 = Fq[u]/(u^2 + 1)
        x, y = d[:, 0:2], d[:, 2:4]
        xc = fb.fq2_mul(fb.fq2_mul(x, x), x)
        rhs = torch.stack([fb.fq("add", xc[:, i], _mont_q(B_G2[i], dev)) for i in range(2)], dim=1)
        lhs = fb.fq2_mul(y, y)
    else:  # y^2 == x^3 + 3
        x, y = d[:, 0], d[:, 1]
        rhs = fb.fq("add", fb.fq("mul", fb.fq("mul", x, x), x), _mont_q(3, dev))
        lhs = fb.fq("mul", y, y)
    ok = (fb.canon(lhs) == fb.canon(rhs)).flatten(1).all(-1) | (d == 0).flatten(1).all(-1)
    if not bool(ok.all()):
        bad = base + int((~ok).nonzero()[0, 0])
        raise SetupSelfCheckError(f"setup self-check: section {name} row {bad} is off-curve "
                                  f"({int((~ok).sum())} rows in this block)")


def _selfcheck_section(name: str, sec, scalars, g2: bool = False,
                       samples: Optional[int] = None, device=None) -> None:
    """Certify a section made on the card: (1) every row on the curve (any
    off-curve corruption), (2) when the scalars are known, sampled rows
    against the host's exact ladder (on-curve but wrong rows), the sample
    count growing with the section. A corrupt key fails here, at setup,
    not as an opaque verification failure later."""
    n = len(sec)
    if n == 0:
        return
    _oncurve_all(name, sec.limbs, g2, device)
    if scalars is None:
        return
    if samples is None:
        samples = max(4, n >> 16)
    rng = random.Random(0xC0FFEE ^ n)
    idxs = sorted(set(rng.randrange(n) for _ in range(samples)))
    ladder = rc.FixedBaseLadder(rc.G2 if g2 else rc.G1,
                                rc.g2_generator() if g2 else rc.g1_generator())
    decode = _decode_row_g2 if g2 else _decode_row_g1
    for i in idxs:
        if decode(sec, i) != ladder.mul(scalars[i] % R_SCALAR):
            raise SetupSelfCheckError(f"setup self-check: section {name} row {i} != g * s (host)")


def _section(words: torch.Tensor, g2: bool):
    """(n, 2, *coord, 8) affine words on any device -> the host section."""
    limbs = words.cpu().numpy().view("<u2")
    if g2:
        return G2Section(limbs.reshape(-1, 4, 16))
    return G1Section(limbs.reshape(-1, 2, 16))


def generate_parameters_from_matrices(
    matrix_a: Rows, matrix_b: Rows, matrix_c: Rows, num_inputs: int, num_vars: int,
    alpha: int, beta: int, gamma: int, delta: int, t: int, device=None,
    stage_times: Optional[dict] = None,
) -> ProvingKey:
    """Setup for real circuit sizes, on the card unless `device` names
    another: the generator multiples as fixed-base folds, the H scalars in
    closed form, then the self-check of every section. The same toxic waste
    gives the same key as generate_parameters, byte for byte. stage_times,
    when a dict, receives the wall seconds of each stage (instance_map,
    encode, g1_fold, h_scalars, g2_fold, readback, selfcheck), each ended by
    a device sync."""
    dev = resolve_device(device)
    stage = _Stages(stage_times, dev)
    with stage("instance_map"):
        domain_size = qap.domain_size_for(len(matrix_a), num_inputs)
        a_t, b_t, c_t, _zt = qap_instance_map(matrix_a, matrix_b, matrix_c, num_inputs,
                                              num_vars, t)
        gamma_inv = pow(gamma, -1, R_SCALAR)
        delta_inv = pow(delta, -1, R_SCALAR)
        combined = [(beta * a_t[i] + alpha * b_t[i] + c_t[i]) % R_SCALAR
                    for i in range(num_vars)]
        scalars = {
            "ic": [combined[i] * gamma_inv % R_SCALAR for i in range(num_inputs)],
            "l_query": [combined[i] * delta_inv % R_SCALAR for i in range(num_inputs, num_vars)],
            "a_query": a_t,
            "b_g1_query": b_t,
        }
    with stage("encode"):
        words = {k: torch.from_numpy(fl.encode_plain(v)).to(dev) for k, v in scalars.items()}
    with stage("g1_fold"):
        points = {k: fb.fixed_base_points_from_words(w) for k, w in words.items()}
    with stage("h_scalars"):
        h_words = _h_scalar_words(domain_size, t, delta_inv, dev)
    with stage("g1_fold"):
        points["h_query"] = fb.fixed_base_points_from_words(h_words)
    with stage("g2_fold"):
        points["b_g2_query"] = fb.fixed_base_points_from_words(words["b_g1_query"], g2=True)
    del words, h_words
    with stage("readback"):
        secs = {k: _section(p, k == "b_g2_query") for k, p in points.items()}
    del points
    with stage("selfcheck"):
        for name, sec in secs.items():
            known = scalars["b_g1_query"] if name == "b_g2_query" else scalars.get(name)
            _selfcheck_section(name, sec, known, g2=name == "b_g2_query", device=dev)

    g1mul = rc.FixedBaseLadder(rc.G1, rc.g1_generator()).mul
    g2mul = rc.FixedBaseLadder(rc.G2, rc.g2_generator()).mul
    vk = VerifyingKey(alpha_g1=g1mul(alpha), beta_g2=g2mul(beta), gamma_g2=g2mul(gamma),
                      delta_g2=g2mul(delta), gamma_abc_g1=secs["ic"].points)
    return ProvingKey(
        vk=vk, beta_g1=g1mul(beta), delta_g1=g1mul(delta),
        a_query=secs["a_query"], b_g1_query=secs["b_g1_query"], b_g2_query=secs["b_g2_query"],
        h_query=secs["h_query"], l_query=secs["l_query"],
        n_vars=num_vars, n_public=num_inputs - 1, domain_size=domain_size,
    )


def generate_random_parameters(circuit, rng=None, device=None) -> ProvingKey:
    """Setup with random toxic waste (reference call site:
    tests/groth16.rs:25), on the card unless `device` names another."""
    rng = rng or random.SystemRandom()
    alpha, beta, gamma, delta, t = (_rand_fr(rng) for _ in range(5))
    matrix_a, matrix_b, matrix_c = circuit.to_matrices()
    return generate_parameters_from_matrices(
        matrix_a, matrix_b, matrix_c, circuit.r1cs.num_inputs, circuit.r1cs.num_variables,
        alpha, beta, gamma, delta, t, device=device)
