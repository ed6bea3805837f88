"""circom_compat_tpu_torch.ops.native_field (hostsrc/field_ops.cpp, built by
g++ into the port's _build_cache/) against the JAX package's native_field
and the port's plain numpy strip (ops/limbs.mont_strip_np):
  - mont_strip and mont_mul_const on seeded values below p plus edge rows
    (0, 1, p - 1, p - 2, a value whose 32-bit limbs are all set below p,
    R mod p), for r and q, at n = 5 (one thread) and n = 2^17 + 3 (the
    multi-thread branch: it needs n >= 2 * 65536), also against Python ints
    on a sample of rows;
  - ops/limbs.mont_strip (the zkey reader's strip) is the native one;
  - msm_g1_native on 64 points of known discrete log (one of them
    infinity, one scalar zero) at window bits 4 and 13, against the JAX
    package's and the exact sum.
Tolerance: exact equality.
"""

import random

import numpy as np
import pytest

from circom_compat_tpu.ops import native_field as jax_nf
from circom_compat_tpu_torch.constants import NPRIME_Q, NPRIME_R, Q, R_SCALAR
from circom_compat_tpu_torch.ops import limbs as lc
from circom_compat_tpu_torch.ops import native_field as nf
from circom_compat_tpu_torch.refmath import curve as rc

RNG = random.Random(0x5719)
FIELDS = {"r": (R_SCALAR, NPRIME_R), "q": (Q, NPRIME_Q)}


def _values(p: int, n: int) -> np.ndarray:
    top = p >> 224
    edges = [0, 1, p - 1, p - 2, ((top - 1) << 224) | ((1 << 224) - 1), (1 << 256) % p]
    rng = np.random.default_rng(n)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype("<u4")
    words[:, 7] %= np.uint32(top)  # below p
    limbs = words.view("<u2").reshape(n, 16).copy()
    m = min(len(edges), n)
    limbs[:m] = lc.ints_to_limbs(edges[:m], dtype=np.uint16)
    return limbs


@pytest.fixture(autouse=True)
def _jax_native(monkeypatch):
    monkeypatch.delenv("CIRCOM_TPU_NATIVE", raising=False)
    assert jax_nf.available()


@pytest.mark.parametrize("n", [5, (1 << 17) + 3])
@pytest.mark.parametrize("field", list(FIELDS))
def test_mont_strip(field, n):
    p, nprime = FIELDS[field]
    values = _values(p, n)
    got = nf.mont_strip(values, p)
    assert got.dtype == np.uint16 and got.shape == (n, 16)
    assert np.array_equal(got, jax_nf.mont_strip(values, p))
    assert np.array_equal(got, lc.mont_strip_np(values, p, nprime))
    r_inv = pow(1 << 256, -1, p)
    for i in list(range(min(n, 6))) + [RNG.randrange(n) for _ in range(8)]:
        assert lc.limbs_to_int(got[i]) == lc.limbs_to_int(values[i]) * r_inv % p
    if field == "r":
        assert np.array_equal(lc.mont_strip(values, p), got)


@pytest.mark.parametrize("n", [5, (1 << 17) + 3])
def test_mont_mul_const(n):
    values = _values(R_SCALAR, n)
    c = RNG.randrange(R_SCALAR)
    got = nf.mont_mul_const(values, c, R_SCALAR)
    assert np.array_equal(got, jax_nf.mont_mul_const(values, c, R_SCALAR))
    r_inv = pow(1 << 256, -1, R_SCALAR)
    for i in list(range(min(n, 6))) + [RNG.randrange(n) for _ in range(8)]:
        assert lc.limbs_to_int(got[i]) == lc.limbs_to_int(values[i]) * c * r_inv % R_SCALAR


@pytest.mark.parametrize("window_bits", [4, 13])
def test_msm_g1_native(window_bits):
    n = 64
    dlogs = [RNG.randrange(1, 1 << 60) for _ in range(n)]
    points = [rc.G1.mul(rc.g1_generator(), k) for k in dlogs]
    mont = [[c * (1 << 256) % Q for c in pt] for pt in points]
    xs = lc.ints_to_limbs([x for x, _ in mont], dtype=np.uint16)
    ys = lc.ints_to_limbs([y for _, y in mont], dtype=np.uint16)
    xs[3] = 0
    ys[3] = 0  # infinity (the zkey's all-zero row)
    scalars = [RNG.randrange(R_SCALAR) for _ in range(n)]
    scalars[7] = 0
    got = nf.msm_g1_native((xs, ys), scalars, window_bits=window_bits)
    assert got == jax_nf.msm_g1_native((xs, ys), scalars, window_bits=window_bits)
    total = sum(k * s for i, (k, s) in enumerate(zip(dlogs, scalars)) if i != 3) % R_SCALAR
    assert got == rc.G1.mul(rc.g1_generator(), total)
    sums = nf.msm_g1_window_sums_native(xs, ys, lc.ints_to_limbs(scalars, dtype=np.uint16),
                                        window_bits)
    assert sums.shape == (-(-254 // window_bits), 3, 4) and sums.dtype == np.uint64
