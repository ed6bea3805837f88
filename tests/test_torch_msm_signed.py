"""circom_compat_tpu_torch's signed-digit MSM (ops/msm.py, signed=True)
against the JAX package:
  - window_digits_signed equals msm.window_digits_signed word for word at
    w = 2, 5, 8 and 13 (the top window unsigned), and bucket_count covers
    every |digit|;
  - the signed G1 window sums (buckets keyed by |d|, y negated on the
    gathered row, infinity rows kept) equal the JAX package's
    window_sums_affine_impl(signed=True) (XLA) window by window, at 200
    points with infinity rows, zero scalars and r - 1;
  - msm_g1(signed=True) equals the unsigned msm_g1 and sum_i s_i P_i, at
    w = 2 too, where the top window's digit plus carry passes 2^(w-1);
  - signed is off by default, and the bucket sums refuse sorts of the
    other kind;
  - signed bucket sums gather only rows of nonzero digit (bits, and two
    dense scalars with an empty window): bucket 0 is the identity, bucket
    j the host's signed sum, the row counters split W * N.
Inputs come from a numpy seed. Tolerance: exact equality of integer
digits and of affine group elements.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_compat_tpu.ops import curve_jax as cj
from circom_compat_tpu.ops import msm as jmsm
from circom_compat_tpu_torch.constants import R_SCALAR
from circom_compat_tpu_torch.ops import curve as cv
from circom_compat_tpu_torch.ops import limbs as tl
from circom_compat_tpu_torch.ops import msm as tmsm
from circom_compat_tpu_torch.refmath import curve as rc

torch.set_num_threads(1)
RNG = np.random.default_rng(0x516)
N = 200


def _scalars(n):
    vals = [int.from_bytes(RNG.bytes(32), "little") % R_SCALAR for _ in range(n)]
    vals[1], vals[2] = 0, R_SCALAR - 1
    return vals


def _limbs(words):
    return jnp.asarray(np.ascontiguousarray(words.numpy()).view("<u2").astype(np.uint32))


@pytest.mark.parametrize("wbits", [2, 5, 8, 13])
def test_window_digits_signed_vs_jax(wbits):
    sc = torch.from_numpy(tl.ints_to_words(_scalars(64)))
    got = tmsm.window_digits_signed(sc, wbits)
    assert got.tolist() == np.asarray(jmsm.window_digits_signed(_limbs(sc), wbits)).tolist()
    assert int(got.abs().max()) < tmsm.bucket_count(wbits, signed=True)
    assert int(got[:-1].abs().max()) <= 1 << (wbits - 1) and int(got[-1].min()) >= 0
    orders, keys, negs = tmsm.window_orders_signed(sc, wbits)
    assert torch.equal(torch.gather(got.abs(), 1, orders), keys)
    assert torch.equal(torch.gather(got, 1, orders) < 0, negs)


def _points(n):
    pool = [rc.G1.mul(rc.g1_generator(), int(k)) for k in RNG.integers(1, 1 << 62, size=16)]
    pts = [pool[i] for i in RNG.integers(0, 16, size=n)]
    for i in (0, 7, 8, 9):
        pts[i] = None
    return pts


def test_signed_window_sums_vs_jax_and_unsigned():
    pts, vals = _points(N), _scalars(N)
    xy = torch.from_numpy(cv.encode_g1_affine(pts))
    sc = torch.from_numpy(tl.ints_to_words(vals))
    w = 8
    negs = tmsm.window_orders_signed(sc, w)[2]
    assert bool(negs.any())
    sums = tmsm.window_sums([xy], [tmsm.window_orders_signed(sc, w)], w, signed=True)[0]
    u16 = np.ascontiguousarray(xy.numpy()).view("<u2")
    fn = jax.jit(jmsm.window_sums_affine_impl, static_argnums=(0, 4, 5, 6, 7))
    want = fn(cj.FQ_ADAPTER, jnp.asarray(u16[:, 0]), jnp.asarray(u16[:, 1]), _limbs(sc), w,
              jmsm.CHUNK_POINTS, False, True)
    assert cv.decode_g1_proj(sums) == cj.decode_g1_proj(want)
    total = None
    for p, s in zip(pts, vals):
        if p is not None:
            total = rc.G1.add(total, rc.G1.mul(p, s))
    assert tmsm.fold_windows_host(cv.decode_g1_proj(sums), rc.G1, w) == total
    unsigned = tmsm.msm_g1(xy, vals, window_bits=w, device="cpu")
    assert tmsm.msm_g1(xy, vals, window_bits=w, device="cpu", signed=True) == unsigned == total


def test_signed_msm_past_half_window_and_defaults():
    """At w = 2 the unsigned top window's digit plus carry reaches 4 > 2^(w-1):
    bucket_count keeps it in its own bucket."""
    pts, vals = _points(24), _scalars(24)
    vals[3] = (3 << 252) + 5  # top digit 3, plus a carry
    xy = torch.from_numpy(cv.encode_g1_affine(pts))
    want = None
    for p, s in zip(pts, vals):
        if p is not None:
            want = rc.G1.add(want, rc.G1.mul(p, s))
    assert tmsm.bucket_count(2, signed=True) == 5
    assert tmsm.msm_g1(xy, vals, window_bits=2, device="cpu", signed=True) == want
    for fn in (tmsm.msm_g1, tmsm.msm_g2, tmsm.window_sums, tmsm.bucket_sums):
        assert inspect.signature(fn).parameters["signed"].default is False
    sc = torch.from_numpy(tl.ints_to_words(vals))
    with pytest.raises(ValueError, match="signed"):
        tmsm.bucket_sums([xy], [tmsm.window_orders(sc, 4)], 4, signed=True)
    with pytest.raises(ValueError, match="signed"):
        tmsm.bucket_sums([xy], [tmsm.window_orders_signed(sc, 4)], 4)


def _signed_digits(v, c):
    """The window digits of v, each below the top one recoded to [-2^(c-1), 2^(c-1))."""
    out, carry, W = [], 0, tmsm.num_windows(c)
    for w in range(W):
        d = ((v >> (w * c)) & ((1 << c) - 1)) + carry
        carry = int(w < W - 1 and d >= 1 << (c - 1))
        out.append(d - (carry << c))
    return out


@pytest.mark.parametrize("case", ["bits", "zero_window"])
def test_signed_bucket_sums_skip_digit_zero(case):
    """Signed bucket sums gather the rows of nonzero digit alone, at N = 37
    and w = 4: bucket 0 of every window is the identity, bucket j the host's
    sum of d / |d| P over the rows with |d| = j, and the counters split the
    W * N rows into gathered and skipped."""
    c, n = 4, 37
    rng = np.random.default_rng(0x5B)
    vals = [int(b) for b in rng.integers(0, 2, size=n)]
    if case == "zero_window":  # two dense scalars; windows 2 and 3 cleared leave 3 no carry
        vals[:2] = [(int.from_bytes(rng.bytes(32), "little") % R_SCALAR) & ~(0xFF << 8)
                    for _ in range(2)]
    pts = _points(n)
    want = {}
    for p, v in zip(pts, vals):
        for w, d in enumerate(_signed_digits(v, c)):
            if d:
                want[w, abs(d)] = rc.G1.add(want.get((w, abs(d))), rc.G1.neg(p) if d < 0 else p)
    W, B = tmsm.num_windows(c), tmsm.bucket_count(c, signed=True)
    assert all(d == 0 for v in vals for d in _signed_digits(v, c)[3:4])
    sc = torch.from_numpy(tl.ints_to_words(vals))
    tmsm.reset_counters()
    got = tmsm.bucket_sums([torch.from_numpy(cv.encode_g1_affine(pts))],
                           [tmsm.window_orders_signed(sc, c)], c, signed=True)[0]
    assert cv.decode_g1_proj(got) == [want.get((w, j)) for w in range(W) for j in range(B)]
    rows = sum(d != 0 for v in vals for d in _signed_digits(v, c))
    assert tmsm.BUCKET_ROWS == {"g1": rows, "g2": 0}
    assert tmsm.BUCKET_SKIPPED == {"g1": W * n - rows, "g2": 0}
