"""circom_compat_tpu_torch MSM (ops/msm.py) against the JAX package.

Window digits, the window-bit choice and the Pippenger window sums of the
port (all windows of all MSMs over one group in one bucket reduce) are held
against msm.window_digits, msm.pick_window_bits and
msm.window_sums_affine_impl (XLA) at about 300 points with w = 8, and the
folded MSMs against sum_i s_i P_i on the host. The standalone msm_g1 is
held against the JAX msm_g1 (XLA) at 48 points, with the operands carried
across by convert.affine_words_from_limbs, and msm_g2 against the JAX
package's host G2.msm (its XLA msm_g2 rides the slow tier: a two-minute
build); both give None for empty input and all-zero scalars. bucket_sums gathers
only rows of nonzero digit: at N = 37 and w = 4, on bit scalars, all-zero
scalars and one empty window between full ones (G1) and bit scalars
(G2), bucket 0 is the identity, every other bucket the host's sum and
the row counters split W * N into gathered and skipped; msm_g1 on a few
dense scalars and bits equals sum_i s_i P_i. Inputs (scalars, points with
infinity rows, zero scalars) come from a numpy seed and are fed to both
packages. Tolerance: exact equality of affine group elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_compat_tpu.constants import R_SCALAR
from circom_compat_tpu.ops import curve_jax as cj
from circom_compat_tpu.ops import msm as jmsm
from circom_compat_tpu.refmath import curve as jrc
from circom_compat_tpu_torch import convert
from circom_compat_tpu_torch.ops import curve as cv
from circom_compat_tpu_torch.ops import limbs as tl
from circom_compat_tpu_torch.ops import msm as tmsm
from circom_compat_tpu_torch.refmath import curve as rc

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
RNG = np.random.default_rng(0x3D5)
N = 300
WBITS = 8


def _scalars(n):
    vals = [int.from_bytes(RNG.bytes(32), "little") % R_SCALAR for _ in range(n)]
    vals[1] = 0
    vals[2] = R_SCALAR - 1
    return vals


def _points(g2, n):
    grp, gen = (rc.G2, rc.g2_generator()) if g2 else (rc.G1, rc.g1_generator())
    pool = [grp.mul(gen, int(k)) for k in RNG.integers(1, 1 << 62, size=16)]
    pts = [pool[i] for i in RNG.integers(0, 16, size=n)]
    pts[0] = pts[7] = None
    return grp, pts


def _xy(g2, pts):
    return torch.from_numpy(cv.encode_g2_affine(pts) if g2 else cv.encode_g1_affine(pts))


def _jax_window_sums(g2, xy, scalars):
    F = cj.FQ2_ADAPTER if g2 else cj.FQ_ADAPTER
    u16 = np.ascontiguousarray(xy.numpy()).view("<u2")
    sc = jnp.asarray(np.ascontiguousarray(scalars.numpy()).view("<u2").astype(np.uint32))
    fn = jax.jit(jmsm.window_sums_affine_impl, static_argnums=(0, 4, 5, 6))
    sums = fn(F, jnp.asarray(u16[:, 0]), jnp.asarray(u16[:, 1]), sc, WBITS, jmsm.CHUNK_POINTS, False)
    return cj.decode_g2_proj(sums) if g2 else cj.decode_g1_proj(sums)


@pytest.mark.parametrize("wbits", [8, 13])
def test_window_digits_vs_jax(wbits):
    sc = torch.from_numpy(tl.ints_to_words(_scalars(64)))
    got = tmsm.window_digits(sc, wbits)
    limbs = jnp.asarray(np.ascontiguousarray(sc.numpy()).view("<u2").astype(np.uint32))
    assert got.tolist() == np.asarray(jmsm.window_digits(limbs, wbits)).tolist()
    orders, keys = tmsm.window_orders(sc, wbits)
    assert torch.equal(torch.gather(got, 1, orders), keys)
    assert bool((keys[:, 1:] >= keys[:, :-1]).all())


def test_pick_window_bits_matches_jax():
    for log_n in (8, 10, 14, 16, 20, 22):
        assert tmsm.pick_window_bits(1 << log_n) == jmsm.pick_window_bits(1 << log_n)
    assert tmsm.pick_window_bits(1 << 20) == 13


def test_g1_window_sums_vs_jax_and_host():
    """Two G1 MSMs through one batched bucket reduce; each window sum equals
    the JAX package's, and each Horner fold equals sum_i s_i P_i."""
    grp, pts_a = _points(False, N)
    _, pts_b = _points(False, N // 2)
    sc_a, sc_b = _scalars(N), _scalars(N // 2)
    wa, wb = (torch.from_numpy(tl.ints_to_words(s)) for s in (sc_a, sc_b))
    xa, xb = _xy(False, pts_a), _xy(False, pts_b)
    sums = tmsm.window_sums([xa, xb], [tmsm.window_orders(wa, WBITS), tmsm.window_orders(wb, WBITS)],
                            WBITS)
    assert sums.shape == (2, tmsm.num_windows(WBITS), 3, 8)
    got_a = cv.decode_g1_proj(sums[0])
    assert got_a == _jax_window_sums(False, xa, wa)
    for got, pts, sc in ((got_a, pts_a, sc_a), (cv.decode_g1_proj(sums[1]), pts_b, sc_b)):
        want = None
        for p, s in zip(pts, sc):
            want = grp.add(want, grp.mul(p, s) if p is not None else None)
        assert tmsm.fold_windows_host(got, grp, WBITS) == want


def test_g2_msm_vs_host():
    """w = 5 keeps the plain G2 bucket scans short on the CPU."""
    grp, pts = _points(True, 120)
    sc = _scalars(120)
    w = torch.from_numpy(tl.ints_to_words(sc))
    sums = tmsm.window_sums([_xy(True, pts)], [tmsm.window_orders(w, 5)], 5)[0]
    want = None
    for p, s in zip(pts, sc):
        if p is not None:
            want = grp.add(want, grp.mul(p, s))
    assert tmsm.fold_windows_host(cv.decode_g2_proj(sums), grp, 5) == want


def test_bucket_sums_counts_rows_and_calls():
    """bucket_sums adds the rows whose digit is nonzero (those it gathers)
    to BUCKET_ROWS, the digit-0 rows it leaves out to BUCKET_SKIPPED (the
    two sum to sum_m W * N_m) and one call to its group's counters, and
    leaves the launch counters as they were; reset_counters clears them."""
    from circom_compat_tpu_torch.ops import curve_kernels as ck
    from circom_compat_tpu_torch.ops import field_kernels as fk

    tmsm.reset_counters()
    launches = {**fk.LAUNCHES, **ck.LAUNCHES}
    W = tmsm.num_windows(WBITS)
    nonzero = {}
    for g2, sizes in ((False, (12, 9)), (True, (8,))):
        xys, sorts = [], []
        for n in sizes:
            xys.append(_xy(g2, _points(g2, n)[1]))
            words = torch.from_numpy(tl.ints_to_words(_scalars(n)))
            sorts.append(tmsm.window_orders(words, WBITS))
            key = "g2" if g2 else "g1"
            nonzero[key] = nonzero.get(key, 0) + int((tmsm.window_digits(words, WBITS) != 0).sum())
        tmsm.bucket_sums(xys, sorts, WBITS)
    assert tmsm.BUCKET_ROWS == nonzero
    assert tmsm.BUCKET_SKIPPED == {"g1": W * 21 - nonzero["g1"], "g2": W * 8 - nonzero["g2"]}
    assert tmsm.BUCKET_CALLS == {"g1": 1, "g2": 1}
    assert {**fk.LAUNCHES, **ck.LAUNCHES} == launches
    tmsm.reset_counters()
    assert tmsm.BUCKET_ROWS == tmsm.BUCKET_SKIPPED == tmsm.BUCKET_CALLS == {"g1": 0, "g2": 0}


@pytest.mark.slow
def test_g2_window_sums_vs_jax():
    """The XLA build of the G2 window sums takes about two minutes here."""
    _, pts = _points(True, N)
    w = torch.from_numpy(tl.ints_to_words(_scalars(N)))
    xy = _xy(True, pts)
    sums = tmsm.window_sums([xy], [tmsm.window_orders(w, WBITS)], WBITS)[0]
    assert cv.decode_g2_proj(sums) == _jax_window_sums(True, xy, w)


def _jax_operands(g2, xy):
    """The port's affine words as the JAX msm's (x, y) 16-bit limbs."""
    u16 = np.ascontiguousarray(xy.numpy()).view("<u2")
    return u16[:, 0].astype(np.uint32), u16[:, 1].astype(np.uint32)


def test_msm_g1_vs_jax():
    grp, pts = _points(False, 48)
    sc = _scalars(48)
    xy = _xy(False, pts)
    jx, jy = _jax_operands(False, xy)
    assert np.array_equal(convert.affine_words_from_limbs(jx, jy), xy.numpy())
    got = tmsm.msm_g1(xy, sc, window_bits=5, device="cpu")
    assert got == jmsm.msm_g1((jnp.asarray(jx), jnp.asarray(jy)), sc, window_bits=5)
    assert got == grp.msm(pts, sc) and got is not None
    # a tensor of canonical words gives the same sum; all-zero scalars give None
    words = torch.from_numpy(tl.ints_to_words(sc))
    assert tmsm.msm_g1(xy, words, window_bits=5, device="cpu") == got
    zeros = [0] * 48
    assert tmsm.msm_g1(xy, zeros, window_bits=5, device="cpu") is None
    assert jmsm.msm_g1((jnp.asarray(jx), jnp.asarray(jy)), zeros, window_bits=5) is None


def test_msm_g2_vs_jax_host():
    _, pts = _points(True, 24)
    sc = _scalars(24)
    xy = _xy(True, pts)
    jx, jy = _jax_operands(True, xy)
    assert np.array_equal(convert.affine_words_from_limbs(jx, jy), xy.numpy())
    got = tmsm.msm_g2(xy, sc, window_bits=4, device="cpu")
    assert got == jrc.G2.msm(pts, sc) and got is not None


@pytest.mark.slow
def test_msm_g2_vs_jax():
    """The XLA build of the JAX msm_g2 takes minutes here."""
    _, pts = _points(True, 24)
    sc = _scalars(24)
    xy = _xy(True, pts)
    jx, jy = _jax_operands(True, xy)
    assert tmsm.msm_g2(xy, sc, window_bits=4, device="cpu") == \
        jmsm.msm_g2((jnp.asarray(jx), jnp.asarray(jy)), sc, window_bits=4)


def test_msm_empty_and_device_rule(monkeypatch):
    for g2, fn, jfn in ((False, tmsm.msm_g1, jmsm.msm_g1), (True, tmsm.msm_g2, jmsm.msm_g2)):
        empty = _xy(g2, [])
        assert fn(empty, [], device="cpu") is None
        jx, jy = _jax_operands(g2, empty)
        assert jfn((jnp.asarray(jx), jnp.asarray(jy)), []) is None
    _, pts = _points(False, 8)
    with pytest.raises(ValueError, match="7 scalars for 8 points"):
        tmsm.msm_g1(_xy(False, pts), list(range(7)), device="cpu")
    with pytest.raises(ValueError, match="affine words"):
        tmsm.msm_g2(_xy(False, pts), list(range(8)), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        tmsm.msm_g1(_xy(False, pts), list(range(8)))



SKIP_RNG = np.random.default_rng(0xB0)
SKIP_N, SKIP_W = 37, 4  # N not a multiple of the tile of 16


def _dense(n):
    return [int.from_bytes(SKIP_RNG.bytes(32), "little") % R_SCALAR for _ in range(n)]


def _bits(n):
    return [int(b) for b in SKIP_RNG.integers(0, 2, size=n)]


# Scalars whose digits are 0 in most rows, in every row, and in one whole
# window between windows that hold rows. Few dense scalars: the plain
# reduce's cost grows with its levels, which grow with the rows kept.
SKIP_CASES = {
    "bits": lambda: _bits(SKIP_N),
    "all_zero": lambda: [0] * SKIP_N,
    "zero_window": lambda: [v & ~(0xF << (3 * SKIP_W)) for v in _dense(2)] + _bits(SKIP_N - 2),
}


def _host_buckets(grp, pts, vals, c):
    """{(window, digit): sum of the points} over the nonzero digits, from the ints."""
    out = {}
    for p, v in zip(pts, vals):
        for w in range(tmsm.num_windows(c)):
            d = (v >> (w * c)) & ((1 << c) - 1)
            if d:
                out[w, d] = grp.add(out.get((w, d)), p)
    return out


@pytest.mark.parametrize("g2,case", [(False, c) for c in SKIP_CASES] + [(True, "bits")],
                         ids=[f"g1-{c}" for c in SKIP_CASES] + ["g2-bits"])
def test_bucket_sums_skip_digit_zero(g2, case):
    """bucket_sums gathers the rows of nonzero digit alone: bucket 0 of every
    window is the identity, every other bucket the host's sum of its points,
    BUCKET_ROWS counts the nonzero digits and BUCKET_SKIPPED the other rows
    of the W * N."""
    grp, pts = _points(g2, SKIP_N)
    vals = SKIP_CASES[case]()
    words = torch.from_numpy(tl.ints_to_words(vals))
    tmsm.reset_counters()
    got = tmsm.bucket_sums([_xy(g2, pts)], [tmsm.window_orders(words, SKIP_W)], SKIP_W)[0]
    W, B = tmsm.num_windows(SKIP_W), 1 << SKIP_W
    want = _host_buckets(grp, pts, vals, SKIP_W)
    decoded = cv.decode_g2_proj(got) if g2 else cv.decode_g1_proj(got)
    assert decoded == [want.get((w, j)) for w in range(W) for j in range(B)]
    rows = sum((v >> (w * SKIP_W)) & (B - 1) != 0 for v in vals for w in range(W))
    group, other = ("g2", "g1") if g2 else ("g1", "g2")
    assert tmsm.BUCKET_ROWS == {group: rows, other: 0}
    assert tmsm.BUCKET_SKIPPED == {group: W * SKIP_N - rows, other: 0}


def test_msm_g1_on_dense_and_bits():
    """The standalone MSM and its window sums through the skip: a few dense
    scalars, then bits and zeros."""
    grp, pts = _points(False, SKIP_N)
    vals = _dense(3) + _bits(SKIP_N - 3)
    assert tmsm.msm_g1(_xy(False, pts), vals, window_bits=2, device="cpu") == grp.msm(pts, vals)
