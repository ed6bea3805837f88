"""circom_compat_tpu_torch segmented scans (ops/segments.py) against the
JAX package.

  - reduce_by_sorted_key / segmented_scan with the Fr-add combine and the
    K2 tile scan, against JAX segments with field_jax.add (XLA), deep enough
    that Phase B recurses;
  - the same with the point-add combine and K8, against refmath sums;
  - inclusive_scan and fold, against JAX segments and refmath.

Inputs come from a numpy seed and are fed to both packages. Tolerance:
exact equality of canonical field values and of affine group elements.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_compat_tpu.constants import R_SCALAR
from circom_compat_tpu.ops import field_jax as fj
from circom_compat_tpu.ops import segments as jseg
from circom_compat_tpu_torch.ops import curve as cv
from circom_compat_tpu_torch.ops import curve_kernels as ck
from circom_compat_tpu_torch.ops import field_kernels as fk
from circom_compat_tpu_torch.ops import limbs as tl
from circom_compat_tpu_torch.ops import segments as tseg
from circom_compat_tpu_torch.refmath import curve as rc

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
RNG = np.random.default_rng(0x5E6)


def _fr_vals(n):
    return [int.from_bytes(RNG.bytes(32), "little") % R_SCALAR for _ in range(n)]


def _fr_add(a, b):
    return fk.fr_binary("add", a, b)


def _canon(words):
    return [v % R_SCALAR for v in tl.words_to_ints(np.asarray(words).reshape(-1, 8))]


def _jax_canon(limbs):
    arr = np.ascontiguousarray(np.asarray(limbs).astype("<u2")).view("<i4")
    return _canon(arr)


def test_segment_flags():
    keys = torch.tensor([0, 0, 1, 3, 3, 7])
    want = np.asarray(jseg.segment_flags(jnp.asarray(keys.numpy()))).tolist()
    assert tseg.segment_flags(keys).tolist() == want == [True, False, True, True, False, True]


@pytest.mark.parametrize("n,segs", [(20, 6), (1000, 40), (3000, 700)])
def test_fr_reduce_by_sorted_key_vs_jax(n, segs):
    vals = _fr_vals(n)
    keys = np.sort(RNG.integers(0, segs, size=n))
    words = torch.from_numpy(tl.ints_to_words([v * (1 << 256) % R_SCALAR for v in vals]))
    zero = torch.zeros(8, dtype=torch.int32)
    got = tseg.reduce_by_sorted_key(_fr_add, words, torch.from_numpy(keys), segs, zero,
                                    fk.fr_tile_scan, fk.fr_tile_scan)
    limbs = jnp.asarray(np.asarray(words).view("<u2").astype(np.uint32))
    want = jseg.reduce_by_sorted_key(lambda a, b: fj.add(fj.FR, a, b), limbs,
                                     jnp.asarray(keys.astype(np.int32)), segs,
                                     jnp.zeros(16, jnp.uint32))
    assert _canon(got) == _jax_canon(want)
    sums = [0] * segs
    for k, v in zip(keys.tolist(), vals):
        sums[k] = (sums[k] + v) % R_SCALAR
    assert _canon(got) == [s * (1 << 256) % R_SCALAR for s in sums]


def test_fr_segmented_scan_vs_jax():
    n = 700
    words = torch.from_numpy(tl.ints_to_words(_fr_vals(n)))
    flags = torch.from_numpy(RNG.random(n) < 0.05)
    flags[0] = True
    zero = torch.zeros(8, dtype=torch.int32)
    got = tseg.segmented_scan(_fr_add, words, flags, zero, fk.fr_tile_scan, fk.fr_tile_scan)
    limbs = jnp.asarray(np.asarray(words).view("<u2").astype(np.uint32))
    want = jseg.segmented_scan(lambda a, b: fj.add(fj.FR, a, b), limbs,
                               jnp.asarray(flags.numpy()), jnp.zeros(16, jnp.uint32))
    assert _canon(got) == _jax_canon(want)


@pytest.mark.parametrize("n", [1, 30, 33, 600])
def test_fr_inclusive_scan_and_fold_vs_jax(n):
    vals = _fr_vals(n)
    words = torch.from_numpy(tl.ints_to_words(vals))
    zero = torch.zeros(8, dtype=torch.int32)
    limbs = jnp.asarray(np.asarray(words).view("<u2").astype(np.uint32))
    jadd = lambda a, b: fj.add(fj.FR, a, b)  # noqa: E731
    scan = tseg.inclusive_scan(_fr_add, words, zero, fk.fr_tile_scan)
    assert _canon(scan) == _jax_canon(jseg.inclusive_scan(jadd, limbs, jnp.zeros(16, jnp.uint32)))
    total = tseg.fold(_fr_add, words, zero, fk.fr_tile_scan)
    assert _canon(total) == _jax_canon(jseg.fold(jadd, limbs, jnp.zeros(16, jnp.uint32)))
    assert _canon(total) == [sum(vals) % R_SCALAR]


def test_point_fold():
    pts = _g1_points(100)
    P = cv.affine_to_proj(torch.from_numpy(cv.encode_g1_affine(pts)), False)
    total = tseg.fold(ck.point_add, P, cv.proj_identity_const(False), ck.point_tile_scan)
    want = None
    for p in pts:
        want = rc.G1.add(want, p)
    assert cv.decode_g1_proj(total) == [want]


def _g1_points(n):
    return [rc.G1.mul(rc.g1_generator(), int(k)) for k in RNG.integers(1, 1 << 62, size=n)]


def test_point_reduce_by_sorted_key():
    """Bucket sums through K8 (mixed leaf, general deeper) and K6."""
    n, segs = 600, 37
    pts = _g1_points(n)
    pts[3] = None
    keys = np.sort(RNG.integers(0, segs, size=n))
    P = cv.affine_to_proj(torch.from_numpy(cv.encode_g1_affine(pts)), False)
    got = tseg.reduce_by_sorted_key(
        ck.point_add, P, torch.from_numpy(keys), segs, cv.proj_identity_const(False),
        lambda vt, ft: ck.point_tile_scan(vt, ft, mixed=True), ck.point_tile_scan)
    want = [None] * segs
    for k, p in zip(keys.tolist(), pts):
        want[k] = rc.G1.add(want[k], p)
    assert cv.decode_g1_proj(got) == want
