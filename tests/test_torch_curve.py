"""circom_compat_tpu_torch point addition and point tile scan (K6/K7 and K8
plain versions) against the JAX package: curve_jax's RCB formulas (XLA), the
Pallas kernels in interpret mode (g1/g2_add_pallas and the mixed
g1/g2_madd_pallas built by make_pallas_add, and make_tile_scan in its mixed
leaf and general forms, as tests/test_curve_pallas.py builds them), and
refmath.

Rows cover general points, the identity on either side, doubling (P + P)
and inverses (P + (-P)); the scans put a doubling and an inverse inside a
segment. Inputs are made from a numpy seed and fed to both packages.
Tolerance: exact equality of the affine group elements (all
arithmetic is integer; projective representatives may differ by a scale),
and against curve_jax's XLA scan of the same flags, of every projective
coordinate mod q.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_compat_tpu.ops import curve_jax as cj
from circom_compat_tpu.ops import curve_pallas as cp
from circom_compat_tpu_torch.ops import curve as cv
from circom_compat_tpu_torch.constants import Q
from circom_compat_tpu_torch.ops import curve_kernels as ck
from circom_compat_tpu_torch.ops import limbs as tl
from circom_compat_tpu_torch.refmath import curve as rc

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
RNG = np.random.default_rng(0xFA11A5)


def _group(g2):
    return (rc.G2, rc.g2_generator()) if g2 else (rc.G1, rc.g1_generator())


def _operands(g2, n=24):
    """(P list, Q list) of affine points (None = infinity) with general rows,
    identity rows, doublings and inverses."""
    grp, gen = _group(g2)
    pts = [grp.mul(gen, int(k)) for k in RNG.integers(1, 1 << 62, size=n)]
    p_list, q_list = list(pts), pts[3:] + pts[:3]
    p_list[0] = None
    q_list[1] = None
    p_list[2] = q_list[2] = None
    q_list[3] = p_list[3]  # P + P
    q_list[4] = grp.neg(p_list[4])  # P + (-P)
    q_list[5] = p_list[5]
    return p_list, q_list


def _proj(g2, pts):
    enc = cv.encode_g2_affine(pts) if g2 else cv.encode_g1_affine(pts)
    return cv.affine_to_proj(torch.from_numpy(enc), g2)


def _scaled(P):
    """Another representative of the same points, with Z != 1: P + identity."""
    ident = cv.proj_identity_const(ck.is_g2(P)).expand_as(P).contiguous()
    return ck.point_add_plain(P, ident)


def _to_jax(P):
    """(n, 3, *coord, 8) port words -> the JAX (X, Y, Z) tuple of 16-bit limbs."""
    arr = np.ascontiguousarray(P.numpy())
    return tuple(jnp.asarray(arr[:, i].view("<u2").astype(np.uint32)) for i in range(3))


def _decode(g2, P):
    return (cv.decode_g2_proj if g2 else cv.decode_g1_proj)(P)


def _decode_jax(g2, pt):
    return cj.decode_g2_proj(pt) if g2 else cj.decode_g1_proj(pt)


@pytest.mark.parametrize("mixed", [False, True], ids=["add", "madd"])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_point_add_vs_curve_jax(g2, mixed):
    grp, _ = _group(g2)
    p_list, q_list = _operands(g2)
    P, Q = _proj(g2, p_list), _proj(g2, q_list)
    if not mixed:
        P, Q = _scaled(P), _scaled(Q)
    got = ck.point_add(P, Q, mixed=mixed)
    F = cj.FQ2_ADAPTER if g2 else cj.FQ_ADAPTER
    fn = cj.proj_madd if mixed else cj.proj_add
    want = jax.jit(partial(fn, F))(_to_jax(P), _to_jax(Q))
    expected = [grp.add(a, b) for a, b in zip(p_list, q_list)]
    assert _decode(g2, got) == expected
    assert _decode_jax(g2, want) == expected


def _vs_pallas(g2, mixed):
    grp, _ = _group(g2)
    p_list, q_list = _operands(g2)
    P, Q = _proj(g2, p_list), _proj(g2, q_list)
    if not mixed:
        P = _scaled(P)
    got = ck.point_add(P, Q, mixed=mixed)
    want = cp.make_pallas_add(g2, block=128, mixed=mixed)(_to_jax(P), _to_jax(Q))
    expected = [grp.add(a, b) for a, b in zip(p_list, q_list)]
    assert _decode(g2, got) == _decode_jax(g2, want) == expected


@pytest.mark.parametrize("mixed", [False, True], ids=["add", "madd"])
def test_g1_point_add_vs_pallas(mixed):
    """K6/K7 G1 plain version vs g1_add_pallas / g1_madd_pallas (interpret)."""
    _vs_pallas(False, mixed)


@pytest.mark.slow
@pytest.mark.parametrize("mixed", [False, True], ids=["add", "madd"])
def test_g2_point_add_vs_pallas(mixed):
    """The G2 Pallas kernels take minutes to build in interpret mode, as in
    tests/test_curve_pallas.py; the smoke tier holds G2 against curve_jax."""
    _vs_pallas(True, mixed)


def test_affine_to_proj_and_identity():
    """Zero rows map to (0, 1, 0); the identity decodes to infinity."""
    for g2 in (False, True):
        grp, gen = _group(g2)
        pts = [None, gen, grp.mul(gen, 5)]
        P = _proj(g2, pts)
        assert torch.equal(P[0], cv.proj_identity_const(g2))
        assert _decode(g2, P) == pts
        assert _decode(g2, ck.point_add(P, P)) == [grp.add(p, p) for p in pts]


def _xla_tile_scan(g2, mixed, jv, flags):
    """The tile scan as curve_jax's XLA proj_madd / proj_add applied step by
    step with the same flags: (out, carry) as JAX (X, Y, Z) tuples."""
    F = cj.FQ2_ADAPTER if g2 else cj.FQ_ADAPTER
    step = jax.jit(partial(cj.proj_madd if mixed else cj.proj_add, F))
    T, K = flags.shape
    acc, outs = cj.proj_infinity(F, (T,)), []
    for k in range(K):
        x = tuple(c[:, k] for c in jv)
        acc = tuple(F.select(jnp.asarray(flags[:, k]), a, b) for a, b in zip(x, step(acc, x)))
        outs.append(acc)
    return tuple(jnp.stack(c, axis=1) for c in zip(*outs)), acc


def _coords_mod_q(P):
    """Every coordinate word row of a port point tensor as an int mod q."""
    return [v % Q for v in tl.words_to_ints(np.ascontiguousarray(P.numpy()).reshape(-1, 8))]


def _jax_coords_mod_q(g2, pt):
    """The same for JAX (X, Y, Z) 16-bit limbs (canonical in curve_jax)."""
    limbs = np.stack([np.asarray(c) for c in pt], axis=-3 if g2 else -2).astype("<u2")
    return _coords_mod_q(torch.from_numpy(limbs.view("<i4").copy()))


def _tile_case(g2, mixed, T=3, K=16, reference="pallas"):
    """point_tile_scan on CPU tensors (its plain version) against the JAX
    package's Pallas tile scan (interpret mode) or its XLA formulas step by
    step, and against refmath."""
    grp, gen = _group(g2)
    pts = [grp.mul(gen, int(k)) for k in RNG.integers(1, 1 << 62, size=T * K)]
    pts[5] = None
    pts[4] = pts[3]  # position 3 starts a segment: acc + P is a doubling
    pts[11] = grp.neg(pts[10])  # position 10 starts one: acc + (-acc)
    P = _proj(g2, pts)
    if not mixed:  # general operands
        P = _scaled(P)
    flags = np.array([(i % K == 0) or (i % 7 == 3) for i in range(T * K)]).reshape(T, K)
    vt = P.reshape((T, K) + P.shape[1:])
    out, carry = ck.point_tile_scan(vt, torch.from_numpy(flags), mixed=mixed)
    jv = tuple(c.reshape((T, K) + c.shape[1:]) for c in _to_jax(P))
    if reference == "pallas":
        j_out, j_carry = cp.make_tile_scan(g2, block=128, mixed=mixed)(jv, jnp.asarray(flags))
    else:
        j_out, j_carry = _xla_tile_scan(g2, mixed, jv, flags)
        # the same projective representatives: curve_jax reduces fully, the
        # port keeps lazy [0, 2q) words, so coordinates agree mod q
        assert _coords_mod_q(out) == _jax_coords_mod_q(g2, j_out)
        assert _coords_mod_q(carry) == _jax_coords_mod_q(g2, j_carry)
    want_out, acc = [], None
    for p, f in zip(pts, flags.reshape(-1)):
        acc = p if f else grp.add(acc, p)
        want_out.append(acc)
    assert _decode(g2, out) == _decode_jax(g2, j_out) == want_out
    assert _decode(g2, carry) == _decode_jax(g2, j_carry) == want_out[K - 1 :: K]


@pytest.mark.parametrize("mixed", [True, False], ids=["madd", "add"])
def test_g1_tile_scan_vs_pallas(mixed):
    """K8 G1 plain version vs g1_tile_scan_madd / g1_tile_scan (interpret)."""
    _tile_case(False, mixed)


@pytest.mark.parametrize("mixed", [True, False], ids=["madd", "add"])
def test_g2_tile_scan_vs_curve_jax(mixed):
    """K8 G2 plain version, the spec of the G2 kernels, vs curve_jax's XLA
    proj_madd / proj_add step by step: every projective coordinate equal mod
    q, and the group elements equal to refmath's. Segments hold a doubling and an inverse; row 5 is the
    identity."""
    _tile_case(True, mixed, T=2, reference="xla")


@pytest.mark.slow
def test_g2_tile_scan_vs_pallas():
    """G2 Pallas tile scans take minutes to build in interpret mode."""
    _tile_case(True, True, T=2, K=8)


def _ptxas_lines(prefix):
    """A synthetic `-Xptxas -v` log of the four entry kernels <prefix>_<group>_<mode>."""
    lines = []
    for i, name in enumerate(f"{prefix}_{g}_{m}" for g in ("g1", "g2") for m in ("madd", "add")):
        lines += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    0 bytes stack frame, {8 * i} bytes spill stores, {4 * i} bytes spill loads",
                  f"ptxas info    : Used {120 + i} registers, used 1 barriers, 5120 bytes smem"]
    return lines


def test_tile_scan_resources_from_ptxas_log(tmp_path):
    """The K8 entry kernels' registers and spills, as chip_smoke.py reads
    them from nvcc's `-Xptxas -v` log; a missing kernel raises."""
    from circom_compat_tpu_torch import _build

    lines = _ptxas_lines("ccf_tile_scan")
    log = tmp_path / "curve_kernels.ptxas.txt"
    log.write_text("\n".join(lines) + "\n")
    res = ck.tile_scan_resources(_build.ptxas_report(log))
    assert res["g1"]["madd"] == {"registers": 120, "spill_stores": 0, "spill_loads": 0}
    assert res["g2"]["add"] == {"registers": 123, "spill_stores": 24, "spill_loads": 12}
    log.write_text("\n".join(lines[:4]) + "\n")
    with pytest.raises(KeyError):
        ck.tile_scan_resources(_build.ptxas_report(log))


def test_point_add_resources_from_ptxas_log(tmp_path):
    """The K6/K7 entry kernels' rows, read from the same log as K8's: each
    reader takes its own four kernels, and a missing one raises."""
    from circom_compat_tpu_torch import _build

    add_lines, scan_lines = _ptxas_lines("ccf_point_add"), _ptxas_lines("ccf_tile_scan")
    log = tmp_path / "curve_kernels.ptxas.txt"
    log.write_text("\n".join(scan_lines + add_lines) + "\n")
    report = _build.ptxas_report(log)
    res = ck.point_add_resources(report)
    assert res["g1"]["madd"] == {"registers": 120, "spill_stores": 0, "spill_loads": 0}
    assert res["g2"]["madd"] == {"registers": 122, "spill_stores": 16, "spill_loads": 8}
    assert res == ck.tile_scan_resources(report)  # the same synthetic rows under other names
    log.write_text("\n".join(scan_lines + add_lines[:-4]) + "\n")
    with pytest.raises(KeyError):
        ck.point_add_resources(_build.ptxas_report(log))
