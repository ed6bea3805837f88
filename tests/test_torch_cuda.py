"""Card tests: every CUDA kernel of circom_compat_tpu_torch against its plain
PyTorch version on the same CUDA tensors, word for word, the chain254
golden proof proved on the card, setup -> prove -> verify at a 2^13
domain (the flat NTT chain) on the card, the standalone msm_g1 / msm_g2 at
2^12 points against a known-dlog sum, and Groth16.prove of the chain254
circuit.

They need an NVIDIA GPU and skip without one. On a machine with a card:
    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_cuda.py
(--noconftest: tests/conftest.py configures JAX, which the card machine
does not need.)
"""

import json
import pathlib
import random

import pytest
import torch

from circom_compat_tpu_torch.constants import R_SCALAR
from circom_compat_tpu_torch.ops import curve as cv
from circom_compat_tpu_torch.ops import curve_kernels as ck
from circom_compat_tpu_torch.ops import field_kernels as fk
from circom_compat_tpu_torch.ops import limbs as lc
from circom_compat_tpu_torch.refmath import curve as rc

GOLDEN = pathlib.Path(__file__).parent / "golden"
RNG = random.Random(0xC0DA)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _lazy_words(n, p, dev):
    vals = [0, 1, p - 1, 2 * p - 1] + [RNG.randrange(2 * p) for _ in range(n - 4)]
    return torch.from_numpy(lc.ints_to_words(vals)).to(dev)


def _same(a, b):
    assert torch.equal(a.cpu(), b.cpu())


def _edge_words(n, p, dev, stride=1, canonical=False):
    """n words cycling through the field core's edge values 0, 1, p-1, 2p-1
    (p-2 for 2p-1 when canonical; element i takes value (i // stride) % 4)."""
    edges = [0, 1, p - 1, p - 2 if canonical else 2 * p - 1]
    return torch.from_numpy(lc.ints_to_words([edges[(i // stride) % 4] for i in range(n)])).to(dev)


def _edge_points(g2, n, dev):
    """n points whose every coordinate word row is an edge value, all
    combinations of them over 4^(coords) rows."""
    from circom_compat_tpu_torch.constants import Q

    coords = 6 if g2 else 3
    cols = [_edge_words(n, Q, dev, 4**j) for j in range(coords)]
    return torch.stack(cols, 1).reshape((n, 3) + ((2,) if g2 else ()) + (8,)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["mul", "mul_canon", "add", "sub"])
def test_fr_binary(cuda, op):
    a, b = _lazy_words(1000, R_SCALAR, cuda), _lazy_words(1000, R_SCALAR, cuda)
    _same(fk.fr_binary(op, a, b), fk.fr_binary_plain(op, a, b))
    _same(fk.fr_binary(op, a, b[3]), fk.fr_binary_plain(op, a, b[3]))


@pytest.mark.cuda
def test_fr_tile_scan(cuda):
    vt = _lazy_words(300 * 16, R_SCALAR, cuda).reshape(300, 16, 8)
    ft = torch.rand(300, 16, device=cuda) < 0.3
    out, carry = fk.fr_tile_scan(vt, ft)
    want_out, want_carry = fk.fr_tile_scan_plain(vt, ft)
    _same(out, want_out)
    _same(carry, want_carry)


TILE_SCAN_T = ["1", "300", "batch+1", "2^16"]


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("case", TILE_SCAN_T)
def test_fr_tile_scan_batches(cuda, case, density):
    """The staged scan at T = 1, a ragged last batch (300 tiles, one batch
    and one tile) and T = 2^16 (several batches a block of the persistent
    grid), with flag densities 0, 0.3 and 1; tile 0 has no flag at all."""
    batch = fk.tile_scan_launch_shape(cuda)["tiles_per_batch"]
    T = {"1": 1, "300": 300, "batch+1": batch + 1, "2^16": 1 << 16}[case]
    vt = _lazy_words(T * 16, R_SCALAR, cuda).reshape(T, 16, 8)
    ft = torch.rand(T, 16, device=cuda) < density
    ft[0] = False
    for got, want in zip(fk.fr_tile_scan(vt, ft), fk.fr_tile_scan_plain(vt, ft)):
        _same(got, want)


def _upper_lazy_words(n, p, dev):
    """n words at the top of the lazy range: values in [p, 2p), led by p and
    2p - 1."""
    vals = [p, 2 * p - 1] + [RNG.randrange(p, 2 * p) for _ in range(n - 2)]
    return torch.from_numpy(lc.ints_to_words(vals[:n])).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("L,rows", [(L, rows) for L in (1, 2, 4, 16, 512, 1024, 2048, 4096)
                                    for rows in ((1, 3, 1000) if L <= 1024 else (1, 3))])
def test_ntt_rows(cuda, L, rows):
    """Every mode at every row length the wrapper takes, on 1, 3 and 1000
    rows (1000: a ragged last block for every block shape), with operands
    at the top of the lazy range: word for word equal to the plain version."""
    from circom_compat_tpu_torch.ops import ntt

    root = ntt.fr_root_of_unity(L) if L > 1 else 1
    tw_inv, tw_fwd = (torch.from_numpy(ntt._power_table(w, max(L // 2, 1))).to(cuda)
                      for w in (pow(root, -1, R_SCALAR), root))
    x, pre, post, mid = (_upper_lazy_words(rows * L, R_SCALAR, cuda).reshape(rows, L, 8)
                         for _ in range(4))
    # the four-step chain's five modes (ops/ntt.py witness_map_four_step),
    # the flat chain's DIF-only rows, DIT only
    cases = {
        "dif_pre_post_mul": dict(tw_dif=tw_inv, pre=pre, post=post),
        "mid": dict(tw_dif=tw_inv, mid=mid, tw_dit=tw_fwd),
        "dit_pre": dict(tw_dit=tw_fwd, pre=pre),
        "dit_pre_post_mul": dict(tw_dit=tw_fwd, pre=pre, post=post),
        "dit_pre_post_sub": dict(tw_dit=tw_fwd, pre=pre, post=post, post_op="sub"),
        "dif": dict(tw_dif=tw_inv),
        "dit": dict(tw_dit=tw_fwd),
    }
    for mode, kw in cases.items():
        got, want = fk.ntt_rows(x, **kw), fk.ntt_rows_plain(x, **kw)
        assert torch.equal(got.cpu(), want.cpu()), mode


def _encode(g2, pts):
    enc = cv.encode_g2_affine(pts) if g2 else cv.encode_g1_affine(pts)
    return cv.affine_to_proj(torch.from_numpy(enc), g2)


def _points(g2, n):
    grp, gen = (rc.G2, rc.g2_generator()) if g2 else (rc.G1, rc.g1_generator())
    base = [grp.mul(gen, RNG.randrange(1, 1 << 64)) for _ in range(8)]
    pts = [base[i % 8] for i in range(n)]
    pts[1] = None
    return grp, pts


def _add_operands(g2, n):
    """(P, Q) affine point lists of length n. Row i by i % 12: 2, 3 P + P;
    4, 5 P + (-P); 6 P the identity; 7 Q the identity; 8, 9 both; so each
    case sits at an even and an odd row (both lanes' positions of a G2
    pair), and a Q at infinity (7) has neighbours whose Q is not (6, 8) in
    the same warp."""
    grp, pts = _points(g2, max(n, 8))
    pts = pts[:n]
    q_pts = pts[-3:] + pts[:-3]
    for i in range(n):
        case = i % 12
        if case in (2, 3):
            q_pts[i] = pts[i]
        elif case in (4, 5):
            q_pts[i] = grp.neg(pts[i])
        if case in (6, 8, 9):
            pts[i] = None
        if case in (7, 8, 9):
            q_pts[i] = None
    return grp, pts, q_pts


@pytest.mark.cuda
@pytest.mark.parametrize("g2", [False, True])
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 127, 129, 1000, 1001])
def test_point_add(cuda, g2, mixed, n):
    """Ragged n around the block edges (64 G1 points or 32 G2 pairs per
    block) and pair edges; general rows, identity operands, P + P and
    P + (-P)."""
    grp, pts, q_pts = _add_operands(g2, n)
    P, Qp = _encode(g2, pts), _encode(g2, q_pts)
    if not mixed:  # general operands carry Z != 1
        ident = _encode(g2, [None] * n)
        P, Qp = ck.point_add_plain(P, ident), ck.point_add_plain(Qp, ident)
    P, Qp = P.to(cuda), Qp.to(cuda)
    got = ck.point_add(P, Qp, mixed)
    _same(got, ck.point_add_plain(P, Qp, mixed))
    dec = cv.decode_g2_proj if g2 else cv.decode_g1_proj
    rows = min(n, 72)  # the host's group law is slow; the plain version covers every row
    assert dec(got[:rows]) == [grp.add(a, b) for a, b in zip(pts[:rows], q_pts[:rows])]


def _scan_rows(g2, mixed, T, K):
    """T * K points (an identity row at 1, a doubling at 4 and an inverse at
    11), general representatives (Z != 1) unless mixed."""
    grp, pts = _points(g2, T * K)
    pts[4] = pts[3]
    pts[11] = grp.neg(pts[10])
    P = _encode(g2, pts)
    if not mixed:
        P = ck.point_add_plain(P, _encode(g2, [None] * len(pts)))
    return P.reshape((T, K) + P.shape[1:])


SCAN_CASES = {  # id: (T, K, flags)
    "T1": (1, 16, "segments"), "T127": (127, 16, "segments"), "T129": (129, 16, "segments"),
    "T1000": (1000, 16, "segments"), "all_flags": (40, 16, "all"), "no_flags": (40, 16, "none"),
    "K5": (33, 5, "segments"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("mixed", [False, True], ids=["add", "madd"])
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_point_tile_scan(cuda, g2, mixed, case):
    """Ragged T (blocks of 64 tiles), every flag, no flag, identity rows, and
    a doubling and an inverse inside a segment; K != 16 takes the same
    kernel."""
    T, K, kind = SCAN_CASES[case]
    vt = _scan_rows(g2, mixed, T, K).to(cuda)
    if kind == "segments":  # segments start at 3 and 10 and by chance; 4 and 11 inside
        ft = torch.rand(T, K, device=cuda) < 0.2
        ft.view(-1)[[3, 10]] = True
        ft.view(-1)[[4, 11]] = False
    else:
        ft = torch.full((T, K), kind == "all", device=cuda)
    out, carry = ck.point_tile_scan(vt, ft, mixed)
    want_out, want_carry = ck.point_tile_scan_plain(vt, ft, mixed)
    _same(out, want_out)
    _same(carry, want_carry)


@pytest.mark.cuda
def test_chain254_golden_on_card(cuda):
    from circom_compat_tpu_torch.circom.zkey import read_zkey
    from circom_compat_tpu_torch.models.groth16 import Groth16
    from circom_compat_tpu_torch.utils.chain import chain_circuit

    rec = json.loads((GOLDEN / "chain254_proof.json").read_text())
    pk, m = read_zkey(GOLDEN / "chain254.zkey")
    circuit = chain_circuit(k=254, a=3)
    proof = Groth16.create_proof_with_reduction_and_matrices(
        pk, rec["r"], rec["s"], m, m.num_instance_variables, m.num_constraints,
        circuit.full_assignment(), device=cuda)
    p = rec["proof"]
    assert proof.a == tuple(int(v, 16) for v in p["a"])
    assert proof.b == tuple(tuple(int(v, 16) for v in c) for c in p["b"])
    assert proof.c == tuple(int(v, 16) for v in p["c"])
    assert Groth16.verify_proof(pk.vk, proof, circuit.get_public_inputs())


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["mul", "mul_canon", "add", "sub"])
def test_fr_binary_fq(cuda, op):
    from circom_compat_tpu_torch.constants import Q
    from circom_compat_tpu_torch.ops import field as fl

    a, b = _lazy_words(1000, Q, cuda), _lazy_words(1000, Q, cuda)
    _same(fk.fr_binary(op, a, b, fl.FQ), fk.fr_binary_plain(op, a, b, fl.FQ))
    _same(fk.fr_binary(op, a, b[3], fl.FQ), fk.fr_binary_plain(op, a, b[3], fl.FQ))


@pytest.mark.cuda
@pytest.mark.parametrize("dif", [False, True])
@pytest.mark.parametrize("n", [1024, 8192])
def test_fr_butterfly_stage(cuda, dif, n):
    from circom_compat_tpu_torch.ops import ntt

    tw = ntt.get_plan(n).tables(cuda, "flat")["tw_inv" if dif else "tw_fwd"]
    x = _lazy_words(n, R_SCALAR, cuda)
    half = 1
    while half < n:
        _same(fk.fr_butterfly_stage(x, tw, half, dif), fk.fr_butterfly_stage_plain(x, tw, half, dif))
        half *= 2


# (n, half_lo, half_hi): R = 2 half_hi / half_lo rows a column, 2 to 16, up
# to n/2 at the flat chain's smallest and largest sizes; a range whose
# columns are shorter than a block's (half_lo = 1); single stages at 2^20
STAGES_CASES = ([(n, n // r, n // 2) for n in (1024, 8192) for r in (2, 4, 8, 16)]
                + [(1024, 1, 8), (1 << 20, 1, 1), (1 << 20, 512, 512), (1 << 20, 1 << 19, 1 << 19)])


@pytest.mark.cuda
@pytest.mark.parametrize("dif", [False, True], ids=["dit", "dif"])
@pytest.mark.parametrize("n,half_lo,half_hi", STAGES_CASES,
                         ids=[f"n{n}_{lo}-{hi}" for n, lo, hi in STAGES_CASES])
def test_fr_butterfly_stages(cuda, n, half_lo, half_hi, dif):
    """The fused stages against the stage-by-stage plain composition, word
    for word, on operands at the top of the lazy range."""
    from circom_compat_tpu_torch.ops import ntt

    tw = ntt.get_plan(n).tables(cuda, "flat")["tw_inv" if dif else "tw_fwd"]
    x = _upper_lazy_words(n, R_SCALAR, cuda)
    before = fk.LAUNCHES["fr_butterfly_stage"]
    got = fk.fr_butterfly_stages(x, tw, half_lo, half_hi, dif)
    assert fk.LAUNCHES["fr_butterfly_stage"] == before + 1
    _same(got, fk.fr_butterfly_stages_plain(x, tw, half_lo, half_hi, dif))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["mont_mul", "mont_mul_lazy", "add", "add_lazy", "sub_lazy", "mul9"])
def test_fq_op_chain(cuda, op):
    from circom_compat_tpu_torch.ops import field_bench as fbn

    a, b = fbn.operands(1000, device=cuda)
    _same(fbn.fq_op_chain(op, a, b, 9), fbn.fq_op_chain_plain(op, a, b, 9))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fr_binary", "fr_binary_fq", "fr_tile_scan", "ntt_rows",
                                    "fr_butterfly_stage", "fq_op_chain", "point_add",
                                    "point_tile_scan"])
def test_field_core_edge_values(cuda, kernel):
    """Every kernel on operands made only of the edge values 0, 1, p-1 and
    2p-1 of the lazy range, in all pairings, against its plain version."""
    from circom_compat_tpu_torch.constants import Q
    from circom_compat_tpu_torch.ops import field as fl
    from circom_compat_tpu_torch.ops import field_bench as fbn
    from circom_compat_tpu_torch.ops import ntt

    if kernel in ("fr_binary", "fr_binary_fq"):
        F, p = (fl.FQ, Q) if kernel == "fr_binary_fq" else (fl.FR, R_SCALAR)
        a, b = _edge_words(64, p, cuda), _edge_words(64, p, cuda, 4)
        for op in ("mul", "mul_canon", "add", "sub"):
            _same(fk.fr_binary(op, a, b, F), fk.fr_binary_plain(op, a, b, F))
    elif kernel == "fr_tile_scan":
        vt = _edge_words(64 * 16, R_SCALAR, cuda, 3).reshape(64, 16, 8)
        ft = torch.rand(64, 16, device=cuda) < 0.2
        for got, want in zip(fk.fr_tile_scan(vt, ft), fk.fr_tile_scan_plain(vt, ft)):
            _same(got, want)
    elif kernel == "ntt_rows":
        tb = ntt.get_plan(64 * 64).tables(cuda, "four_step")
        x, m = _edge_words(4 * 64, R_SCALAR, cuda).reshape(4, 64, 8), _edge_words(4 * 64, R_SCALAR, cuda, 4)
        kw = dict(tw_dif=tb["tw1_inv"], pre=m.reshape(x.shape), mid=m.reshape(x.shape),
                  tw_dit=tb["tw1_fwd"], post=m.reshape(x.shape), post_op="sub")
        _same(fk.ntt_rows(x, **kw), fk.ntt_rows_plain(x, **kw))
    elif kernel == "fr_butterfly_stage":
        tw = ntt.get_plan(1024).tables(cuda, "flat")["tw_fwd"]
        x = _edge_words(1024, R_SCALAR, cuda)
        for dif in (False, True):
            _same(fk.fr_butterfly_stage(x, tw, 4, dif), fk.fr_butterfly_stage_plain(x, tw, 4, dif))
    elif kernel == "fq_op_chain":
        for op in fbn.OPS:  # "add" is the canonical add: canonical operands
            a, b = (_edge_words(64, Q, cuda, s, canonical=op == "add") for s in (1, 4))
            _same(fbn.fq_op_chain(op, a, b, 5), fbn.fq_op_chain_plain(op, a, b, 5))
    else:
        for g2 in (False, True):
            P = _edge_points(g2, 4096 if g2 else 64, cuda)
            Qp = P.roll(7, 0).contiguous()
            for mixed in (False, True):
                if kernel == "point_add":
                    _same(ck.point_add(P, Qp, mixed), ck.point_add_plain(P, Qp, mixed))
                else:
                    vt = P.reshape((-1, 16) + P.shape[1:])
                    ft = torch.rand(vt.shape[:2], device=cuda) < 0.2
                    for got, want in zip(ck.point_tile_scan(vt, ft, mixed),
                                         ck.point_tile_scan_plain(vt, ft, mixed)):
                        _same(got, want)


@pytest.mark.cuda
def test_setup_prove_verify_2_13_on_card(cuda):
    """Setup on the card, then prove through the flat chain and verify."""
    from circom_compat_tpu_torch.models import generate_parameters_from_matrices
    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.models.groth16 import Groth16
    from circom_compat_tpu_torch.utils.chain import chain_circuit

    c = chain_circuit(k=(1 << 13) - 2, a=5)
    ma, mb, mc = c.to_matrices()
    pk = generate_parameters_from_matrices(ma, mb, mc, c.r1cs.num_inputs, c.r1cs.num_variables,
                                           alpha=11, beta=12, gamma=13, delta=14, t=0xE1,
                                           device=cuda)
    dpk = gd.DeviceProvingKey.from_matrix_rows(pk, ma, mb, c.r1cs.num_inputs,
                                               len(c.r1cs.constraints), device=cuda)
    fk.reset_launches()
    proof = gd.prove_prepared(dpk, 0x1234, 0x5678, c.full_assignment())
    # one fused launch a transform
    assert fk.LAUNCHES["fr_butterfly_stage"] == 6 and fk.LAUNCHES["ntt_rows_mid"] == 0
    assert Groth16.verify_proof(pk.vk, proof, c.get_public_inputs())
    assert not Groth16.verify_proof(pk.vk, proof, [c.get_public_inputs()[0] + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_standalone_msm_known_dlog(cuda, g2):
    """msm_g1 / msm_g2 at 2^12 points of known discrete logs (a pool of 61,
    infinity rows included): the sum is (sum_i s_i k_i) G."""
    from circom_compat_tpu_torch.ops import msm

    grp, gen = (rc.G2, rc.g2_generator()) if g2 else (rc.G1, rc.g1_generator())
    ks = [RNG.randrange(1, R_SCALAR) for _ in range(61)]
    pool = [grp.mul(gen, k) for k in ks]
    n = 1 << 12
    idx = [RNG.randrange(61) for _ in range(n)]
    dl = [ks[i] for i in idx]
    pts = [pool[i] for i in idx]
    for i in (3, 999, n - 1):
        pts[i], dl[i] = None, 0
    sc = [RNG.randrange(R_SCALAR) for _ in range(n)]
    xy = torch.from_numpy(cv.encode_g2_affine(pts) if g2 else cv.encode_g1_affine(pts)).to(cuda)
    ck.reset_launches()
    got = (msm.msm_g2 if g2 else msm.msm_g1)(xy, sc, device=cuda)
    assert ck.LAUNCHES[f"tile_scan_{'g2' if g2 else 'g1'}"] > 0
    assert got == grp.mul(gen, sum(s * d for s, d in zip(sc, dl)) % R_SCALAR)


@pytest.mark.cuda
def test_groth16_prove_circuit_on_card(cuda):
    """Groth16.prove over the chain254 CircomCircuit on the card verifies."""
    from circom_compat_tpu_torch.circom.zkey import read_zkey
    from circom_compat_tpu_torch.models.groth16 import Groth16
    from circom_compat_tpu_torch.utils.chain import chain_circuit

    pk, _ = read_zkey(GOLDEN / "chain254.zkey")
    circuit = chain_circuit(k=254, a=3)
    proof = Groth16.prove(pk, circuit)
    public = circuit.get_public_inputs()
    assert Groth16.verify_proof(pk.vk, proof, public)
    assert not Groth16.verify_proof(pk.vk, proof, [(public[0] + 1) % R_SCALAR])
