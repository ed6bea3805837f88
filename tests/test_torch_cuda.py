"""Card tests: every CUDA kernel of circom_compat_tpu_torch against its plain
PyTorch version on the same CUDA tensors, word for word, the chain254
golden proof proved on the card, setup -> prove -> verify at a 2^13
domain (the flat NTT chain) on the card, the standalone msm_g1 / msm_g2 at
2^12 points against a known-dlog sum, Groth16.prove of the chain254
circuit, the streamed prover's chain254 golden proof at several chunk
sizes (pinned buffers and the copy stream on the card), the ceremony's
scalar_mul_const and contribute, the standalone fft / ifft / coset_shift
and the signed-digit MSM; K10 (proof_fold) against the host fold and its
plain version, a 10^4 chain proof against the CPU's and its one launch a
ProveServer.handle; the streamed, sharded and streamed-sharded provers'
proofs against prove_prepared's, each with one K10 launch; bucket_sums'
digit-0 skip on bit scalars against its plain version.

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
    """On the op's edge operands at a ragged n, at the step count compiled
    in (64) and at runtime step counts (the loop's remainder alone, and
    turns of 8); then at a ragged n past what the card holds at once (the
    launch's smaller blocks)."""
    from circom_compat_tpu_torch.ops import field_bench as fbn

    a, b = fbn.edge_operands(op, 1000 - 37, device=cuda)
    for k in (64, 0, 1, 5, 9, 19):
        _same(fbn.fq_op_chain(op, a, b, k), fbn.fq_op_chain_plain(op, a, b, k))
    a, b = fbn.edge_operands(op, (1 << 19) - 37, device=cuda)
    for k in (64, 5):
        _same(fbn.fq_op_chain(op, a, b, k), fbn.fq_op_chain_plain(op, a, b, k))


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


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [37, 100, 256, 1 << 20])
def test_streamed_chain254_golden_on_card(cuda, chunk):
    """prove_streamed on the card, chunk by chunk through the pinned buffers
    and the copy stream (7, 3 and 1 chunks; 2^20 clamps to one), gives the
    golden proof; one chunk time pair a chunk; Groth16.prove on the
    streamed backend verifies."""
    from circom_compat_tpu_torch.circom.zkey import read_zkey
    from circom_compat_tpu_torch.models import streamed
    from circom_compat_tpu_torch.models.groth16 import Groth16
    from circom_compat_tpu_torch.utils.chain import chain_circuit

    rec = json.loads((GOLDEN / "chain254_proof.json").read_text())
    pk, m = read_zkey(GOLDEN / "chain254.zkey")
    circuit = chain_circuit(k=254, a=3)
    spk = streamed.StreamedProvingKey.build(pk, m, m.num_constraints, chunk_points=chunk,
                                            device=cuda)
    proof = streamed.prove_streamed(spk, rec["r"], rec["s"], circuit.full_assignment())
    want = rec["proof"]
    assert proof.a == tuple(int(v, 16) for v in want["a"])
    assert proof.b == tuple(tuple(int(v, 16) for v in c) for c in want["b"])
    assert proof.c == tuple(int(v, 16) for v in want["c"])
    assert len(streamed.LAST_CHUNK_MS) == -(-256 // min(chunk, 256))
    assert streamed.LAST_PEAK_DEVICE_BYTES > 0
    again = Groth16.prove(pk, circuit, device=cuda, backend="streamed")
    assert Groth16.verify_proof(pk.vk, again, circuit.get_public_inputs())


def _golden_proof(proof):
    rec = json.loads((GOLDEN / "chain254_proof.json").read_text())
    want = rec["proof"]
    assert proof.a == tuple(int(v, 16) for v in want["a"])
    assert proof.b == tuple(tuple(int(v, 16) for v in c) for c in want["b"])
    assert proof.c == tuple(int(v, 16) for v in want["c"])


@pytest.mark.cuda
def test_dist_ntt_rows_on_the_sharded_shapes(cuda):
    """ntt_rows at the distributed witness map's 2^20 shapes over four shards
    ((256, 1024) rows of shard 0): its DIF with the c = a o b pre, the middle
    launch (the distributed twiddle pre, DIF, coset mid, DIT, twiddle post),
    its DIT with the post-subtract, and the iFFT body's twiddle pre + DIF."""
    from circom_compat_tpu_torch.parallel import ntt_sharded as ns

    plan = ns.get_dist_plan(1 << 20, 4)
    t = plan.shard_tables([torch.device("cuda", torch.cuda.current_device())] * 4, chain=True)[0]
    nat = plan.shard_tables([torch.device("cuda", torch.cuda.current_device())] * 4)[0]
    x, other = (_upper_lazy_words(256 * 1024, R_SCALAR, cuda).reshape(256, 1024, 8)
                for _ in range(2))
    cases = {
        "dif_pre": dict(tw_dif=t["tw2_inv"], pre=other),
        "middle": dict(pre=t["twi"], tw_dif=t["tw1_inv"], mid=t["coset"], tw_dit=t["tw1_fwd"],
                       post=t["twf"]),
        "dit_post_sub": dict(tw_dit=t["tw2_fwd"], post=other, post_op="sub"),
        "ifft_twiddle_pre": dict(pre=nat["twiddle_inv"], tw_dif=nat["tw1_inv"]),
    }
    for mode, kw in cases.items():
        assert torch.equal(fk.ntt_rows(x, **kw).cpu(), fk.ntt_rows_plain(x, **kw).cpu()), mode
    plan.release()


@pytest.mark.cuda
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_tree_fold_on_the_fold_shapes(cuda, g2):
    """The cross-shard tree fold of K6/K7 adds over D = 4 shards' window
    sums, (D, 4, W) G1 and (D, W) G2 points at W = 20 (window bits 13),
    identity rows among them, equal to the fold of the plain add."""
    from circom_compat_tpu_torch.parallel import mesh as pm

    W = 20
    shape = (4, 4, W) if not g2 else (4, W)
    count = torch.Size(shape).numel()
    _, pts = _points(g2, count)
    _, qts = _points(g2, count)
    p = _encode(g2, pts).to(cuda)
    q = _encode(g2, qts).to(cuda)
    vals = ck.point_add_plain(p, q.roll(1, 0)).reshape(shape + p.shape[1:]).contiguous()
    vals.view(-1, *p.shape[1:])[5] = cv.proj_identity_const(g2, cuda)
    got = pm.tree_fold(ck.point_add, vals, 4)
    assert torch.equal(got.cpu(), pm.tree_fold(ck.point_add_plain, vals, 4).cpu())


@pytest.mark.cuda
def test_shard_sparse_eval_on_td_rows(cuda):
    """One shard's sparse row evaluation over its TD rows (fr_binary mul and
    the fr_tile_scan row sums) of a 2^12 chain over four shards, equal to
    the plain versions."""
    import types

    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.ops import ntt
    from circom_compat_tpu_torch.parallel import ntt_sharded as ns
    from circom_compat_tpu_torch.parallel import prove_sharded as ps
    from circom_compat_tpu_torch.utils.chain import chain_matrices, chain_witness

    k, D = (1 << 12) - 2, 4
    plan = ns.get_dist_plan(1 << 12, D)
    m = gd.DeviceMatrices.stage(chain_matrices(k), k, 2, 1 << 12, cuda)
    (ar, ac, av), _ = ps._td_coo(types.SimpleNamespace(matrices=m), plan, D)
    asg = fk.fr_to_mont(torch.from_numpy(gd.encode_assignment(chain_witness(k, 3))).to(cuda))
    for d in range(D):
        r, c, v = (torch.from_numpy(x[d]).to(cuda) for x in (ar, ac, av))
        got = ntt.sparse_eval(r, c, v, asg, (1 << 12) // D, fk.KERNELS)
        assert torch.equal(got.cpu(), ntt.sparse_eval(r, c, v, asg, (1 << 12) // D, fk.PLAIN).cpu())


def _card_meshes():
    from circom_compat_tpu_torch.parallel import mesh as pm

    here = torch.device("cuda", torch.cuda.current_device())
    meshes = {"one card repeated": pm.make_mesh(devices=[here] * 2)}
    if torch.cuda.device_count() >= 2:
        meshes["distinct cards"] = pm.make_mesh(2)
    return meshes


@pytest.mark.cuda
@pytest.mark.parametrize("dist_ntt", [True, False], ids=["dist_ntt", "replicated"])
def test_sharded_prove_chain254_golden_on_card(cuda, dist_ntt):
    """prove_sharded over two shards on the card (and over two cards where
    the machine has them) gives the golden proof, launching K1, K2, K3/K4,
    K6/K7 and K8; K10 folds its sums on the lead card (one launch)."""
    from circom_compat_tpu_torch.circom.zkey import read_zkey
    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.parallel import prove_sharded as ps
    from circom_compat_tpu_torch.utils.chain import chain_circuit

    rec = json.loads((GOLDEN / "chain254_proof.json").read_text())
    pk, m = read_zkey(GOLDEN / "chain254.zkey")
    dpk = gd.DeviceProvingKey.build(pk, m, m.num_constraints, device=cuda)
    for mesh in _card_meshes().values():
        prover = ps.build_sharded_prover(dpk, mesh, dist_ntt=dist_ntt)
        fk.reset_launches()
        ck.reset_launches()
        _golden_proof(ps.prove_sharded(dpk, prover, rec["r"], rec["s"],
                                       chain_circuit(k=254, a=3).full_assignment()))
        for name in ("fr_binary", "fr_tile_scan", "ntt_rows_low", "ntt_rows_mid"):
            assert fk.LAUNCHES[name] > 0, name
        assert all(v > 0 for v in ck.LAUNCHES.values()), ck.LAUNCHES
        assert ck.LAUNCHES["proof_fold"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [100, 256])
def test_streamed_sharded_chain254_golden_on_card(cuda, chunk):
    """prove_streamed_sharded over two shards (each with its own pinned
    buffers and copy stream) gives the golden proof, a chunk time pair a
    part of a chunk."""
    from circom_compat_tpu_torch.circom.zkey import read_zkey
    from circom_compat_tpu_torch.models import streamed
    from circom_compat_tpu_torch.parallel import streamed_sharded as ss
    from circom_compat_tpu_torch.utils.chain import chain_circuit

    rec = json.loads((GOLDEN / "chain254_proof.json").read_text())
    pk, m = read_zkey(GOLDEN / "chain254.zkey")
    spk = streamed.StreamedProvingKey.build(pk, m, m.num_constraints, chunk_points=chunk,
                                            device=cuda)
    for mesh in _card_meshes().values():
        _golden_proof(ss.prove_streamed_sharded(spk, mesh, rec["r"], rec["s"],
                                                chain_circuit(k=254, a=3).full_assignment()))
        assert [len(v) for v in ss.LAST_CHUNK_MS.values()] == [-(-256 // chunk)] * 2
        assert all(v > 0 for v in ss.LAST_PEAK_DEVICE_BYTES.values())


@pytest.mark.cuda
def test_every_prover_folds_on_the_card(cuda):
    """prove_streamed (three chunks), prove_sharded over a mesh that repeats
    the card and prove_streamed_sharded give prove_prepared's proof byte for
    byte on the chain254 golden key, each with one K10 launch."""
    from circom_compat_tpu_torch.circom.zkey import read_zkey
    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.models import streamed
    from circom_compat_tpu_torch.parallel import mesh as pm
    from circom_compat_tpu_torch.parallel import prove_sharded as ps
    from circom_compat_tpu_torch.parallel import streamed_sharded as ss
    from circom_compat_tpu_torch.utils.chain import chain_circuit

    rec = json.loads((GOLDEN / "chain254_proof.json").read_text())
    r, s = rec["r"], rec["s"]
    pk, m = read_zkey(GOLDEN / "chain254.zkey")
    asg = chain_circuit(k=254, a=3).full_assignment()
    dpk = gd.DeviceProvingKey.build(pk, m, m.num_constraints, device=cuda)
    want = gd.prove_prepared(dpk, r, s, asg)
    _golden_proof(want)
    spk = streamed.StreamedProvingKey.build(pk, m, m.num_constraints, chunk_points=100,
                                            device=cuda)
    mesh = pm.make_mesh(devices=[torch.device("cuda", torch.cuda.current_device())] * 2)
    prover = ps.build_sharded_prover(dpk, mesh)
    provers = {"streamed": lambda: streamed.prove_streamed(spk, r, s, asg),
               "sharded": lambda: ps.prove_sharded(dpk, prover, r, s, asg),
               "streamed_sharded": lambda: ss.prove_streamed_sharded(spk, mesh, r, s, asg)}
    for name, prove in provers.items():
        before = ck.LAUNCHES["proof_fold"]
        got = prove()
        assert (got.a, got.b, got.c) == (want.a, want.b, want.c), name
        assert ck.LAUNCHES["proof_fold"] == before + 1, name


@pytest.mark.cuda
def test_shard_work_queues_without_a_host_sync(cuda):
    """The sharded witness map and a shard's sorts queue their kernels with
    no call that synchronizes the card (torch.cuda.set_sync_debug_mode
    ("error") raises on one); each window_sums call synchronizes once, to
    read back its windows' digit-0 counts (ops/msm.bucket_sums), which waits
    for that shard's card alone."""
    import warnings

    from circom_compat_tpu_torch.circom.zkey import read_zkey
    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.ops import msm
    from circom_compat_tpu_torch.parallel import mesh as pm
    from circom_compat_tpu_torch.parallel import prove_sharded as ps
    from circom_compat_tpu_torch.utils.chain import chain_circuit

    pk, m = read_zkey(GOLDEN / "chain254.zkey")
    dpk = gd.DeviceProvingKey.build(pk, m, m.num_constraints, device=cuda)
    here = torch.device("cuda", torch.cuda.current_device())
    prover = ps.build_sharded_prover(dpk, pm.make_mesh(devices=[here] * 2), dist_ntt=True)
    words = torch.from_numpy(gd.encode_assignment(chain_circuit(k=254, a=3).full_assignment()))
    asg = [pm.copy_to(words, d) for d in prover.mesh.devices]
    prover.h_scalars(asg)  # warm: the constants are staged on first use
    w = prover.window_bits
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = prover.h_scalars(asg)
        sa = msm.window_orders(pm.rows_of([asg[0]], 0, 128, here), w)
        sh = msm.window_orders(pm.rows_of(h, 0, 128, here), w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            g1 = msm.window_sums(list(prover.g1[0]), [sa, sa, sa, sh], w)
            g2 = msm.window_sums([prover.g2[0]], [sa], w)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [c for c in caught if "called a synchronizing CUDA operation" in str(c.message)]
    assert len(syncs) == 2, [f"{c.filename}:{c.lineno}" for c in syncs]
    assert g1.shape[0] == 4 and g2.shape[0] == 1


@pytest.mark.cuda
def test_bucket_sums_skip_on_bits(cuda):
    """Window sums over 2^16 rows (N = 2048, w = 8) of bit scalars and two
    dense ones: the card's equal the plain version's on the CPU, and both
    gather the same rows, those of nonzero digit."""
    from circom_compat_tpu_torch.ops import msm

    n, w = 2048, 8
    _, pts = _points(False, n)
    vals = [RNG.randrange(2) for _ in range(n)]
    vals[5], vals[n - 2] = RNG.randrange(R_SCALAR), RNG.randrange(R_SCALAR)
    xy = torch.from_numpy(cv.encode_g1_affine(pts))
    words = torch.from_numpy(lc.ints_to_words(vals))
    rows = int((msm.window_digits(words, w) != 0).sum())
    got = {}
    for dev in (cuda, torch.device("cpu")):
        msm.reset_counters()
        got[dev.type] = msm.window_sums([xy.to(dev)], [msm.window_orders(words.to(dev), w)], w)
        assert msm.BUCKET_ROWS["g1"] == rows
        assert msm.BUCKET_SKIPPED["g1"] == msm.num_windows(w) * n - rows
    assert cv.decode_g1_proj(got["cuda"]) == cv.decode_g1_proj(got["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 1000])
def test_scalar_mul_const(cuda, n):
    """The ceremony's double-and-add (K6/K7) against its plain version and
    the host, infinity rows included; k = 0 and k = 1 too."""
    from circom_compat_tpu_torch.ops import fixed_base as fb

    pts = [rc.G1.mul(rc.g1_generator(), RNG.randrange(1, R_SCALAR)) for _ in range(n)]
    pts[n // 2] = None
    proj = cv.affine_to_proj(torch.from_numpy(cv.encode_g1_affine(pts)).to(cuda), False)
    for k in (0, 1, 2, RNG.randrange(R_SCALAR)):
        ck.reset_launches()
        got = fb.scalar_mul_const(proj, k)
        assert k < 2 or ck.LAUNCHES["point_add_g1"] > 0
        _same(got, fb.scalar_mul_const(proj.cpu(), k))  # the plain version on the CPU
        assert cv.decode_g1_proj(got) == [rc.G1.mul(p, k) if p else None for p in pts]


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [1, 5, 9, 10, 13, 14, 21])
def test_transforms(cuda, log_n):
    """fft, ifft and coset_shift on the card against their plain versions
    (mod r) and ifft(fft(x)) = x."""
    from circom_compat_tpu_torch.ops import ntt

    n = 1 << log_n
    plan = ntt.NTTPlan(n)
    x = _lazy_words(n, R_SCALAR, cuda) if n >= 4 else torch.from_numpy(
        lc.ints_to_words([3, R_SCALAR - 1][:n])).to(cuda)
    for name in ("fft", "ifft", "coset_shift"):
        fn = getattr(ntt, name)
        got, want = fn(plan, x), fn(plan, x, ops=fk.PLAIN)
        _same(fk.fr_from_mont(got), fk.fr_from_mont(want))
    _same(fk.fr_from_mont(ntt.ifft(plan, ntt.fft(plan, x))), fk.fr_from_mont(x))


@pytest.mark.cuda
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_signed_msm(cuda, g2):
    """msm_g1 / msm_g2 with signed digits at 2^12 points equal the unsigned
    result, infinity rows included, at w = 2 and the default width."""
    from circom_compat_tpu_torch.ops import msm

    grp, gen = (rc.G2, rc.g2_generator()) if g2 else (rc.G1, rc.g1_generator())
    pool = [grp.mul(gen, RNG.randrange(1, R_SCALAR)) for _ in range(31)]
    n = 1 << 12
    pts = [pool[RNG.randrange(31)] for _ in range(n)]
    for i in (0, 5, n - 1):
        pts[i] = None
    sc = [RNG.randrange(R_SCALAR) for _ in range(n)]
    xy = torch.from_numpy(cv.encode_g2_affine(pts) if g2 else cv.encode_g1_affine(pts)).to(cuda)
    fn = msm.msm_g2 if g2 else msm.msm_g1
    for w in (2, None):
        fk.reset_launches()
        got = fn(xy, sc, window_bits=w, device=cuda, signed=True)
        assert fk.LAUNCHES["f_binary_fq"] > 0
        assert got == fn(xy, sc, window_bits=w, device=cuda)


@pytest.mark.cuda
def test_contribute_on_card(cuda):
    """contribute on the card gives the plain version's sections."""
    from circom_compat_tpu_torch.circom import contribute as tc
    from circom_compat_tpu_torch.circom.zkey import read_zkey, verify_mpc_chain

    pk, _ = read_zkey(GOLDEN / "chain254.zkey")
    got = tc.contribute(pk, entropy=b"card", device=cuda)
    want = tc.contribute(pk, entropy=b"card", device="cpu")
    for name in ("l_query", "h_query"):
        assert (getattr(got, name).limbs == getattr(want, name).limbs).all()
    assert got.delta_g1 == want.delta_g1 and not verify_mpc_chain(got)


FOLD_RS = [(0, 0), (1, 0), (0, 1), (R_SCALAR - 1, R_SCALAR - 1),
           (RNG.randrange(R_SCALAR), RNG.randrange(R_SCALAR))]


@pytest.mark.cuda
@pytest.mark.parametrize("sums", ["random", "edges"])
@pytest.mark.parametrize("c,W", [(8, 32), (13, 20)], ids=["w8", "w13"])
def test_proof_fold_vs_host(cuda, c, W, sums):
    """K10 against assemble_proof's host route, point for point, at the
    prove's window shapes (10^4 and 2^20), for (r, s) = (0, 0), (1, 0), (0,
    1), (R - 1, R - 1) and random; "edges": identity windows (the top one of
    each G1 MSM, all of L) and two equal consecutive windows. The host route
    is held to the JAX package's assemble_proof on the CPU
    (test_torch_proof_fold.py)."""
    from test_torch_proof_fold import FoldCase

    from circom_compat_tpu_torch.models import groth16_device as gd

    fc = FoldCase(W, c, random.Random(W * 100 + c))
    if sums == "edges":
        for row in fc.g1_logs:
            row[W - 1] = 0
        fc.g1_logs[2] = [0] * W
        fc.g1_logs[0][4] = fc.g1_logs[0][3]
        fc.g2_logs[0], fc.g2_logs[6] = 0, fc.g2_logs[5]
    g1, g2 = fc.sums()
    fixed = fc.fixed(cuda)
    ck.reset_launches()
    for r, s in FOLD_RS:
        host = gd.assemble_proof(fc.pk, r, s, g1, g2, c)
        card = gd.assemble_proof(fc.pk, r, s, g1.to(cuda), g2.to(cuda), c, fixed)
        assert (card.a, card.b, card.c) == (host.a, host.b, host.c)
    assert ck.LAUNCHES["proof_fold"] == len(FOLD_RS)


@pytest.mark.cuda
def test_proof_fold_words_vs_plain(cuda):
    """K10's words equal its plain version's on the same CUDA tensors (2^20's
    windows, random r and s)."""
    from test_torch_proof_fold import FoldCase

    fc = FoldCase(20, 13, random.Random(7))
    g1, g2 = fc.sums(cuda)
    fixed = fc.fixed(cuda)
    r, s = RNG.randrange(R_SCALAR), RNG.randrange(R_SCALAR)
    _same(ck.proof_fold(g1, g2, *fixed, r, s, 13), ck.proof_fold_plain(g1, g2, *fixed, r, s, 13))


@pytest.mark.cuda
def test_chain_1e4_proof_card_vs_cpu(cuda):
    """A 10^4 chain proof on the card (K10) is byte for byte the CPU's (the
    host fold) for a fixed (r, s), and verifies."""
    from circom_compat_tpu_torch.models import generate_parameters_from_matrices
    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.models.groth16 import Groth16
    from circom_compat_tpu_torch.utils.chain import chain_circuit

    c = chain_circuit(k=10**4, a=7)
    ma, mb, mc = c.to_matrices()
    pk = generate_parameters_from_matrices(ma, mb, mc, c.r1cs.num_inputs, c.r1cs.num_variables,
                                           alpha=21, beta=22, gamma=23, delta=24, t=0xE3,
                                           device=cuda)
    matrices = gd.matrices_from_rows(ma, mb, c.r1cs.num_inputs, len(c.r1cs.constraints), pk.n_vars)
    r, s = RNG.randrange(R_SCALAR), RNG.randrange(R_SCALAR)
    proofs = []
    for dev in (cuda, "cpu"):
        dpk = gd.DeviceProvingKey.build(pk, matrices, len(c.r1cs.constraints),
                                        c.r1cs.num_inputs, dev)
        ck.reset_launches()
        proofs.append(gd.prove_prepared(dpk, r, s, c.full_assignment()))
        assert ck.LAUNCHES["proof_fold"] == (1 if dev is cuda else 0)
    assert proofs[0] == proofs[1]
    assert Groth16.verify_proof(pk.vk, proofs[0], c.get_public_inputs())


@pytest.mark.cuda
def test_server_handle_launches_k10_once(cuda, tmp_path):
    """One ProveServer.handle on the card: one K10 launch, and the chain254
    golden proof for the golden (r, s)."""
    from circom_compat_tpu_torch.circom.wtns import write_wtns
    from circom_compat_tpu_torch.server import ProveServer
    from circom_compat_tpu_torch.utils.chain import chain_circuit

    srv = ProveServer(str(GOLDEN / "chain254.zkey"), device=cuda)
    srv.warmup()
    rec = json.loads((GOLDEN / "chain254_proof.json").read_text())
    wtns = tmp_path / "w.wtns"
    write_wtns(chain_circuit(k=254, a=3).full_assignment(), wtns)
    ck.reset_launches()
    resp = srv.handle({"witness_file": str(wtns), "r": str(rec["r"]), "s": str(rec["s"])})
    assert resp["ok"], resp
    assert ck.LAUNCHES["proof_fold"] == 1
    g, p = rec["proof"], resp["proof"]
    assert [int(v) for v in p["pi_a"]] == [int(v, 16) for v in g["a"]] + [1]
    assert [[int(v) for v in c] for c in p["pi_b"]] == \
        [[int(v, 16) for v in c] for c in g["b"]] + [[1, 0]]
    assert [int(v) for v in p["pi_c"]] == [int(v, 16) for v in g["c"]] + [1]
