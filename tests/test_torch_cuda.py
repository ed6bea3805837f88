"""Card tests: every CUDA kernel of circom_compat_tpu_torch against its plain
PyTorch version on the same CUDA tensors, word for word, the chain254
golden proof proved on the card, and setup -> prove -> verify at a 2^13
domain (the flat NTT chain) on the card.

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


@pytest.mark.cuda
@pytest.mark.parametrize("L", [16, 1024])
def test_ntt_rows(cuda, L):
    from circom_compat_tpu_torch.ops import ntt

    plan = ntt.get_plan(L * L)
    tb = plan.tables(cuda, "four_step")
    rows = 3
    x, pre, post, mid = (_lazy_words(rows * L, R_SCALAR, cuda).reshape(rows, L, 8) for _ in range(4))
    cases = [
        dict(tw_dif=tb["tw1_inv"], pre=pre, post=post),
        dict(tw_dit=tb["tw1_fwd"], pre=pre, post=post, post_op="sub"),
        dict(tw_dif=tb["tw1_inv"], mid=mid, tw_dit=tb["tw1_fwd"]),
    ]
    for kw in cases:
        _same(fk.ntt_rows(x, **kw), fk.ntt_rows_plain(x, **kw))


def _encode(g2, pts):
    enc = cv.encode_g2_affine(pts) if g2 else cv.encode_g1_affine(pts)
    return cv.affine_to_proj(torch.from_numpy(enc), g2)


def _points(g2, n):
    grp, gen = (rc.G2, rc.g2_generator()) if g2 else (rc.G1, rc.g1_generator())
    base = [grp.mul(gen, RNG.randrange(1, 1 << 64)) for _ in range(8)]
    pts = [base[i % 8] for i in range(n)]
    pts[1] = None
    return grp, pts


@pytest.mark.cuda
@pytest.mark.parametrize("g2", [False, True])
@pytest.mark.parametrize("mixed", [False, True])
def test_point_add(cuda, g2, mixed):
    """General rows, identity operands, P + P and P + (-P)."""
    grp, pts = _points(g2, 64)
    q_pts = pts[-3:] + pts[:-3]
    q_pts[10:20] = pts[10:20]
    q_pts[20:25] = [grp.neg(p) for p in pts[20:25]]
    P, Qp = _encode(g2, pts), _encode(g2, q_pts)
    if not mixed:  # general operands carry Z != 1
        P = ck.point_add_plain(P, _encode(g2, [None] * 64))
    P, Qp = P.to(cuda), Qp.to(cuda)
    got = ck.point_add(P, Qp, mixed)
    _same(got, ck.point_add_plain(P, Qp, mixed))
    dec = cv.decode_g2_proj if g2 else cv.decode_g1_proj
    assert dec(got) == [grp.add(a, b) for a, b in zip(pts, q_pts)]


@pytest.mark.cuda
@pytest.mark.parametrize("g2", [False, True])
@pytest.mark.parametrize("mixed", [False, True])
def test_point_tile_scan(cuda, g2, mixed):
    _, pts = _points(g2, 40 * 16)
    P = _encode(g2, pts)
    if not mixed:
        P = ck.point_add_plain(P, P.roll(1, 0))
    vt = P.reshape((40, 16) + P.shape[1:]).to(cuda)
    ft = torch.rand(40, 16, device=cuda) < 0.2
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


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["mont_mul", "mont_mul_lazy", "add", "add_lazy", "sub_lazy", "mul9"])
def test_fq_op_chain(cuda, op):
    from circom_compat_tpu_torch.ops import field_bench as fbn

    a, b = fbn.operands(1000, device=cuda)
    _same(fbn.fq_op_chain(op, a, b, 9), fbn.fq_op_chain_plain(op, a, b, 9))


@pytest.mark.cuda
def test_setup_prove_verify_2_13_on_card(cuda):
    """Setup on the card, then prove through the flat chain and verify."""
    from circom_compat_tpu_torch.models import generate_parameters_from_matrices
    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.models.groth16 import Groth16
    from circom_compat_tpu_torch.utils.chain import chain_circuit

    c = chain_circuit(k=(1 << 13) - 2, a=5)
    pk = generate_parameters_from_matrices(c.a, c.b, c.c, c.num_inputs, c.num_variables,
                                           alpha=11, beta=12, gamma=13, delta=14, t=0xE1,
                                           device=cuda)
    dpk = gd.DeviceProvingKey.from_matrix_rows(pk, c.a, c.b, c.num_inputs, c.num_constraints,
                                               device=cuda)
    fk.reset_launches()
    proof = gd.prove_prepared(dpk, 0x1234, 0x5678, c.full_assignment())
    assert fk.LAUNCHES["fr_butterfly_stage"] > 0 and fk.LAUNCHES["ntt_rows_mid"] == 0
    assert Groth16.verify_proof(pk.vk, proof, c.get_public_inputs())
    assert not Groth16.verify_proof(pk.vk, proof, [c.get_public_inputs()[0] + 1])
