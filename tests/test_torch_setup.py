"""circom_compat_tpu_torch's trusted setup (models/setup.py, ops/fixed_base.py,
circom/zkey_writer.py) against the JAX package.

  - the host generate_parameters and generate_parameters_from_matrices
    (device="cpu": the fixed-base folds, batch inversions, closed-form H
    scalars and self-check on the kernels' plain versions) give zkey
    sections byte-identical to the JAX package's generate_parameters for
    the same toxic waste, on the squaring chain at domain 16;
  - the closed-form H scalars equal the JAX package's
    _h_scalar_limbs_device and circom/qap.py's iFFT form at n = 16 and 64,
    and a degenerate t raises;
  - projective -> affine accepts lazy [0, 2p) coordinates, batch inversion
    maps zero rows to zero, and a corrupted row trips the self-check (ports
    of tests/test_setup.py);
  - write_zkey writes the JAX writer's bytes and read_zkey reads the key
    back;
  - setup -> write_zkey -> read_zkey -> prove -> verify on the CPU, and a
    wrong public input fails.
Inputs and toxic waste are fixed or seeded. Tolerance: exact equality of
bytes and of canonical field and group elements.
"""

import io
import random

import numpy as np
import pytest
import torch

from circom_compat_tpu.circom.zkey_writer import write_zkey as jax_write_zkey
from circom_compat_tpu.models import generate_parameters as jax_generate_parameters
from circom_compat_tpu.models.setup import _h_scalar_limbs_device
from circom_compat_tpu.utils.chain import chain_circuit as jax_chain_circuit
from circom_compat_tpu_torch import models
from circom_compat_tpu_torch.circom import qap as tqap
from circom_compat_tpu_torch.circom.zkey import G1Section, G2Section, read_zkey
from circom_compat_tpu_torch.circom.zkey_writer import write_zkey
from circom_compat_tpu_torch.constants import Q, R_SCALAR, fr_root_of_unity
from circom_compat_tpu_torch.models import groth16_device as gd
from circom_compat_tpu_torch.models import setup as ts
from circom_compat_tpu_torch.models.groth16 import Groth16
from circom_compat_tpu_torch.ops import curve as cv
from circom_compat_tpu_torch.ops import fixed_base as fb
from circom_compat_tpu_torch.ops import limbs as tl
from circom_compat_tpu_torch.refmath import curve as rc
from circom_compat_tpu_torch.refmath import field as rf
from circom_compat_tpu_torch.utils.chain import chain_circuit

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
TOXIC = dict(alpha=0xA1FA, beta=0xBE7A, gamma=0x6A44A, delta=0xDE17A, t=0x7A0)
SECTIONS = ("a_query", "b_g1_query", "b_g2_query", "l_query", "h_query")
K = 14  # constraints of the chain: domain 16
MONT = 1 << 256


@pytest.fixture(scope="module")
def jax_key():
    return jax_generate_parameters(jax_chain_circuit(k=K, a=3), **TOXIC)


@pytest.fixture(scope="module")
def card_path_key():
    """The setup the card runs, on the CPU (every kernel's plain version)."""
    c = chain_circuit(k=K, a=3)
    ma, mb, mc = c.to_matrices()
    times = {}
    pk = models.generate_parameters_from_matrices(ma, mb, mc, c.r1cs.num_inputs,
                                                  c.r1cs.num_variables, device="cpu",
                                                  stage_times=times, **TOXIC)
    return pk, times


def _assert_same_key(pk, want):
    for name in SECTIONS:
        got, ref = getattr(pk, name).limbs, getattr(want, name).limbs
        assert got.shape == ref.shape and np.array_equal(got, ref), name
    assert pk.vk.gamma_abc_g1 == want.vk.gamma_abc_g1
    for name in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2"):
        assert getattr(pk.vk, name) == getattr(want.vk, name), name
    assert (pk.beta_g1, pk.delta_g1) == (want.beta_g1, want.delta_g1)
    assert (pk.n_vars, pk.n_public, pk.domain_size) == (want.n_vars, want.n_public,
                                                        want.domain_size)


def test_host_setup_matches_jax(jax_key):
    _assert_same_key(models.generate_parameters(chain_circuit(k=K, a=3), **TOXIC), jax_key)


def test_card_path_setup_matches_jax(jax_key, card_path_key):
    pk, times = card_path_key
    _assert_same_key(pk, jax_key)
    assert set(times) == {"instance_map", "encode", "g1_fold", "h_scalars", "g2_fold",
                          "readback", "selfcheck"}


@pytest.mark.parametrize("n,t,d", [(16, 0x7A57E, 0xDE17A), (64, 0xBEEF, 0x1234)])
def test_h_scalars_closed_form(n, t, d):
    got = ts._h_scalar_words(n, t, d, "cpu")
    want = _h_scalar_limbs_device(n, t, d)  # the JAX package's closed form, (n, 16)
    assert torch.equal(got, torch.from_numpy(np.asarray(want).astype("<u2").view("<i4")))
    assert tl.words_to_ints(got.numpy()) == tqap.h_query_scalars(n - 1, t, d)


@pytest.mark.parametrize("n", [4, 16])
def test_h_scalars_reject_degenerate_t(n):
    """t a 2n-th root of unity puts a pole in the closed form."""
    with pytest.raises(ValueError, match="root of unity"):
        ts._h_scalar_words(n, fr_root_of_unity(2 * n), 0xD, "cpu")


def _mont(v):
    return v * MONT % Q


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_proj_to_affine_accepts_lazy_coordinates(g2):
    """point_add emits lazy [0, 2q) coordinates; the affine conversion must
    canonicalize before its zero test, negation and inversion (the JAX
    package's round-2 bug: a lazy z1 broke the G2 negation). Odd rows carry
    +q on every coordinate, every G2 c1 is lazy, one row is infinity."""
    rng = random.Random(11)
    grp, gen = (rc.G2, rc.g2_generator()) if g2 else (rc.G1, rc.g1_generator())
    pts = [grp.mul(gen, rng.randrange(1, 1 << 64)) for _ in range(8)]
    rows = []
    for i, p in enumerate(pts):
        if g2:
            z = (rng.randrange(1, Q), rng.randrange(1, Q))
            coords = [rf.fq2_mul(p[0], z), rf.fq2_mul(p[1], z), z]
            vals = [[_mont(c[0]) + (Q if i % 2 else 0), _mont(c[1]) + Q] for c in coords]
        else:
            z = rng.randrange(1, Q)
            coords = [p[0] * z % Q, p[1] * z % Q, z]
            vals = [_mont(c) + (Q if i % 2 else 0) for c in coords]
        rows.append(vals)
    shape = (8, 3, 2, 8) if g2 else (8, 3, 8)
    words = torch.from_numpy(tl.ints_to_words(np.array(rows, dtype=object).reshape(-1).tolist()))
    points = torch.cat((words.reshape(shape), cv.proj_identity_const(g2)[None]))
    got = (fb.g2_proj_to_affine if g2 else fb.g1_proj_to_affine)(points)
    enc = cv.encode_g2_affine if g2 else cv.encode_g1_affine
    assert torch.equal(got, torch.from_numpy(enc(pts + [None])))


def test_fixed_base_points_vs_host_ladder():
    """Scalars are reduced mod r; 0 and r give infinity (all-zero rows)."""
    scalars = [0, 1, 5, R_SCALAR - 1, R_SCALAR, R_SCALAR + 3, (1 << 253) + 12345]
    got = fb.fixed_base_points(scalars, device="cpu")
    ladder = rc.FixedBaseLadder(rc.G1, rc.g1_generator())
    want = cv.encode_g1_affine([ladder.mul(s) for s in scalars])
    assert torch.equal(got, torch.from_numpy(want))


def test_fixed_base_points_defaults_to_the_card(monkeypatch):
    """Without a CUDA device the default raises and names device='cpu'; the
    rule lives in circom_compat_tpu_torch.device and groth16_device
    re-exports it."""
    from circom_compat_tpu_torch import device as tdev

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fb.fixed_base_points([1, 2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdev.resolve_device()
    assert gd.resolve_device is tdev.resolve_device
    assert fb.fixed_base_points([1], device="cpu").device == torch.device("cpu")


def test_batch_inv_fq_maps_zero_rows_to_zero():
    rng = random.Random(5)
    vals = [rng.randrange(1, Q) for _ in range(37)]
    vals[3] = vals[20] = 0
    inv = fb.batch_inv_fq(torch.from_numpy(tl.ints_to_words([_mont(v) for v in vals])))
    rinv = pow(MONT, -1, Q)
    got = [w * rinv % Q for w in tl.words_to_ints(inv.numpy())]
    assert got == [pow(v, -1, Q) if v else 0 for v in vals]


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_selfcheck_catches_corrupt_section(g2):
    scalars = [3, 7, 11, 19]
    grp, gen = (rc.G2, rc.g2_generator()) if g2 else (rc.G1, rc.g1_generator())
    pts = [grp.mul(gen, s) for s in scalars] + [None]
    enc = (cv.encode_g2_affine if g2 else cv.encode_g1_affine)(pts)
    limbs = enc.view("<u2").reshape(len(pts), 4 if g2 else 2, 16)
    Section = G2Section if g2 else G1Section
    ts._selfcheck_section("ok", Section(limbs), scalars + [0], g2=g2, device="cpu")
    bad = limbs.copy()
    bad[2, 0, 0] ^= 1  # one bit of row 2's x
    with pytest.raises(ts.SetupSelfCheckError, match="row 2"):
        ts._selfcheck_section("bad", Section(bad), scalars + [0], g2=g2, samples=32, device="cpu")
    # unknown scalars (the H query): the on-curve pass alone catches it
    with pytest.raises(ts.SetupSelfCheckError, match="off-curve"):
        ts._selfcheck_section("bad_h", Section(bad), None, g2=g2, device="cpu")


def test_selfcheck_catches_on_curve_but_wrong_row():
    scalars = [3, 7, 11, 19]
    pts = [rc.G1.mul(rc.g1_generator(), s) for s in scalars]
    pts[1] = rc.G1.mul(rc.g1_generator(), 8)  # on the curve, wrong multiple
    limbs = cv.encode_g1_affine(pts).view("<u2").reshape(4, 2, 16)
    with pytest.raises(ts.SetupSelfCheckError, match="row 1"):
        ts._selfcheck_section("a_query", G1Section(limbs), scalars, samples=32, device="cpu")


def test_write_zkey_matches_jax_writer(jax_key, card_path_key):
    pk, _ = card_path_key
    jc, c = jax_chain_circuit(k=K, a=3), chain_circuit(k=K, a=3)
    ma, mb, _ = jc.to_matrices()
    want = io.BytesIO()
    jax_write_zkey(want, jax_key, ma, mb, len(ma))
    got = io.BytesIO()
    ta, tb, _ = c.to_matrices()
    write_zkey(got, pk, ta, tb, len(c.r1cs.constraints))
    assert got.getvalue() == want.getvalue()
    got.seek(0)
    back, m = read_zkey(got)
    _assert_same_key(back, pk)
    assert (m.num_constraints, m.num_instance_variables) == (K, 2)


def test_setup_zkey_prove_verify_on_cpu():
    """A setup user's path with random toxic waste: setup -> .zkey ->
    read_zkey -> prove -> verify."""
    c = chain_circuit(k=K, a=5)
    pk = models.generate_random_parameters(c, rng=random.Random(7), device="cpu")
    buf = io.BytesIO()
    ma, mb, _ = c.to_matrices()
    write_zkey(buf, pk, ma, mb, len(c.r1cs.constraints))
    buf.seek(0)
    pk2, m = read_zkey(buf)
    proof = Groth16.create_proof_with_reduction_and_matrices(
        pk2, 0x1234, 0x5678, m, m.num_instance_variables, m.num_constraints,
        c.full_assignment(), device="cpu")
    assert Groth16.verify_proof(pk2.vk, proof, c.get_public_inputs())
    assert not Groth16.verify_proof(pk2.vk, proof, [(c.get_public_inputs()[0] + 1) % R_SCALAR])


def test_setup_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = chain_circuit(k=K, a=3)
    with pytest.raises(RuntimeError, match="device"):
        models.generate_parameters_from_matrices(*c.to_matrices(), c.r1cs.num_inputs,
                                                 c.r1cs.num_variables, **TOXIC)
    with pytest.raises(RuntimeError, match="device"):
        models.generate_random_parameters(c)
    assert gd.resolve_device("cpu") == torch.device("cpu")
