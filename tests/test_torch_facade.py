"""circom_compat_tpu_torch Groth16 facade (models/groth16.py) against the
JAX package:
  - Groth16.prove(pk, chain_circuit(254), device="cpu"): fresh randomizers,
    every kernel wrapper on its plain version; the proof verifies and a
    tampered public input is refused; without a card the default raises;
  - process_vk / verify_with_processed_vk / validate_proof / validate_vk
    give the JAX package's answers on the chain254 golden proof and key and
    on malformed points: off the curve, a coordinate not below q, a G2 point
    on the curve outside the order-r subgroup, a wrong shape; the earlier
    names (prepare_verifying_key, verify_with_prepared) are the same
    functions;
  - random_scalar lies in [0, r) and follows a seeded rng.
Tolerance: exact equality (booleans, group elements, error messages).
"""

import pathlib
import random

import pytest
import torch

from circom_compat_tpu.circom.zkey import read_zkey as jax_read_zkey
from circom_compat_tpu.models import groth16 as jg
from circom_compat_tpu_torch.circom.zkey import read_zkey
from circom_compat_tpu_torch.constants import Q, R_SCALAR
from circom_compat_tpu_torch.models import groth16 as tg
from circom_compat_tpu_torch.refmath import curve as rc
from circom_compat_tpu_torch.refmath import field as rf
from circom_compat_tpu_torch.utils.chain import chain_circuit
from test_torch_groth16 import _golden as golden_proof

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def _golden():
    """The chain254 golden proof's (A, B, C)."""
    proof = golden_proof()[1]
    return proof.a, proof.b, proof.c


def _fq2_pow(a, e):
    out = rf.FQ2_ONE
    while e:
        if e & 1:
            out = rf.fq2_mul(out, a)
        a = rf.fq2_square(a)
        e >>= 1
    return out


def _fq2_sqrt(a):
    """A square root in Fq2 (q = 3 mod 4), or None."""
    a1 = _fq2_pow(a, (Q - 3) // 4)
    alpha = rf.fq2_mul(rf.fq2_square(a1), a)
    x0 = rf.fq2_mul(a1, a)
    if alpha == (Q - 1, 0):
        x = rf.fq2_mul((0, 1), x0)
    else:
        x = rf.fq2_mul(_fq2_pow(rf.fq2_add(rf.FQ2_ONE, alpha), (Q - 1) // 2), x0)
    return x if rf.fq2_square(x) == a else None


def _g2_outside_subgroup():
    """The first point (x, y) of the twist with x = (k, 1), k = 1, 2, ...;
    G2's cofactor is large, so it lies outside the order-r subgroup."""
    for k in range(1, 100):
        x = (k, 1)
        y = _fq2_sqrt(rf.fq2_add(rf.fq2_mul(rf.fq2_square(x), x), rc.G2.b))
        if y is not None:
            assert rc.G2.is_on_curve((x, y)) and not rc.g2_in_correct_subgroup((x, y))
            return (x, y)
    raise AssertionError("no point found")


@pytest.fixture(scope="module")
def keys():
    return read_zkey(GOLDEN / "chain254.zkey")[0], jax_read_zkey(GOLDEN / "chain254.zkey")[0]


@pytest.fixture(scope="module")
def processed(keys):
    pk, jpk = keys
    return tg.Groth16.process_vk(pk.vk), jg.Groth16.process_vk(jpk.vk)


def test_prove_circuit_verifies_on_cpu(keys):
    pk, _ = keys
    circuit = chain_circuit(k=254, a=3)
    proof = tg.Groth16.prove(pk, circuit, rng=random.Random(5), device="cpu")
    public = circuit.get_public_inputs()
    assert tg.Groth16.verify_proof(pk.vk, proof, public)
    assert not tg.Groth16.verify_proof(pk.vk, proof, [(public[0] + 1) % R_SCALAR])
    assert not tg.Groth16.verify_proof(pk.vk, tg.Proof(a=proof.a, b=proof.b, c=proof.a), public)


def test_prove_defaults_to_the_card(keys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        tg.Groth16.prove(keys[0], chain_circuit(k=254, a=3))


def test_random_scalar():
    assert all(0 <= tg.random_scalar() < R_SCALAR for _ in range(20))
    assert tg.random_scalar(random.Random(9)) == tg.random_scalar(random.Random(9))


def _proofs():
    a, b, c = _golden()
    off_g1 = (a[0], (a[1] + 1) % Q)
    big_g1 = (a[0] + Q, a[1])
    off_g2 = (b[0], ((b[1][0] + 1) % Q, b[1][1]))
    big_g2 = ((b[0][0] + Q, b[0][1]), b[1])
    return {
        "good": (a, b, c), "a_off_curve": (off_g1, b, c), "a_not_canonical": (big_g1, b, c),
        "c_off_curve": (a, b, off_g1), "b_off_curve": (a, off_g2, c),
        "b_not_canonical": (a, big_g2, c), "b_outside_subgroup": (a, _g2_outside_subgroup(), c),
        "a_wrong_shape": ((a[0],), b, c), "b_wrong_shape": (a, (1, 2, 3), c),
        "a_infinity": (None, b, c),
    }


PROOFS = _proofs()


@pytest.mark.parametrize("name", list(PROOFS))
def test_validate_and_verify_match_jax(processed, name):
    pvk, jpvk = processed
    a, b, c = PROOFS[name]
    proof, jproof = tg.Proof(a=a, b=b, c=c), jg.Proof(a=a, b=b, c=c)
    assert tg.validate_proof(proof) == jg.validate_proof(jproof)
    assert tg.validate_proof(proof) == (name in ("good", "a_infinity"))
    public = chain_circuit(k=254, a=3).get_public_inputs()
    want = jg.Groth16.verify_with_processed_vk(jpvk, public, jproof)
    assert tg.Groth16.verify_with_processed_vk(pvk, public, proof) == want == (name == "good")


def test_process_vk_matches_jax(processed):
    pvk, jpvk = processed
    assert pvk.alpha_beta.coeffs == jpvk.alpha_beta.coeffs
    assert (pvk.gamma_neg, pvk.delta_neg) == (jpvk.gamma_neg, jpvk.delta_neg)
    assert tg.prepare_verifying_key is tg.process_vk
    assert tg.verify_with_prepared is tg.verify_with_processed_vk
    public = chain_circuit(k=254, a=3).get_public_inputs() + [1]
    with pytest.raises(ValueError, match="public input length mismatch"):
        tg.Groth16.verify_with_processed_vk(pvk, public, tg.Proof(*_golden()))
    with pytest.raises(ValueError, match="public input length mismatch"):
        jg.Groth16.verify_with_processed_vk(jpvk, public, jg.Proof(*_golden()))


@pytest.mark.parametrize("field,value", [
    ("alpha_g1", "off_curve"), ("beta_g2", "outside_subgroup"), ("gamma_g2", "not_canonical"),
    ("delta_g2", "off_curve"), ("gamma_abc_g1", "off_curve")])
def test_validate_vk_matches_jax(keys, field, value):
    import dataclasses

    pk, jpk = keys
    vk = pk.vk
    if field == "gamma_abc_g1":
        x, y = vk.gamma_abc_g1[1]
        bad = [vk.gamma_abc_g1[0], (x, (y + 1) % Q)]
    elif field == "alpha_g1":
        bad = (vk.alpha_g1[0], (vk.alpha_g1[1] + 1) % Q)
    elif value == "outside_subgroup":
        bad = _g2_outside_subgroup()
    elif value == "not_canonical":
        (x0, x1), y = vk.gamma_g2
        bad = ((x0 + Q, x1), y)
    else:
        x, (y0, y1) = vk.delta_g2
        bad = (x, ((y0 + 1) % Q, y1))
    with pytest.raises(ValueError) as got:
        tg.validate_vk(dataclasses.replace(vk, **{field: bad}))
    with pytest.raises(ValueError) as want:
        jg.validate_vk(dataclasses.replace(jpk.vk, **{field: bad}))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        tg.Groth16.process_vk(dataclasses.replace(vk, **{field: bad}))
    tg.validate_vk(vk)  # the key itself is valid
