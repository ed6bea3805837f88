"""circom_compat_tpu_torch Ethereum encodings (ethereum.py) against the JAX
package: the U256 tuples and ABI bytes of the chain254 golden proof, its
verifying key and public inputs; the point-at-infinity encodings; the
round trips back to the port's Proof / VerifyingKey; point_to_u256 and
u256_to_point, their errors included. Tolerance: exact equality.
"""

import pathlib

import pytest

from circom_compat_tpu import ethereum as jeth
from circom_compat_tpu.circom.zkey import read_zkey as jax_read_zkey
from circom_compat_tpu.models.groth16 import Proof as JaxProof
from circom_compat_tpu_torch import ethereum as eth
from circom_compat_tpu_torch.circom.zkey import read_zkey
from circom_compat_tpu_torch.constants import Q, R_SCALAR
from circom_compat_tpu_torch.models.groth16 import Proof
from test_torch_groth16 import _golden as golden_proof

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def _golden():
    """The chain254 golden proof's (A, B, C)."""
    proof = golden_proof()[1]
    return proof.a, proof.b, proof.c


@pytest.mark.parametrize("infinity", [None, "a", "b"])
def test_proof_tuples_match_jax(infinity):
    a, b, c = _golden()
    if infinity == "a":
        a = None
    elif infinity == "b":
        b = None
    ep, jp = eth.Proof.from_ark(Proof(a, b, c)), jeth.Proof.from_ark(JaxProof(a, b, c))
    assert ep.as_tuple() == jp.as_tuple()
    assert ep.abi_encoded() == jp.abi_encoded()
    assert ep.to_ark() == Proof(a, b, c)
    if infinity == "b":
        assert ep.as_tuple()[1] == ((0, 0), (0, 0))


def test_vk_and_inputs_match_jax():
    vk = read_zkey(GOLDEN / "chain254.zkey")[0].vk
    jvk = jax_read_zkey(GOLDEN / "chain254.zkey")[0].vk
    ev = eth.VerifyingKey.from_ark(vk)
    assert ev.as_tuple() == jeth.VerifyingKey.from_ark(jvk).as_tuple()
    assert ev.to_ark() == vk
    public = [5, R_SCALAR + 7, -1]
    assert eth.Inputs.from_fr(public) == eth.Inputs([5, 7, R_SCALAR - 1])
    assert eth.Inputs.from_fr(public).elements == jeth.Inputs.from_fr(public).elements


def test_u256_helpers_match_jax():
    for v in (0, 1, Q - 1, Q, Q + 5, 2**255):
        assert eth.point_to_u256(v) == jeth.point_to_u256(v)
    assert eth.u256_to_point(Q - 1) == Q - 1
    for bad in (Q, 2**256, -1):
        with pytest.raises(ValueError) as got:
            eth.u256_to_point(bad)
        with pytest.raises(ValueError) as want:
            jeth.u256_to_point(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not a u256"):
        eth.G1(2**256, 0).as_tuple()
