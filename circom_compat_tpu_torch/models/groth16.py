"""Groth16 facade: prove on the card, verify on the host.

The prover is models/groth16_device.py. Verification is one pairing
product against the prepared verifying key, on the host (refmath); it is
O(1) per proof. Proof and verifying-key points are range-, curve- and (for
G2) subgroup-checked before any pairing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from ..circom.zkey import ProvingKey, VerifyingKey
from ..constants import Q, R_SCALAR
from ..refmath import curve, pairing
from ..refmath.field import FQ12


@dataclass
class Proof:
    a: Optional[Tuple[int, int]]  # G1
    b: object  # G2
    c: Optional[Tuple[int, int]]  # G1


@dataclass
class PreparedVerifyingKey:
    vk: VerifyingKey
    alpha_beta: FQ12  # e(alpha, beta)
    gamma_neg: object  # -gamma_g2
    delta_neg: object  # -delta_g2


def _fq_ok(v) -> bool:
    return isinstance(v, int) and 0 <= v < Q


def validate_g1(p) -> bool:
    """None (infinity) or an on-curve G1 point with canonical coordinates
    (G1's cofactor is 1)."""
    if p is None:
        return True
    if not (isinstance(p, (tuple, list)) and len(p) == 2):
        return False
    return _fq_ok(p[0]) and _fq_ok(p[1]) and curve.G1.is_on_curve((p[0], p[1]))


def validate_g2(p) -> bool:
    """None or a G2 point with canonical coordinates in the order-r subgroup."""
    if p is None:
        return True
    try:
        (x0, x1), (y0, y1) = p
    except (TypeError, ValueError):
        return False
    if not all(_fq_ok(v) for v in (x0, x1, y0, y1)):
        return False
    return curve.g2_in_correct_subgroup(((x0, x1), (y0, y1)))


def prepare_verifying_key(vk: VerifyingKey) -> PreparedVerifyingKey:
    if not validate_g1(vk.alpha_g1):
        raise ValueError("vk.alpha_g1 is not a valid G1 point")
    for name in ("beta_g2", "gamma_g2", "delta_g2"):
        if not validate_g2(getattr(vk, name)):
            raise ValueError(f"vk.{name} is not a valid G2 point")
    for i, p in enumerate(vk.gamma_abc_g1):
        if not validate_g1(p):
            raise ValueError(f"vk.gamma_abc_g1[{i}] is not a valid G1 point")
    return PreparedVerifyingKey(
        vk=vk, alpha_beta=pairing.pairing(vk.beta_g2, vk.alpha_g1),
        gamma_neg=curve.G2.neg(vk.gamma_g2), delta_neg=curve.G2.neg(vk.delta_g2),
    )


def verify_with_prepared(pvk: PreparedVerifyingKey, public_inputs: Sequence[int],
                         proof: Proof) -> bool:
    """e(A, B) == e(alpha, beta) * e(IC(x), gamma) * e(C, delta)."""
    if not (validate_g1(proof.a) and validate_g2(proof.b) and validate_g1(proof.c)):
        return False
    ic = pvk.vk.gamma_abc_g1
    if len(public_inputs) + 1 != len(ic):
        raise ValueError("public input length mismatch")
    acc = ic[0]
    for x, base in zip(public_inputs, ic[1:]):
        acc = curve.G1.add(acc, curve.G1.mul(base, x % R_SCALAR))
    f = pairing.multi_pairing(
        [(proof.a, proof.b), (acc, pvk.gamma_neg), (proof.c, pvk.delta_neg)])
    return f == pvk.alpha_beta


def verify_proof(vk: VerifyingKey, proof: Proof, public_inputs: Sequence[int]) -> bool:
    return verify_with_prepared(prepare_verifying_key(vk), public_inputs, proof)


class Groth16:
    @staticmethod
    def create_proof_with_reduction_and_matrices(
        pk: ProvingKey, r: int, s: int, matrices, num_inputs: int, num_constraints: int,
        full_assignment: Sequence[int], device=None,
    ) -> Proof:
        """Deterministic prove with explicit randomizers r, s, on the card
        unless device names another (device="cpu": the plain versions)."""
        from . import groth16_device

        return groth16_device.prove(pk, r, s, matrices, num_inputs, num_constraints,
                                    full_assignment, device=device)

    prepare_verifying_key = staticmethod(prepare_verifying_key)
    verify_proof = staticmethod(verify_proof)
