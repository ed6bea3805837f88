"""Ethereum interop: field/curve types <-> U256 tuples for Solidity Groth16
verifier contracts (reference: src/ethereum.rs).

U256 values are plain Python ints in [0, 2^256). Conversion semantics match
the reference: canonical (non-Montgomery) big-endian integers, zero point
<-> identity (reference: src/ethereum.rs:30-35, 71-76, 176-189), and G2
tuples serialize the c1 limb first for Solidity (reference:
src/ethereum.rs:81-86).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .constants import Q, R_SCALAR
from .models.groth16 import Proof as ArkProof
from .circom.zkey import VerifyingKey as ArkVerifyingKey


def _check_u256(v: int) -> int:
    v = int(v)
    if v < 0 or v >> 256:
        raise ValueError("not a u256")
    return v


@dataclass
class Inputs:
    """Vec<Fr> -> Vec<U256> (reference: src/ethereum.rs:10-18)."""

    elements: List[int]

    @classmethod
    def from_fr(cls, values) -> "Inputs":
        return cls([int(v) % R_SCALAR for v in values])


@dataclass
class G1:
    x: int
    y: int

    @classmethod
    def from_affine(cls, p: Optional[Tuple[int, int]]) -> "G1":
        if p is None:
            return cls(0, 0)
        return cls(p[0] % Q, p[1] % Q)

    def to_affine(self) -> Optional[Tuple[int, int]]:
        if self.x == 0 and self.y == 0:
            return None
        return (self.x % Q, self.y % Q)

    def as_tuple(self) -> Tuple[int, int]:
        return (_check_u256(self.x), _check_u256(self.y))


@dataclass
class G2:
    x: Tuple[int, int]  # (c0, c1)
    y: Tuple[int, int]

    @classmethod
    def from_affine(cls, p) -> "G2":
        if p is None:
            return cls((0, 0), (0, 0))
        (x0, x1), (y0, y1) = p
        return cls((x0 % Q, x1 % Q), (y0 % Q, y1 % Q))

    def to_affine(self):
        if self.x == (0, 0) and self.y == (0, 0):
            return None
        return (self.x, self.y)

    def as_tuple(self):
        """NB: c1 limb first — the Solidity pairing precompile convention
        (reference: src/ethereum.rs:81-86)."""
        return ((self.x[1], self.x[0]), (self.y[1], self.y[0]))


@dataclass
class Proof:
    a: G1
    b: G2
    c: G1

    @classmethod
    def from_ark(cls, proof: ArkProof) -> "Proof":
        return cls(
            a=G1.from_affine(proof.a),
            b=G2.from_affine(proof.b),
            c=G1.from_affine(proof.c),
        )

    def to_ark(self) -> ArkProof:
        return ArkProof(a=self.a.to_affine(), b=self.b.to_affine(), c=self.c.to_affine())

    def as_tuple(self):
        return (self.a.as_tuple(), self.b.as_tuple(), self.c.as_tuple())

    def abi_encoded(self) -> bytes:
        """ABI encoding of (a, b, c) as uint256[8] — the layout
        Verifier.verifyProof-style entry points consume."""
        (ax, ay), ((bx1, bx0), (by1, by0)), (cx, cy) = self.as_tuple()
        words = [ax, ay, bx1, bx0, by1, by0, cx, cy]
        return b"".join(w.to_bytes(32, "big") for w in words)


@dataclass
class VerifyingKey:
    alpha1: G1
    beta2: G2
    gamma2: G2
    delta2: G2
    ic: List[G1] = field(default_factory=list)

    @classmethod
    def from_ark(cls, vk: ArkVerifyingKey) -> "VerifyingKey":
        return cls(
            alpha1=G1.from_affine(vk.alpha_g1),
            beta2=G2.from_affine(vk.beta_g2),
            gamma2=G2.from_affine(vk.gamma_g2),
            delta2=G2.from_affine(vk.delta_g2),
            ic=[G1.from_affine(p) for p in vk.gamma_abc_g1],
        )

    def to_ark(self) -> ArkVerifyingKey:
        return ArkVerifyingKey(
            alpha_g1=self.alpha1.to_affine(),
            beta_g2=self.beta2.to_affine(),
            gamma_g2=self.gamma2.to_affine(),
            delta_g2=self.delta2.to_affine(),
            gamma_abc_g1=[p.to_affine() for p in self.ic],
        )

    def as_tuple(self):
        return (
            self.alpha1.as_tuple(),
            self.beta2.as_tuple(),
            self.gamma2.as_tuple(),
            self.delta2.as_tuple(),
            [p.as_tuple() for p in self.ic],
        )


def point_to_u256(value: int, modulus: int = Q) -> int:
    """Canonical big-endian U256 of a field element
    (reference: src/ethereum.rs:185-189)."""
    return int(value) % modulus


def u256_to_point(value: int, modulus: int = Q) -> int:
    v = _check_u256(value)
    if v >= modulus:
        raise ValueError("u256 not a canonical field element")
    return v
