"""Synthetic squaring-chain circuit: the repo's benchmark shape at any size.

Wires [1, out, a, b1..b_{k-1}]; constraints a*a = b1, b_i*b_i = b_{i+1},
b_{k-1}*b_{k-1} = out. k constraints and 2 instance variables, so the
domain is k + 2: pick k = 2^m - 2 for a power-of-two domain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..constants import R_SCALAR

Row = List[Tuple[int, int]]  # [(value, wire)]


@dataclass
class ChainCircuit:
    a: List[Row]
    b: List[Row]
    c: List[Row]
    num_inputs: int  # instance variables, the constant wire included
    witness: List[int]

    @property
    def num_constraints(self) -> int:
        return len(self.a)

    @property
    def num_variables(self) -> int:
        return len(self.witness)

    def to_matrices(self) -> Tuple[List[Row], List[Row], List[Row]]:
        """(A, B, C) row lists, the input of the setup (models/setup.py)."""
        return self.a, self.b, self.c

    def full_assignment(self) -> List[int]:
        return self.witness

    def get_public_inputs(self) -> List[int]:
        return self.witness[1 : self.num_inputs]


def chain_circuit(k: int = 62, a: int = 3) -> ChainCircuit:
    ra: List[Row] = [[(1, 2)]]
    rc: List[Row] = [[(1, 3)]]
    for i in range(1, k - 1):
        ra.append([(1, 2 + i)])
        rc.append([(1, 3 + i)])
    ra.append([(1, 2 + k - 1)])
    rc.append([(1, 1)])

    witness = [1, 0, a] + [0] * (k - 1)
    v = a
    for i in range(k - 1):
        v = v * v % R_SCALAR
        witness[3 + i] = v
    witness[1] = v * v % R_SCALAR
    return ChainCircuit(a=ra, b=[list(r) for r in ra], c=rc, num_inputs=2,
                        witness=witness)
