"""Synthetic squaring-chain circuit: the repo's benchmark shape at any size.

Wires [1, out, a, b1..b_{k-1}]; constraints a*a = b1, b_i*b_i = b_{i+1},
b_{k-1}*b_{k-1} = out. k constraints and 2 instance variables, so the
domain is k + 2: pick k = 2^m - 2 for a power-of-two domain.
"""

from __future__ import annotations

from ..circom.circuit import CircomCircuit
from ..circom.r1cs import R1CS
from ..constants import R_SCALAR


def chain_circuit(k: int = 62, a: int = 3) -> CircomCircuit:
    """The chain as a witness-attached CircomCircuit (constraints hold
    (wire, coeff) pairs; to_matrices() gives the (value, wire) rows)."""
    constraints = [([(2, 1)], [(2, 1)], [(3, 1)])]
    for w in range(3, k + 1):
        constraints.append(([(w, 1)], [(w, 1)], [(w + 1, 1)]))
    last = k + 1
    constraints.append(([(last, 1)], [(last, 1)], [(1, 1)]))

    witness = [1, 0, a] + [0] * (k - 1)
    v = a
    for i in range(k - 1):
        v = v * v % R_SCALAR
        witness[3 + i] = v
    witness[1] = v * v % R_SCALAR
    r1cs = R1CS(num_inputs=2, num_aux=k, num_variables=k + 2, constraints=constraints,
                wire_mapping=None)
    return CircomCircuit(r1cs=r1cs, witness=witness)
