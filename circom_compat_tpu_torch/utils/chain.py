"""Synthetic squaring-chain circuit: the repo's benchmark shape at any size.

Wires [1, out, a, b1..b_{k-1}]; constraints a*a = b1, b_i*b_i = b_{i+1},
b_{k-1}*b_{k-1} = out. k constraints and 2 instance variables, so the
domain is k + 2: pick k = 2^m - 2 for a power-of-two domain.

chain_witness and chain_matrices build the assignment and the A/B
matrices without the per-entry Python lists of chain_circuit, for keys
of 2^22 and more.
"""

from __future__ import annotations

import numpy as np

from ..circom.circuit import CircomCircuit
from ..circom.r1cs import R1CS
from ..circom.zkey import ConstraintMatrices
from ..constants import MONT_R_R, R_SCALAR
from ..ops import limbs as limb_codec


def chain_witness(k: int = 62, a: int = 3) -> list:
    """The chain's full assignment [1, out, a, b1..b_{k-1}] as ints."""
    witness = [1, 0, a] + [0] * (k - 1)
    v = a
    for i in range(k - 1):
        v = v * v % R_SCALAR
        witness[3 + i] = v
    witness[1] = v * v % R_SCALAR
    return witness


def chain_circuit(k: int = 62, a: int = 3) -> CircomCircuit:
    """The chain as a witness-attached CircomCircuit (constraints hold
    (wire, coeff) pairs; to_matrices() gives the (value, wire) rows)."""
    constraints = [([(2, 1)], [(2, 1)], [(3, 1)])]
    for w in range(3, k + 1):
        constraints.append(([(w, 1)], [(w, 1)], [(w + 1, 1)]))
    last = k + 1
    constraints.append(([(last, 1)], [(last, 1)], [(1, 1)]))
    r1cs = R1CS(num_inputs=2, num_aux=k, num_variables=k + 2, constraints=constraints,
                wire_mapping=None)
    return CircomCircuit(r1cs=r1cs, witness=chain_witness(k, a))


def chain_matrices(k: int = 62) -> ConstraintMatrices:
    """The chain's A and B as ConstraintMatrices: row i of both reads wire
    i + 2 with coefficient one (its Montgomery form R mod r), the matrices
    that models.groth16_device.matrices_from_rows makes of
    chain_circuit(k).to_matrices()."""
    rows = np.arange(k, dtype=np.int64)
    one = np.broadcast_to(limb_codec.int_to_limbs(MONT_R_R, np.uint16), (k, 16))
    return ConstraintMatrices(
        num_instance_variables=2, num_witness_variables=k + 1, num_constraints=k,
        a_rows=rows, a_cols=rows + 2, a_values_mont=np.array(one),
        b_rows=rows.copy(), b_cols=rows + 2, b_values_mont=np.array(one),
    )
