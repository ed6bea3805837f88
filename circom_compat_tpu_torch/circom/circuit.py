"""CircomCircuit: R1CS + witness container with satisfiability checking.

Mirrors the reference's ConstraintSynthesizer bridge (reference:
src/circom/circuit.rs:11-82): wire-mapped variable allocation, the
instance/witness index split at num_inputs, and get_public_inputs. There is
no external constraint-system framework to synthesize into here, so the
circuit exposes the constraint check and matrix extraction directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..constants import R_SCALAR
from .r1cs import R1CS


@dataclass
class CircomCircuit:
    r1cs: R1CS
    witness: Optional[List[int]] = None

    def get_public_inputs(self) -> Optional[List[int]]:
        """Public inputs w[1..num_inputs] through the wire mapping
        (reference: src/circom/circuit.rs:18-26)."""
        if self.witness is None:
            return None
        w = self.witness
        m = self.r1cs.wire_mapping
        if m is None:
            return list(w[1 : self.r1cs.num_inputs])
        return [w[m[i]] for i in range(1, self.r1cs.num_inputs)]

    def full_assignment(self) -> List[int]:
        """Assignment vector ordered [1, publics..., aux...] exactly as the
        arkworks constraint system would lay it out (instance vars first;
        reference: src/circom/circuit.rs:35-57)."""
        if self.witness is None:
            raise ValueError("no witness attached")
        w = self.witness
        m = self.r1cs.wire_mapping
        n = self.r1cs.num_variables
        if m is None:
            return [w[i] % R_SCALAR for i in range(n)]
        return [w[m[i]] % R_SCALAR for i in range(n)]

    def _eval_lc(self, lc, assignment) -> int:
        acc = 0
        for wire, coeff in lc:
            acc += coeff * assignment[wire]
        return acc % R_SCALAR

    def is_satisfied(self) -> bool:
        return self.which_is_unsatisfied() is None

    def which_is_unsatisfied(self) -> Optional[int]:
        """Index of the first unsatisfied constraint, or None
        (the reference surfaces this via arkworks in debug builds,
        src/circom/builder.rs:101-114)."""
        assignment = self.full_assignment()
        for idx, (a, b, c) in enumerate(self.r1cs.constraints):
            lhs = self._eval_lc(a, assignment) * self._eval_lc(b, assignment) % R_SCALAR
            if lhs != self._eval_lc(c, assignment):
                return idx
        return None

    def to_matrices(self):
        """Sparse A/B/C row lists [(value, wire)] in assignment order — the
        input shape of the witness map (models/groth16 + ops/ntt)."""
        a, b, c = [], [], []
        for ca, cb, cc in self.r1cs.constraints:
            a.append([(coeff % R_SCALAR, wire) for wire, coeff in ca])
            b.append([(coeff % R_SCALAR, wire) for wire, coeff in cb])
            c.append([(coeff % R_SCALAR, wire) for wire, coeff in cc])
        return a, b, c
