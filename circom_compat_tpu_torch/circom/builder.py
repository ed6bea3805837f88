"""CircomConfig / CircomBuilder: artifact loading and witness-attached
circuit construction (reference: src/circom/builder.rs:14-118)."""

from __future__ import annotations

from typing import Dict, List

from ..witness.calculator import WitnessCalculator
from .circuit import CircomCircuit
from .r1cs import R1CS, read_r1cs


class CircomConfig:
    """Loads the .wasm witness generator and .r1cs constraint file
    (reference: src/circom/builder.rs:30-41)."""

    def __init__(self, wasm_path, r1cs_path, sanity_check: bool = False):
        self.wtns = WitnessCalculator.from_file(wasm_path)
        self.r1cs: R1CS = read_r1cs(r1cs_path)
        self.sanity_check = sanity_check

    @classmethod
    def new(cls, wasm_path, r1cs_path) -> "CircomConfig":
        return cls(wasm_path, r1cs_path)

    @classmethod
    def new_from_wasm(cls, wtns: WitnessCalculator, r1cs_path) -> "CircomConfig":
        self = cls.__new__(cls)
        self.wtns = wtns
        self.r1cs = read_r1cs(r1cs_path)
        self.sanity_check = False
        return self


class CircomBuilder:
    def __init__(self, cfg: CircomConfig):
        self.cfg = cfg
        self.inputs: Dict[str, List[int]] = {}

    def push_input(self, name: str, value) -> None:
        """Accumulate one input value under `name`
        (reference: src/circom/builder.rs:68-71)."""
        self.inputs.setdefault(name, []).append(int(value))

    def setup(self) -> CircomCircuit:
        """Witness-less circuit for trusted setup; wire mapping disabled
        (reference: src/circom/builder.rs:75-85)."""
        r1cs = R1CS(
            num_inputs=self.cfg.r1cs.num_inputs,
            num_aux=self.cfg.r1cs.num_aux,
            num_variables=self.cfg.r1cs.num_variables,
            constraints=self.cfg.r1cs.constraints,
            wire_mapping=None,
        )
        return CircomCircuit(r1cs=r1cs, witness=None)

    def build(self) -> CircomCircuit:
        """Run witness generation and return the populated circuit, asserting
        constraint satisfaction (reference: src/circom/builder.rs:89-117)."""
        circom = self.setup()
        witness = self.cfg.wtns.calculate_witness(
            self.inputs, self.cfg.sanity_check
        )
        circom.witness = witness
        bad = circom.which_is_unsatisfied()
        if bad is not None:
            raise ValueError(f"Unsatisfied constraint: {bad}")
        return circom
