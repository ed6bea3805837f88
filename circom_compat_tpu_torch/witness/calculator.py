"""WitnessCalculator: drives circom-compiled WASM witness generators.

Supports both circom ABIs:
  - circom 2.x ("shared RW memory"): init / setInputSignal / getWitness /
    read-writeSharedRWMemory u32-limb protocol
    (reference: src/witness/witness_calculator.rs:111-152,
     src/witness/circom.rs:11-65)
  - circom 1.x (legacy): imported env.memory, getSignalOffset32 / setSignal /
    getPWitness with the SafeMemory Fr codec
    (reference: src/witness/memory.rs — kept for back-compat there too)

The WASM runs in the first-party interpreter (witness/wasm/), replacing the
reference's Wasmer embedding. It is the only engine: nothing falls back.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, List, Sequence, Union

from ..constants import R_SCALAR
from .fnv import fnv
from .memory import SafeMemory
from .wasm.interp import Instance, Memory
from .wasm.module import decode_module

InputValue = Union[int, str]
Inputs = Dict[str, Union[InputValue, Sequence[InputValue]]]


class WitnessCalcError(RuntimeError):
    pass


_EXCEPTION_MESSAGES = {
    1: "Signal not found.",
    2: "Too many signals set.",
    3: "Signal already set.",
    4: "Assert Failed.",
    5: "Not enough memory.",
    6: "Input signal array access exceeds the size.",
}


def _flatten(values) -> List[int]:
    if isinstance(values, (str, int)):
        values = [values]
    out: List[int] = []
    for v in values:
        if isinstance(v, (list, tuple)):
            out.extend(_flatten(v))
        elif isinstance(v, str):
            out.append(int(v))
        else:
            out.append(int(v))
    return out


class WitnessCalculator:
    def __init__(self, wasm_bytes: bytes):
        sys.setrecursionlimit(100000)
        self._err_parts: List[str] = []

        module = decode_module(wasm_bytes)
        needs_env_memory = any(
            i.kind == 2 and (i.module, i.name) == ("env", "memory")
            for i in module.imports
        )

        imports = {
            # circom 2.x host callbacks
            ("runtime", "exceptionHandler"): self._exception_handler,
            ("runtime", "printErrorMessage"): self._print_error_message,
            ("runtime", "writeBufferMessage"): lambda: None,
            ("runtime", "showSharedRWMemory"): lambda: None,
            # circom 1.x host callbacks (reference: witness_calculator.rs:65-82)
            ("runtime", "error"): self._runtime_error,
            ("runtime", "log"): lambda *_: None,
            ("runtime", "logSetSignal"): lambda *_: None,
            ("runtime", "logGetSignal"): lambda *_: None,
            ("runtime", "logStartComponent"): lambda *_: None,
            ("runtime", "logFinishComponent"): lambda *_: None,
        }
        if needs_env_memory:
            # the reference allocates a 2000-page host memory for this ABI
            imports[("env", "memory")] = Memory(2000)

        self.instance = Instance(module, imports)
        self.legacy = not self.instance.has_export("setInputSignal")

        if self.legacy:
            # Fr struct = 8-byte header + n32 u32 limbs (circom 1 runtime)
            self.n32 = (self.instance.exported("getFrLen")() >> 2) - 2
            p_raw_prime = self.instance.exported("getPRawPrime")()
            self.prime = int.from_bytes(
                self.instance.memory.read(p_raw_prime, self.n32 * 4), "little"
            )
            self.safe_memory = SafeMemory(self.instance.memory, self.n32)
        else:
            self.n32 = self.instance.exported("getFieldNumLen32")()
            self.instance.exported("getRawPrime")()
            read = self.instance.exported("readSharedRWMemory")
            limbs = [read(i) for i in range(self.n32)]
            self.prime = _from_u32_limbs(limbs)
            self.safe_memory = None

        self.n64 = ((self.prime.bit_length() - 1) // 64) + 1

    # -- host callbacks -------------------------------------------------------

    def _get_message(self) -> str:
        chars = []
        get_char = self.instance.exported("getMessageChar")
        while True:
            c = get_char()
            if not c:
                break
            chars.append(chr(c))
        return "".join(chars)

    def _print_error_message(self):
        self._err_parts.append(self._get_message())

    def _exception_handler(self, code: int):
        msg = _EXCEPTION_MESSAGES.get(code, "Unknown error.")
        detail = " ".join(self._err_parts)
        self._err_parts = []
        raise WitnessCalcError(f"{msg} {detail}".strip())

    def _runtime_error(self, *codes):
        raise WitnessCalcError(f"runtime error, exiting early: {codes}")

    # -- witness generation ---------------------------------------------------

    def calculate_witness(self, inputs: Inputs, sanity_check: bool = False) -> List[int]:
        """Run the circuit; returns canonical field elements in [0, r)."""
        if self.legacy:
            return self._calculate_witness_legacy(inputs, sanity_check)
        return self._calculate_witness_circom2(inputs, sanity_check)

    # Alias matching the reference's F-typed variant
    # (negatives are normalized mod r, reference: witness_calculator.rs:164-179).
    calculate_witness_element = calculate_witness

    def calculate_witness_limbs(self, inputs: Inputs, sanity_check: bool = False):
        """Run the circuit; returns the witness as a (n_wires, 16) uint32
        canonical 16-bit-limb array, one of the device prover's prepared
        assignment forms (models/groth16_device.encode_assignment)."""
        import numpy as np

        from ..ops import limbs as limb_codec

        vals = self.calculate_witness(inputs, sanity_check)
        return limb_codec.ints_to_limbs(vals, dtype=np.uint32)

    def _calculate_witness_circom2(self, inputs: Inputs, sanity_check: bool) -> List[int]:
        ex = self.instance.exported
        ex("init")(1 if sanity_check else 0)
        self._set_inputs_circom2(inputs)
        witness_size = ex("getWitnessSize")()
        return self._read_witness_circom2(witness_size)

    def _set_inputs_circom2(self, inputs: Inputs) -> None:
        ex = self.instance.exported
        n32 = self.n32
        write_shared = ex("writeSharedRWMemory")
        set_input = ex("setInputSignal")

        input_counter = 0
        for name, values in inputs.items():
            msb, lsb = fnv(name)
            for i, value in enumerate(_flatten(values)):
                v = value % R_SCALAR
                limbs = _to_u32_limbs(v, n32)
                for j in range(n32):
                    write_shared(j, limbs[n32 - 1 - j])
                set_input(msb, lsb, i)
                input_counter += 1

        if self.instance.has_export("getInputSize"):
            expected = ex("getInputSize")()
            if input_counter < expected:
                raise WitnessCalcError(
                    f"Not all inputs have been set. Only {input_counter} "
                    f"out of {expected}"
                )

    def _read_witness_circom2(self, witness_size: int) -> List[int]:
        ex = self.instance.exported
        n32 = self.n32
        get_witness = ex("getWitness")
        read_shared = ex("readSharedRWMemory")
        out: List[int] = []
        for i in range(witness_size):
            get_witness(i)
            limbs = [read_shared(j) for j in range(n32)]
            acc = 0
            for j in range(n32 - 1, -1, -1):
                acc = (acc << 32) | limbs[j]
            out.append(acc)
        return out

    def _calculate_witness_legacy(self, inputs: Inputs, sanity_check: bool) -> List[int]:
        ex = self.instance.exported
        safe = SafeMemory(self.instance.memory, self.n32)
        old_free = safe.free_pos()
        ex("init")(1 if sanity_check else 0)

        p_sig_offset = safe.alloc_u32()
        p_fr = safe.alloc_fr()
        get_signal_offset = ex("getSignalOffset32")
        set_signal = ex("setSignal")

        for name, values in inputs.items():
            msb, lsb = fnv(name)
            get_signal_offset(p_sig_offset, 0, msb, lsb)
            sig_offset = safe.read_u32(p_sig_offset)
            for i, value in enumerate(_flatten(values)):
                safe.write_fr(p_fr, value)
                set_signal(0, 0, sig_offset + i, p_fr)

        n_vars = ex("getNVars")()
        get_p_witness = ex("getPWitness")
        out = []
        for i in range(n_vars):
            ptr = get_p_witness(i)
            out.append(safe.read_fr(ptr) % self.prime)
        safe.set_free_pos(old_free)
        return out

    # -- convenience ----------------------------------------------------------

    @classmethod
    def from_file(cls, path) -> "WitnessCalculator":
        with open(path, "rb") as fh:
            return cls(fh.read())

    # the reference's constructor takes a path (witness_calculator.rs:49-56)
    @classmethod
    def new(cls, path) -> "WitnessCalculator":
        return cls.from_file(path)


def _from_u32_limbs(limbs: Iterable[int]) -> int:
    """Limbs as produced by readSharedRWMemory loop (LSW first)."""
    acc = 0
    for i, limb in enumerate(limbs):
        acc |= limb << (32 * i)
    return acc


def _to_u32_limbs(value: int, n32: int) -> List[int]:
    """Big-endian u32 limb vector of length n32 (matching the JS/Rust
    to_array32 layout, reference: witness_calculator.rs:34-46)."""
    out = [0] * n32
    rem = value
    c = n32
    while rem:
        c -= 1
        out[c] = rem & 0xFFFFFFFF
        rem >>= 32
    return out
