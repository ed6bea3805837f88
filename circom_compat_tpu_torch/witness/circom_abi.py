"""Typed facade over the Circom-generated WASM exports.

Mirrors the reference's `Wasm` wrapper (reference: src/witness/circom.rs:4-71)
one method per export, raising WasmTrap on a missing export the same way the
reference panics. Works over any instance that exposes
`exported()`/`has_export()` (the interpreter, witness/wasm/interp.py).
"""

from __future__ import annotations

from .wasm.interp import WasmTrap


class Wasm:
    """reference: src/witness/circom.rs `Wasm` struct (:4-8)."""

    def __init__(self, instance):
        self.instance = instance

    def _call(self, name: str, *args):
        if not self.instance.has_export(name):
            raise WasmTrap(f"function {name} not found")  # reference: :67-71
        return self.instance.exported(name)(*args)

    # circom 2.x ABI (reference: circom.rs:11-59)
    def get_field_num_len32(self) -> int:
        return self._call("getFieldNumLen32")

    def get_raw_prime(self) -> None:
        self._call("getRawPrime")

    def read_shared_rw_memory(self, i: int) -> int:
        return self._call("readSharedRWMemory", i)

    def write_shared_rw_memory(self, i: int, v: int) -> None:
        self._call("writeSharedRWMemory", i, v)

    def set_input_signal(self, hmsb: int, hlsb: int, pos: int) -> None:
        self._call("setInputSignal", hmsb, hlsb, pos)

    def get_witness(self, i: int) -> None:
        self._call("getWitness", i)

    def get_witness_size(self) -> int:
        return self._call("getWitnessSize")

    def init(self, sanity_check: bool) -> None:
        self._call("init", 1 if sanity_check else 0)

    # circom 1.x ABI (reference: circom.rs legacy exports)
    def get_fr_len(self) -> int:
        return self._call("getFrLen")

    def get_ptr_raw_prime(self) -> int:
        return self._call("getPRawPrime")

    def get_n_vars(self) -> int:
        return self._call("getNVars")

    def get_signal_offset32(self, p_sig_offset: int, component: int,
                            hash_msb: int, hash_lsb: int) -> None:
        self._call("getSignalOffset32", p_sig_offset, component, hash_msb, hash_lsb)

    def set_signal(self, c_idx: int, component: int, signal: int, p_val: int) -> None:
        self._call("setSignal", c_idx, component, signal, p_val)
