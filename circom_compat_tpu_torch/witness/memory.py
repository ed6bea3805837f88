"""SafeMemory: typed reader/writer for circom-1-era WASM linear memory.

Implements the legacy Fr encoding used by circom 1.x witness generators
(the complex-circuit benchmark artifacts use this ABI): free-pointer
allocation at offset 0, short-i32 vs long-bigint forms with flag bytes —
0x80 = long form, 0x40 = Montgomery (multiply by R^-1 on read).
(reference: src/witness/memory.rs:37-206)
"""

from __future__ import annotations

from ..constants import R_SCALAR, MONT_R_INV_R
from .wasm.interp import Memory

SHORT_MAX = 0x80000000
SHORT_MIN = R_SCALAR - SHORT_MAX


class SafeMemory:
    def __init__(self, memory: Memory, n32: int, prime: int = R_SCALAR):
        self.memory = memory
        self.n32 = n32
        self.prime = prime
        self.r_inv = MONT_R_INV_R % prime

    # -- raw access ----------------------------------------------------------

    def read_u32(self, ptr: int) -> int:
        return int.from_bytes(self.memory.read(ptr, 4), "little")

    def write_u32(self, ptr: int, value: int) -> None:
        self.memory.write(ptr, (value & 0xFFFFFFFF).to_bytes(4, "little"))

    def read_byte(self, ptr: int) -> int:
        return self.memory.read(ptr, 1)[0]

    # -- free-pointer allocation (offset 0 holds the next free position) -----

    def free_pos(self) -> int:
        return self.read_u32(0)

    def set_free_pos(self, ptr: int) -> None:
        self.write_u32(0, ptr)

    def alloc_u32(self) -> int:
        p = self.free_pos()
        self.set_free_pos(p + 8)
        return p

    def alloc_fr(self) -> int:
        p = self.free_pos()
        self.set_free_pos(p + self.n32 * 4 + 8)
        return p

    # -- Fr codec -------------------------------------------------------------

    def write_fr(self, ptr: int, value: int) -> None:
        """value may be any int (negatives use the short 2s-complement form
        when small, mirroring reference: src/witness/memory.rs:116-128)."""
        if -SHORT_MAX < value < SHORT_MAX:
            self.write_u32(ptr, value & 0xFFFFFFFF)
            self.write_u32(ptr + 4, 0)
        else:
            self.write_u32(ptr, 0)
            self.write_u32(ptr + 4, 0x80000000)
            self.memory.write(ptr + 8, (value % self.prime).to_bytes(32, "little"))

    def read_fr(self, ptr: int) -> int:
        flag = self.read_byte(ptr + 4 + 3)
        flag2 = self.read_byte(ptr + 3)
        if flag & 0x80:
            num = int.from_bytes(self.memory.read(ptr + 8, self.n32 * 4), "little")
            if flag & 0x40:
                num = (num * self.r_inv) % self.prime
            return num
        if flag2 & 0x40:
            # small negative in 2s complement
            return self.read_u32(ptr) - 0x100000000
        return self.read_u32(ptr)
