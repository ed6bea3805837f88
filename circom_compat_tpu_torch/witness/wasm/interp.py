"""Core-WASM interpreter executing circom-compiled witness generators.

Each function body is compiled once into a flat instruction list with
branch targets and stack-unwind heights resolved statically (WASM validation
guarantees static stack heights, so no runtime control-frame bookkeeping is
needed). Values: i32/i64 are kept as unsigned Python ints, normalized at op
boundaries; f32/f64 as Python floats.

Replaces the Wasmer embedding used by the reference
(reference: src/witness/witness_calculator.rs:63-89).
"""

from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional, Tuple

from .module import Module, decode_module, PAGE_SIZE

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF
SIGN32 = 0x80000000
SIGN64 = 0x8000000000000000


class WasmTrap(RuntimeError):
    pass


def _s32(v: int) -> int:
    return v - 0x100000000 if v & SIGN32 else v


def _s64(v: int) -> int:
    return v - 0x10000000000000000 if v & SIGN64 else v


def _div_s(a: int, b: int, mask: int, sign: int, width: int) -> int:
    if b == 0:
        raise WasmTrap("integer divide by zero")
    sa = a - (mask + 1) if a & sign else a
    sb = b - (mask + 1) if b & sign else b
    if sa == -(sign) and sb == -1:
        raise WasmTrap("integer overflow")
    q = abs(sa) // abs(sb)
    if (sa < 0) != (sb < 0):
        q = -q
    return q & mask


def _rem_s(a: int, b: int, mask: int, sign: int) -> int:
    if b == 0:
        raise WasmTrap("integer divide by zero")
    sa = a - (mask + 1) if a & sign else a
    sb = b - (mask + 1) if b & sign else b
    r = abs(sa) % abs(sb)
    if sa < 0:
        r = -r
    return r & mask


def _clz(v: int, bits: int) -> int:
    if v == 0:
        return bits
    return bits - v.bit_length()


def _ctz(v: int, bits: int) -> int:
    if v == 0:
        return bits
    return (v & -v).bit_length() - 1


def _rotl(v: int, n: int, bits: int, mask: int) -> int:
    n &= bits - 1
    return ((v << n) | (v >> (bits - n))) & mask


def _rotr(v: int, n: int, bits: int, mask: int) -> int:
    n &= bits - 1
    return ((v >> n) | (v << (bits - n))) & mask


def _trunc(v: float, lo: int, hi: int, mask: int) -> int:
    if v != v:
        raise WasmTrap("invalid conversion to integer: NaN")
    t = int(v)  # trunc toward zero
    if t < lo or t > hi:
        raise WasmTrap("integer overflow in trunc")
    return t & mask


# Binary ops: opcode -> fn(a, b) with unsigned-normalized ints
_BINOPS: Dict[int, Callable] = {
    # i32 compare
    0x46: lambda a, b: 1 if a == b else 0,
    0x47: lambda a, b: 1 if a != b else 0,
    0x48: lambda a, b: 1 if _s32(a) < _s32(b) else 0,
    0x49: lambda a, b: 1 if a < b else 0,
    0x4A: lambda a, b: 1 if _s32(a) > _s32(b) else 0,
    0x4B: lambda a, b: 1 if a > b else 0,
    0x4C: lambda a, b: 1 if _s32(a) <= _s32(b) else 0,
    0x4D: lambda a, b: 1 if a <= b else 0,
    0x4E: lambda a, b: 1 if _s32(a) >= _s32(b) else 0,
    0x4F: lambda a, b: 1 if a >= b else 0,
    # i64 compare
    0x51: lambda a, b: 1 if a == b else 0,
    0x52: lambda a, b: 1 if a != b else 0,
    0x53: lambda a, b: 1 if _s64(a) < _s64(b) else 0,
    0x54: lambda a, b: 1 if a < b else 0,
    0x55: lambda a, b: 1 if _s64(a) > _s64(b) else 0,
    0x56: lambda a, b: 1 if a > b else 0,
    0x57: lambda a, b: 1 if _s64(a) <= _s64(b) else 0,
    0x58: lambda a, b: 1 if a <= b else 0,
    0x59: lambda a, b: 1 if _s64(a) >= _s64(b) else 0,
    0x5A: lambda a, b: 1 if a >= b else 0,
    # f32/f64 compare (identical semantics for Python floats)
    0x5B: lambda a, b: 1 if a == b else 0,
    0x5C: lambda a, b: 1 if a != b else 0,
    0x5D: lambda a, b: 1 if a < b else 0,
    0x5E: lambda a, b: 1 if a > b else 0,
    0x5F: lambda a, b: 1 if a <= b else 0,
    0x60: lambda a, b: 1 if a >= b else 0,
    0x61: lambda a, b: 1 if a == b else 0,
    0x62: lambda a, b: 1 if a != b else 0,
    0x63: lambda a, b: 1 if a < b else 0,
    0x64: lambda a, b: 1 if a > b else 0,
    0x65: lambda a, b: 1 if a <= b else 0,
    0x66: lambda a, b: 1 if a >= b else 0,
    # i32 arithmetic
    0x6A: lambda a, b: (a + b) & M32,
    0x6B: lambda a, b: (a - b) & M32,
    0x6C: lambda a, b: (a * b) & M32,
    0x6D: lambda a, b: _div_s(a, b, M32, SIGN32, 32),
    0x6E: lambda a, b: (a // b) if b else _raise_div0(),
    0x6F: lambda a, b: _rem_s(a, b, M32, SIGN32),
    0x70: lambda a, b: (a % b) if b else _raise_div0(),
    0x71: lambda a, b: a & b,
    0x72: lambda a, b: a | b,
    0x73: lambda a, b: a ^ b,
    0x74: lambda a, b: (a << (b & 31)) & M32,
    0x75: lambda a, b: (_s32(a) >> (b & 31)) & M32,
    0x76: lambda a, b: a >> (b & 31),
    0x77: lambda a, b: _rotl(a, b, 32, M32),
    0x78: lambda a, b: _rotr(a, b, 32, M32),
    # i64 arithmetic
    0x7C: lambda a, b: (a + b) & M64,
    0x7D: lambda a, b: (a - b) & M64,
    0x7E: lambda a, b: (a * b) & M64,
    0x7F: lambda a, b: _div_s(a, b, M64, SIGN64, 64),
    0x80: lambda a, b: (a // b) if b else _raise_div0(),
    0x81: lambda a, b: _rem_s(a, b, M64, SIGN64),
    0x82: lambda a, b: (a % b) if b else _raise_div0(),
    0x83: lambda a, b: a & b,
    0x84: lambda a, b: a | b,
    0x85: lambda a, b: a ^ b,
    0x86: lambda a, b: (a << (b & 63)) & M64,
    0x87: lambda a, b: (_s64(a) >> (b & 63)) & M64,
    0x88: lambda a, b: a >> (b & 63),
    0x89: lambda a, b: _rotl(a, b, 64, M64),
    0x8A: lambda a, b: _rotr(a, b, 64, M64),
    # f32 arithmetic
    0x92: lambda a, b: a + b,
    0x93: lambda a, b: a - b,
    0x94: lambda a, b: a * b,
    0x95: lambda a, b: _fdiv(a, b),
    0x96: lambda a, b: min(a, b),
    0x97: lambda a, b: max(a, b),
    0x98: lambda a, b: abs(a) * (1 if b >= 0 else -1),
    # f64 arithmetic
    0xA0: lambda a, b: a + b,
    0xA1: lambda a, b: a - b,
    0xA2: lambda a, b: a * b,
    0xA3: lambda a, b: _fdiv(a, b),
    0xA4: lambda a, b: min(a, b),
    0xA5: lambda a, b: max(a, b),
    0xA6: lambda a, b: abs(a) * (1 if b >= 0 else -1),
}


def _raise_div0():
    raise WasmTrap("integer divide by zero")


def _fdiv(a, b):
    if b == 0:
        return float("inf") if a > 0 else (float("-inf") if a < 0 else float("nan"))
    return a / b


# Unary ops: opcode -> fn(a)
_UNOPS: Dict[int, Callable] = {
    0x45: lambda a: 1 if a == 0 else 0,  # i32.eqz
    0x50: lambda a: 1 if a == 0 else 0,  # i64.eqz
    0x67: lambda a: _clz(a, 32),
    0x68: lambda a: _ctz(a, 32),
    0x69: lambda a: bin(a).count("1"),
    0x79: lambda a: _clz(a, 64),
    0x7A: lambda a: _ctz(a, 64),
    0x7B: lambda a: bin(a).count("1"),
    # f32/f64 unary
    0x8B: abs,
    0x8C: lambda a: -a,
    0x8D: lambda a: float(__import__("math").ceil(a)),
    0x8E: lambda a: float(__import__("math").floor(a)),
    0x8F: lambda a: float(int(a)),
    0x90: lambda a: float(round(a)),
    0x91: lambda a: a**0.5,
    0x99: abs,
    0x9A: lambda a: -a,
    0x9B: lambda a: float(__import__("math").ceil(a)),
    0x9C: lambda a: float(__import__("math").floor(a)),
    0x9D: lambda a: float(int(a)),
    0x9E: lambda a: float(round(a)),
    0x9F: lambda a: a**0.5,
    # conversions
    0xA7: lambda a: a & M32,  # i32.wrap_i64
    0xA8: lambda a: _trunc(a, -(1 << 31), (1 << 31) - 1, M32),  # i32.trunc_f32_s
    0xA9: lambda a: _trunc(a, 0, M32, M32),
    0xAA: lambda a: _trunc(a, -(1 << 31), (1 << 31) - 1, M32),
    0xAB: lambda a: _trunc(a, 0, M32, M32),
    0xAC: lambda a: _s32(a) & M64,  # i64.extend_i32_s
    0xAD: lambda a: a,  # i64.extend_i32_u
    0xAE: lambda a: _trunc(a, -(1 << 63), (1 << 63) - 1, M64),
    0xAF: lambda a: _trunc(a, 0, M64, M64),
    0xB0: lambda a: _trunc(a, -(1 << 63), (1 << 63) - 1, M64),
    0xB1: lambda a: _trunc(a, 0, M64, M64),
    0xB2: lambda a: float(_s32(a)),  # f32.convert_i32_s
    0xB3: lambda a: float(a),
    0xB4: lambda a: float(_s64(a)),
    0xB5: lambda a: float(a),
    0xB6: lambda a: struct.unpack("<f", struct.pack("<f", a))[0],  # f32.demote_f64
    0xB7: lambda a: float(_s32(a)),  # f64.convert_i32_s
    0xB8: lambda a: float(a),
    0xB9: lambda a: float(_s64(a)),
    0xBA: lambda a: float(a),
    0xBB: lambda a: a,  # f64.promote_f32
    0xBC: lambda a: struct.unpack("<I", struct.pack("<f", a))[0],  # i32.reinterpret_f32
    0xBD: lambda a: struct.unpack("<Q", struct.pack("<d", a))[0],
    0xBE: lambda a: struct.unpack("<f", struct.pack("<I", a))[0],
    0xBF: lambda a: struct.unpack("<d", struct.pack("<Q", a))[0],
    # sign extension
    0xC0: lambda a: ((a & 0xFF) - 0x100 if a & 0x80 else a & 0xFF) & M32,
    0xC1: lambda a: ((a & 0xFFFF) - 0x10000 if a & 0x8000 else a & 0xFFFF) & M32,
    0xC2: lambda a: ((a & 0xFF) - 0x100 if a & 0x80 else a & 0xFF) & M64,
    0xC3: lambda a: ((a & 0xFFFF) - 0x10000 if a & 0x8000 else a & 0xFFFF) & M64,
    0xC4: lambda a: ((a & M32) - 0x100000000 if a & SIGN32 else a & M32) & M64,
}

# Loads: opcode -> (size, signed, result_mask)
_LOADS = {
    0x28: (4, False, M32),
    0x29: (8, False, M64),
    0x2A: ("f32", False, None),
    0x2B: ("f64", False, None),
    0x2C: (1, True, M32),
    0x2D: (1, False, M32),
    0x2E: (2, True, M32),
    0x2F: (2, False, M32),
    0x30: (1, True, M64),
    0x31: (1, False, M64),
    0x32: (2, True, M64),
    0x33: (2, False, M64),
    0x34: (4, True, M64),
    0x35: (4, False, M64),
}

_STORES = {
    0x36: 4,  # i32.store
    0x37: 8,  # i64.store
    0x38: "f32",
    0x39: "f64",
    0x3A: 1,  # i32.store8
    0x3B: 2,
    0x3C: 1,  # i64.store8
    0x3D: 2,
    0x3E: 4,  # i64.store32
}

# Internal pseudo-opcodes for the flat code representation
OP_BR = 0x0C
OP_BR_IF = 0x0D
OP_BR_TABLE = 0x0E
OP_IF_FALSE_JUMP = 0x104  # (target, _) pop cond, jump if zero
OP_JUMP = 0x105  # unconditional, no unwind (compiled 'else' fallthrough)
OP_NOP = 0x101
OP_RETURN = 0x0F
OP_CALL = 0x10
OP_CALL_INDIRECT = 0x11
OP_CONST = 0x41  # all consts normalize to this
OP_LOCAL_GET = 0x20
OP_LOCAL_SET = 0x21
OP_LOCAL_TEE = 0x22
OP_GLOBAL_GET = 0x23
OP_GLOBAL_SET = 0x24
OP_DROP = 0x1A
OP_SELECT = 0x1B
OP_UNREACHABLE = 0x00
OP_MEMSIZE = 0x3F
OP_MEMGROW = 0x40
OP_MEMCOPY = 0x1FC0A
OP_MEMFILL = 0x1FC0B


class Memory:
    """Linear memory; shareable between host and instance (the reference
    similarly creates a host-owned 2000-page memory for the legacy ABI,
    reference: src/witness/witness_calculator.rs:64)."""

    __slots__ = ("data", "max_pages")

    def __init__(self, min_pages: int, max_pages: Optional[int] = None):
        self.data = bytearray(min_pages * PAGE_SIZE)
        self.max_pages = max_pages

    @property
    def pages(self) -> int:
        return len(self.data) // PAGE_SIZE

    def grow(self, delta: int) -> int:
        old = self.pages
        new = old + delta
        if self.max_pages is not None and new > self.max_pages:
            return -1
        if new > 65536:
            return -1
        self.data.extend(bytes(delta * PAGE_SIZE))
        return old

    def read(self, addr: int, n: int) -> bytes:
        if addr + n > len(self.data):
            raise WasmTrap("out of bounds memory access")
        return bytes(self.data[addr : addr + n])

    def write(self, addr: int, payload: bytes) -> None:
        if addr + len(payload) > len(self.data):
            raise WasmTrap("out of bounds memory access")
        self.data[addr : addr + len(payload)] = payload


class HostFunc:
    __slots__ = ("fn", "n_results")

    def __init__(self, fn: Callable, n_results: int = 0):
        self.fn = fn
        self.n_results = n_results


class Instance:
    """An instantiated module: memories, globals, table, compiled functions."""

    def __init__(self, module: Module, imports: Dict[Tuple[str, str], object]):
        self.module = module
        self.imports = imports

        # Resolve imported functions in index order.
        self.imported_funcs: List[HostFunc] = []
        self.memory: Optional[Memory] = None
        for imp in module.imports:
            if imp.kind == 0:
                key = (imp.module, imp.name)
                if key not in imports:
                    raise WasmTrap(f"missing import {imp.module}.{imp.name}")
                host = imports[key]
                if not isinstance(host, HostFunc):
                    ftype = module.types[imp.desc]
                    host = HostFunc(host, len(ftype.results))
                self.imported_funcs.append(host)
            elif imp.kind == 2:
                mem = imports.get((imp.module, imp.name))
                if mem is None:
                    mem = Memory(imp.desc[0], imp.desc[1])
                self.memory = mem

        if self.memory is None and module.memories:
            mn, mx = module.memories[0]
            self.memory = Memory(mn, mx)
        if self.memory is None:
            self.memory = Memory(0)

        # Globals
        self.globals: List = []
        for g in module.globals:
            v = g.init
            if isinstance(v, tuple) and v and v[0] == "global":
                v = self.globals[v[1]]
            self.globals.append(v)

        # Table + elem segments
        self.table: List[Optional[int]] = []
        if module.tables:
            self.table = [None] * module.tables[0][0]
        for seg in module.elems:
            off = seg.offset
            if isinstance(off, tuple):
                off = self.globals[off[1]]
            need = off + len(seg.func_indices)
            if need > len(self.table):
                self.table.extend([None] * (need - len(self.table)))
            for i, fi in enumerate(seg.func_indices):
                self.table[off + i] = fi

        # Data segments
        for seg in module.datas:
            if seg.mem_index == -1:
                continue  # passive
            off = seg.offset
            if isinstance(off, tuple):
                off = self.globals[off[1]]
            self.memory.write(off, seg.data)

        self._compiled: List[Optional[tuple]] = [None] * len(module.codes)

        if module.start is not None:
            self.invoke(module.start, [])

    # -- public API --------------------------------------------------------

    def exported(self, name: str) -> Callable:
        exp = self.module.exports.get(name)
        if exp is None or exp.kind != 0:
            raise WasmTrap(f"function {name} not found")
        idx = exp.index

        def call(*args):
            res = self.invoke(idx, list(args))
            if not res:
                return None
            if len(res) == 1:
                return res[0]
            return tuple(res)

        return call

    def has_export(self, name: str) -> bool:
        return name in self.module.exports

    # -- execution ---------------------------------------------------------

    def invoke(self, func_index: int, args: List) -> List:
        n_imp = self.module.num_imported_funcs
        if func_index < n_imp:
            host = self.imported_funcs[func_index]
            out = host.fn(*args)
            if out is None:
                return []
            if isinstance(out, tuple):
                return list(out)
            return [out]

        local_idx = func_index - n_imp
        compiled = self._compiled[local_idx]
        if compiled is None:
            compiled = self._compile(local_idx)
            self._compiled[local_idx] = compiled
        code, n_locals, n_results = compiled

        locals_ = args + [0] * n_locals
        stack: List = []
        self._run(code, stack, locals_)
        if n_results:
            return stack[-n_results:]
        return []

    def _run(self, code: List[tuple], stack: List, locals_: List) -> None:
        mem = self.memory
        globals_ = self.globals
        binops = _BINOPS
        unops = _UNOPS
        pc = 0
        n = len(code)
        unpack_from = struct.unpack_from
        pack_into = struct.pack_into
        while pc < n:
            op, a, b = code[pc]
            if op == OP_LOCAL_GET:
                stack.append(locals_[a])
            elif op == OP_CONST:
                stack.append(a)
            elif op in binops:
                rhs = stack.pop()
                stack[-1] = binops[op](stack[-1], rhs)
            elif op == OP_LOCAL_SET:
                locals_[a] = stack.pop()
            elif op == OP_LOCAL_TEE:
                locals_[a] = stack[-1]
            elif op in unops:
                stack[-1] = unops[op](stack[-1])
            elif 0x28 <= op <= 0x35:  # loads
                size, signed, mask = _LOADS[op]
                addr = stack[-1] + a
                data = mem.data
                if size == "f32":
                    stack[-1] = unpack_from("<f", data, addr)[0]
                elif size == "f64":
                    stack[-1] = unpack_from("<d", data, addr)[0]
                else:
                    if addr + size > len(data):
                        raise WasmTrap("out of bounds memory access")
                    v = int.from_bytes(data[addr : addr + size], "little")
                    if signed and v & (1 << (size * 8 - 1)):
                        v = (v - (1 << (size * 8))) & mask
                    stack[-1] = v
            elif 0x36 <= op <= 0x3E:  # stores
                val = stack.pop()
                addr = stack.pop() + a
                size = _STORES[op]
                data = mem.data
                if size == "f32":
                    pack_into("<f", data, addr, val)
                elif size == "f64":
                    pack_into("<d", data, addr, val)
                else:
                    if addr + size > len(data):
                        raise WasmTrap("out of bounds memory access")
                    data[addr : addr + size] = (val & ((1 << (size * 8)) - 1)).to_bytes(
                        size, "little"
                    )
            elif op == OP_BR_IF:
                if stack.pop():
                    target, keep, entry = a
                    if keep:
                        stack[entry:] = stack[-keep:]
                    else:
                        del stack[entry:]
                    pc = target
                    continue
            elif op == OP_BR:
                target, keep, entry = a
                if keep:
                    stack[entry:] = stack[-keep:]
                else:
                    del stack[entry:]
                pc = target
                continue
            elif op == OP_IF_FALSE_JUMP:
                if not stack.pop():
                    pc = a
                    continue
            elif op == OP_JUMP:
                pc = a
                continue
            elif op == OP_CALL:
                ftype = b
                n_params = ftype[0]
                if n_params:
                    args = stack[-n_params:]
                    del stack[-n_params:]
                else:
                    args = []
                stack.extend(self.invoke(a, args))
            elif op == OP_CALL_INDIRECT:
                elem_idx = stack.pop()
                if elem_idx >= len(self.table) or self.table[elem_idx] is None:
                    raise WasmTrap("undefined element in call_indirect")
                fidx = self.table[elem_idx]
                n_params = a  # static param count from the call site's type
                if n_params:
                    args = stack[-n_params:]
                    del stack[-n_params:]
                else:
                    args = []
                stack.extend(self.invoke(fidx, args))
            elif op == OP_BR_TABLE:
                idx = stack.pop()
                targets, default = a
                target, keep, entry = targets[idx] if idx < len(targets) else default
                if keep:
                    stack[entry:] = stack[-keep:]
                else:
                    del stack[entry:]
                pc = target
                continue
            elif op == OP_RETURN:
                n_results = a
                if n_results:
                    stack[:] = stack[-n_results:]
                else:
                    stack.clear()
                return
            elif op == OP_GLOBAL_GET:
                stack.append(globals_[a])
            elif op == OP_GLOBAL_SET:
                globals_[a] = stack.pop()
            elif op == OP_DROP:
                stack.pop()
            elif op == OP_SELECT:
                c = stack.pop()
                v2 = stack.pop()
                if not c:
                    stack[-1] = v2
            elif op == OP_MEMSIZE:
                stack.append(mem.pages)
            elif op == OP_MEMGROW:
                stack[-1] = mem.grow(stack[-1]) & M32
            elif op == OP_MEMCOPY:
                ln = stack.pop()
                src = stack.pop()
                dst = stack.pop()
                mem.write(dst, mem.read(src, ln))
            elif op == OP_MEMFILL:
                ln = stack.pop()
                val = stack.pop()
                dst = stack.pop()
                mem.write(dst, bytes([val & 0xFF]) * ln)
            elif op == OP_NOP:
                pass
            elif op == OP_UNREACHABLE:
                raise WasmTrap("unreachable executed")
            else:
                raise WasmTrap(f"unhandled opcode {op:#x} at pc {pc}")
            pc += 1

    # -- compilation -------------------------------------------------------

    def _block_arity(self, blocktype: int) -> Tuple[int, int]:
        if blocktype == -64:  # 0x40 empty
            return (0, 0)
        if blocktype < 0:
            return (0, 1)
        ft = self.module.types[blocktype]
        return (len(ft.params), len(ft.results))

    def _compile(self, local_idx: int):
        from .module import _Reader  # reuse LEB decoding

        module = self.module
        code_meta = module.codes[local_idx]
        func_index = module.num_imported_funcs + local_idx
        ftype = module.func_type(func_index)
        n_results = len(ftype.results)

        r = _Reader(module.raw, code_meta.body_start)
        end_pos = code_meta.body_end

        out: List[tuple] = []
        # control frame: [kind, entry_height, param_arity, result_arity,
        #                 start_pc(loop), patch list, else_patch or None]
        ctrl = [["func", 0, 0, n_results, None, [], None]]
        height = 0

        def branch_info(depth: int):
            fr = ctrl[-1 - depth]
            if fr[0] == "loop":
                return ("loop", fr[4], fr[2], fr[1])
            return ("fwd", fr, fr[3], fr[1])

        while r.pos < end_pos:
            op = r.byte()
            if op == 0x02 or op == 0x03 or op == 0x04:  # block/loop/if
                bt = r.s33()
                pa, ra = self._block_arity(bt)
                if op == 0x04:
                    height -= 1  # condition
                    out.append((OP_IF_FALSE_JUMP, None, None))
                    ctrl.append(["if", height, pa, ra, None, [], len(out) - 1])
                elif op == 0x03:
                    out.append((OP_NOP, None, None))
                    ctrl.append(["loop", height, pa, ra, len(out) - 1, [], None])
                else:
                    ctrl.append(["block", height, pa, ra, None, [], None])
            elif op == 0x05:  # else
                fr = ctrl[-1]
                out.append((OP_JUMP, None, None))
                fr[5].append(len(out) - 1)
                # patch the if-false jump to land after this JUMP
                if_pc = fr[6]
                out[if_pc] = (OP_IF_FALSE_JUMP, len(out), None)
                fr[6] = None
                height = fr[1]
            elif op == 0x0B:  # end
                fr = ctrl.pop()
                target = len(out)
                out.append((OP_NOP, None, None))
                for patch_pc in fr[5]:
                    old = out[patch_pc]
                    if old[0] == OP_JUMP:
                        out[patch_pc] = (OP_JUMP, target, None)
                    elif old[0] == OP_BR:
                        out[patch_pc] = (OP_BR, (target, fr[3], fr[1]), None)
                    elif old[0] == OP_BR_IF:
                        out[patch_pc] = (OP_BR_IF, (target, fr[3], fr[1]), None)
                    elif old[0] == OP_BR_TABLE:
                        targets, default = old[1]
                        targets = [
                            (target, fr[3], fr[1]) if t is None else t for t in targets
                        ]
                        default = (target, fr[3], fr[1]) if default is None else default
                        out[patch_pc] = (OP_BR_TABLE, (targets, default), None)
                if fr[6] is not None:  # if without else
                    out[fr[6]] = (OP_IF_FALSE_JUMP, target, None)
                height = fr[1] + fr[3]
                if not ctrl:
                    break
            elif op == 0x0C or op == 0x0D:  # br / br_if
                depth = r.u32()
                kind, tgt, keep, entry = branch_info(depth)
                opc = OP_BR if op == 0x0C else OP_BR_IF
                if op == 0x0D:
                    height -= 1
                if kind == "loop":
                    out.append((opc, (tgt, keep, entry), None))
                else:
                    tgt[5].append(len(out))
                    out.append((opc, None, None))
                if op == 0x0C:
                    height = ctrl[-1][1]  # unreachable; reset defensively
            elif op == 0x0E:  # br_table
                count = r.u32()
                depths = [r.u32() for _ in range(count)]
                default_depth = r.u32()
                height -= 1
                entries = []
                patch_me = len(out)
                for d in depths + [default_depth]:
                    kind, tgt, keep, entry = branch_info(d)
                    if kind == "loop":
                        entries.append((tgt, keep, entry))
                    else:
                        tgt[5].append(patch_me)
                        entries.append(None)
                out.append((OP_BR_TABLE, (entries[:-1], entries[-1]), None))
                height = ctrl[-1][1]
            elif op == 0x0F:  # return
                out.append((OP_RETURN, n_results, None))
                height = ctrl[-1][1]
            elif op == 0x10:  # call
                fidx = r.u32()
                ft = module.func_type(fidx)
                out.append((OP_CALL, fidx, (len(ft.params), len(ft.results))))
                height += len(ft.results) - len(ft.params)
            elif op == 0x11:  # call_indirect
                type_idx = r.u32()
                r.byte()  # table index 0
                ft = module.types[type_idx]
                # b = result count (unused by the interpreter loop, needed
                # by the AOT C emitter for static stack-depth tracking)
                out.append((OP_CALL_INDIRECT, len(ft.params), len(ft.results)))
                height += len(ft.results) - len(ft.params) - 1
            elif op == 0x00:
                out.append((OP_UNREACHABLE, None, None))
            elif op == 0x01:
                out.append((OP_NOP, None, None))
            elif op == 0x1A:
                out.append((OP_DROP, None, None))
                height -= 1
            elif op == 0x1B:
                out.append((OP_SELECT, None, None))
                height -= 2
            elif op == 0x1C:  # select t
                for _ in range(r.u32()):
                    r.byte()
                out.append((OP_SELECT, None, None))
                height -= 2
            elif op == 0x20:
                out.append((OP_LOCAL_GET, r.u32(), None))
                height += 1
            elif op == 0x21:
                out.append((OP_LOCAL_SET, r.u32(), None))
                height -= 1
            elif op == 0x22:
                out.append((OP_LOCAL_TEE, r.u32(), None))
            elif op == 0x23:
                out.append((OP_GLOBAL_GET, r.u32(), None))
                height += 1
            elif op == 0x24:
                out.append((OP_GLOBAL_SET, r.u32(), None))
                height -= 1
            elif 0x28 <= op <= 0x3E:  # loads & stores
                r.u32()  # align
                offset = r.u32()
                out.append((op, offset, None))
                height += -1 if op >= 0x36 else 0
                if op >= 0x36:
                    height -= 1
            elif op == 0x3F:
                r.byte()
                out.append((OP_MEMSIZE, None, None))
                height += 1
            elif op == 0x40:
                r.byte()
                out.append((OP_MEMGROW, None, None))
            elif op == 0x41:
                out.append((OP_CONST, r.s32() & M32, None))
                height += 1
            elif op == 0x42:
                out.append((OP_CONST, r.s64() & M64, None))
                height += 1
            elif op == 0x43:
                out.append((OP_CONST, r.f32(), None))
                height += 1
            elif op == 0x44:
                out.append((OP_CONST, r.f64(), None))
                height += 1
            elif op in _UNOPS:
                out.append((op, None, None))
            elif op in _BINOPS:
                out.append((op, None, None))
                height -= 1
            elif op == 0xFC:
                sub = r.u32()
                if sub == 10:  # memory.copy
                    r.byte()
                    r.byte()
                    out.append((OP_MEMCOPY, None, None))
                    height -= 3
                elif sub == 11:  # memory.fill
                    r.byte()
                    out.append((OP_MEMFILL, None, None))
                    height -= 3
                elif sub <= 7:  # saturating truncations -> reuse trunc unops
                    base = {0: 0xA8, 1: 0xA9, 2: 0xAA, 3: 0xAB, 4: 0xAE, 5: 0xAF, 6: 0xB0, 7: 0xB1}[sub]
                    out.append((base, None, None))
                else:
                    raise WasmTrap(f"unsupported 0xFC sub-opcode {sub}")
            else:
                raise WasmTrap(f"unsupported opcode {op:#x} during compile")

        n_locals = len(code_meta.locals)
        return (out, n_locals, n_results)


def instantiate(data: bytes, imports: Dict[Tuple[str, str], object]) -> Instance:
    return Instance(decode_module(data), imports)
