"""Core-WASM binary decoder (from scratch — no external WASM runtime exists
in this environment).

Decodes the subset of WebAssembly emitted by the circom compiler: MVP core
plus sign-extension operators. The reference embeds Wasmer for this job
(reference: src/witness/witness_calculator.rs:54, Cargo.toml:16-17); here the
runtime is first-party. Python decoder/interpreter now; a C++ engine is the
planned fast path for large witness generation.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WASM_MAGIC = b"\x00asm"
WASM_VERSION = 1

# Section ids
SEC_CUSTOM, SEC_TYPE, SEC_IMPORT, SEC_FUNCTION, SEC_TABLE, SEC_MEMORY = range(6)
SEC_GLOBAL, SEC_EXPORT, SEC_START, SEC_ELEM, SEC_CODE, SEC_DATA, SEC_DATACOUNT = range(6, 13)

# Value types
I32, I64, F32, F64 = 0x7F, 0x7E, 0x7D, 0x7C

PAGE_SIZE = 65536


class WasmDecodeError(ValueError):
    pass


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def bytes(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise WasmDecodeError("unexpected EOF")
        self.pos += n
        return out

    def u32(self) -> int:
        result, shift = 0, 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            if not (b & 0x80):
                return result
            shift += 7

    def s32(self) -> int:
        return self._sleb(32)

    def s64(self) -> int:
        return self._sleb(64)

    def s33(self) -> int:
        return self._sleb(33)

    def _sleb(self, bits: int) -> int:
        result, shift = 0, 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            shift += 7
            if not (b & 0x80):
                if shift < bits and (b & 0x40):
                    result |= -(1 << shift)
                return result

    def f32(self) -> float:
        return struct.unpack("<f", self.bytes(4))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.bytes(8))[0]

    def name(self) -> str:
        n = self.u32()
        return self.bytes(n).decode("utf-8")

    def eof(self) -> bool:
        return self.pos >= len(self.buf)


@dataclass
class FuncType:
    params: Tuple[int, ...]
    results: Tuple[int, ...]


@dataclass
class Import:
    module: str
    name: str
    kind: int  # 0 func, 1 table, 2 memory, 3 global
    desc: object


@dataclass
class Export:
    name: str
    kind: int
    index: int


@dataclass
class Global:
    valtype: int
    mutable: bool
    init: object  # constant value from the init expression


@dataclass
class Code:
    locals: List[int]  # flattened local valtypes (excludes params)
    body_start: int  # offset into module bytes
    body_end: int


@dataclass
class DataSegment:
    mem_index: int
    offset: object  # int or ('global', idx)
    data: bytes


@dataclass
class ElemSegment:
    table_index: int
    offset: object
    func_indices: List[int]


@dataclass
class Module:
    raw: bytes
    types: List[FuncType] = field(default_factory=list)
    imports: List[Import] = field(default_factory=list)
    func_type_indices: List[int] = field(default_factory=list)  # for local funcs
    tables: List[Tuple[int, Optional[int]]] = field(default_factory=list)
    memories: List[Tuple[int, Optional[int]]] = field(default_factory=list)
    globals: List[Global] = field(default_factory=list)
    exports: Dict[str, Export] = field(default_factory=dict)
    start: Optional[int] = None
    elems: List[ElemSegment] = field(default_factory=list)
    codes: List[Code] = field(default_factory=list)
    datas: List[DataSegment] = field(default_factory=list)

    @property
    def num_imported_funcs(self) -> int:
        return sum(1 for i in self.imports if i.kind == 0)

    def func_type(self, func_index: int) -> FuncType:
        n_imp = self.num_imported_funcs
        if func_index < n_imp:
            k = -1
            for imp in self.imports:
                if imp.kind == 0:
                    k += 1
                    if k == func_index:
                        return self.types[imp.desc]
            raise IndexError(func_index)
        return self.types[self.func_type_indices[func_index - n_imp]]


def _const_expr(r: _Reader):
    """Evaluate a constant init expression (const or global.get)."""
    op = r.byte()
    if op == 0x41:  # i32.const
        v = r.s32()
    elif op == 0x42:  # i64.const
        v = r.s64()
    elif op == 0x43:
        v = r.f32()
    elif op == 0x44:
        v = r.f64()
    elif op == 0x23:  # global.get
        v = ("global", r.u32())
    else:
        raise WasmDecodeError(f"unsupported const expr opcode {op:#x}")
    if r.byte() != 0x0B:  # end
        raise WasmDecodeError("const expr not terminated")
    return v


def decode_module(data: bytes) -> Module:
    r = _Reader(data)
    if r.bytes(4) != WASM_MAGIC:
        raise WasmDecodeError("bad wasm magic")
    if struct.unpack("<I", r.bytes(4))[0] != WASM_VERSION:
        raise WasmDecodeError("unsupported wasm version")

    mod = Module(raw=data)
    while not r.eof():
        sec_id = r.byte()
        size = r.u32()
        end = r.pos + size
        if sec_id == SEC_TYPE:
            for _ in range(r.u32()):
                if r.byte() != 0x60:
                    raise WasmDecodeError("expected func type")
                params = tuple(r.byte() for _ in range(r.u32()))
                results = tuple(r.byte() for _ in range(r.u32()))
                mod.types.append(FuncType(params, results))
        elif sec_id == SEC_IMPORT:
            for _ in range(r.u32()):
                module_name, name = r.name(), r.name()
                kind = r.byte()
                if kind == 0:
                    desc = r.u32()  # type index
                elif kind == 1:
                    r.byte()  # elemtype (funcref)
                    desc = _limits(r)
                elif kind == 2:
                    desc = _limits(r)
                elif kind == 3:
                    vt = r.byte()
                    mut = r.byte()
                    desc = (vt, bool(mut))
                else:
                    raise WasmDecodeError(f"bad import kind {kind}")
                mod.imports.append(Import(module_name, name, kind, desc))
        elif sec_id == SEC_FUNCTION:
            mod.func_type_indices = [r.u32() for _ in range(r.u32())]
        elif sec_id == SEC_TABLE:
            for _ in range(r.u32()):
                r.byte()  # elemtype
                mod.tables.append(_limits(r))
        elif sec_id == SEC_MEMORY:
            for _ in range(r.u32()):
                mod.memories.append(_limits(r))
        elif sec_id == SEC_GLOBAL:
            for _ in range(r.u32()):
                vt = r.byte()
                mut = bool(r.byte())
                init = _const_expr(r)
                mod.globals.append(Global(vt, mut, init))
        elif sec_id == SEC_EXPORT:
            for _ in range(r.u32()):
                name = r.name()
                kind = r.byte()
                idx = r.u32()
                mod.exports[name] = Export(name, kind, idx)
        elif sec_id == SEC_START:
            mod.start = r.u32()
        elif sec_id == SEC_ELEM:
            for _ in range(r.u32()):
                flags = r.u32()
                if flags != 0:
                    raise WasmDecodeError(f"unsupported elem segment flags {flags}")
                offset = _const_expr(r)
                funcs = [r.u32() for _ in range(r.u32())]
                mod.elems.append(ElemSegment(0, offset, funcs))
        elif sec_id == SEC_CODE:
            for _ in range(r.u32()):
                body_size = r.u32()
                body_end = r.pos + body_size
                locals_flat: List[int] = []
                for _ in range(r.u32()):
                    count = r.u32()
                    vt = r.byte()
                    locals_flat.extend([vt] * count)
                mod.codes.append(Code(locals_flat, r.pos, body_end))
                r.pos = body_end
        elif sec_id == SEC_DATA:
            for _ in range(r.u32()):
                flags = r.u32()
                if flags == 0:
                    offset = _const_expr(r)
                    n = r.u32()
                    mod.datas.append(DataSegment(0, offset, r.bytes(n)))
                elif flags == 1:  # passive
                    n = r.u32()
                    mod.datas.append(DataSegment(-1, 0, r.bytes(n)))
                elif flags == 2:
                    mem_idx = r.u32()
                    offset = _const_expr(r)
                    n = r.u32()
                    mod.datas.append(DataSegment(mem_idx, offset, r.bytes(n)))
                else:
                    raise WasmDecodeError(f"bad data segment flags {flags}")
        else:  # custom / datacount / unknown: skip
            r.pos = end
        if r.pos != end:
            r.pos = end
    return mod


def _limits(r: _Reader) -> Tuple[int, Optional[int]]:
    flags = r.byte()
    mn = r.u32()
    mx = r.u32() if flags & 1 else None
    return (mn, mx)
