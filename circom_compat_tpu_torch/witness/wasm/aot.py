"""AOT WASM -> C -> native compiler for circom witness generators,
engine="aot" (the WitnessCalculator's default).

The bytecode interpreters (pure-Python interp.py, the C++ VM of native.py)
pay per-instruction dispatch; witness generation is a long single-threaded
dataflow program, so at 2^20-constraint scale the interpreter becomes the
end-to-end bottleneck. This module translates each function's flat
bytecode (produced by interp.Instance._compile) into C:

  - the operand stack is compiled away: WASM validation guarantees a
    static stack depth at every pc, so stack slots become named C locals
    (s0, s1, ...) resolved by a dataflow pass over the flat code;
  - structured control flow is already flattened to jumps -> C labels/goto;
  - i32/i64 ops map to C integer ops (i32 values keep the interpreter's
    invariant of zero-extended uint64 storage); float ops trap, exactly
    like the C++ VM (circom-generated code only references them on
    unreachable paths);
  - host imports (runtime.*) call back into Python through the same
    callback ABI as native.py; an exception raised there is stored and
    re-raised after the native code unwinds.

The generated .so is cached in utils/paths.cache_dir()/aot_torch, keyed by
sha256(module bytes + _CODEGEN_VERSION), so a given circuit compiles once
per machine. The directory and the tag are the port's own: the JAX
package's builds (.cache/aot, its own tag) are never loaded. Each build
compiles under a process-private name and is renamed into place
(_host_build.compile_shared), so test workers that build one module at
once never load a partial file. Replaces the role of Wasmer's Cranelift
JIT in the reference (reference: Cargo.toml:16,
src/witness/witness_calculator.rs:54 `Module::from_file`).

AotInstance instantiates the module in Python first (data and element
segments, globals, a start function) and copies that memory image into the
native context: a module whose memory minimum is 513 pages, as the 2^20
chain's (utils/chain_wasm.py), allocates and copies 32 MiB once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import threading
import time
from typing import Dict, List, Optional, Tuple

from ... import _host_build
from ...utils import paths
from .interp import (
    Instance,
    WasmTrap,
    OP_BR,
    OP_BR_IF,
    OP_BR_TABLE,
    OP_CALL,
    OP_CALL_INDIRECT,
    OP_CONST,
    OP_DROP,
    OP_GLOBAL_GET,
    OP_GLOBAL_SET,
    OP_IF_FALSE_JUMP,
    OP_JUMP,
    OP_LOCAL_GET,
    OP_LOCAL_SET,
    OP_LOCAL_TEE,
    OP_MEMCOPY,
    OP_MEMFILL,
    OP_MEMGROW,
    OP_MEMSIZE,
    OP_NOP,
    OP_RETURN,
    OP_SELECT,
    OP_UNREACHABLE,
    _BINOPS,
    _LOADS,
    _STORES,
    _UNOPS,
)
from .module import Module

_HOSTFN = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int32,
    ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int32,
)

_PRELUDE = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <setjmp.h>

typedef int (*host_fn)(int64_t*, int32_t, int64_t*, int32_t);

typedef struct Ctx {
  uint8_t* mem;
  uint64_t mem_size;
  uint64_t max_pages;
  uint64_t* globals;
  int32_t* table;
  uint32_t table_len;
  host_fn imports[256];
  jmp_buf trapbuf;
  const char* trap_msg;
} Ctx;

typedef uint64_t (*anyfn)(Ctx*, uint64_t*);

static void trap(Ctx* c, const char* m) {
  c->trap_msg = m;
  longjmp(c->trapbuf, 1);
}

static uint64_t aot_grow_impl(Ctx* c, uint64_t delta) {
  uint64_t old = c->mem_size >> 16;
  uint64_t want = old + delta;
  if (want > c->max_pages || want > 65536) return 0xFFFFFFFFull;
  uint8_t* nm = (uint8_t*)realloc(c->mem, want << 16);
  if (!nm) return 0xFFFFFFFFull;
  memset(nm + c->mem_size, 0, (want << 16) - c->mem_size);
  c->mem = nm;
  c->mem_size = want << 16;
  return old;
}

static inline uint64_t i32_div_s(Ctx* c, uint64_t a, uint64_t b) {
  int32_t sa = (int32_t)(uint32_t)a, sb = (int32_t)(uint32_t)b;
  if (sb == 0) trap(c, "integer divide by zero");
  if (sa == INT32_MIN && sb == -1) trap(c, "integer overflow");
  return (uint64_t)(uint32_t)(sa / sb);
}
static inline uint64_t i32_div_u(Ctx* c, uint64_t a, uint64_t b) {
  if ((uint32_t)b == 0) trap(c, "integer divide by zero");
  return (uint32_t)a / (uint32_t)b;
}
static inline uint64_t i32_rem_s(Ctx* c, uint64_t a, uint64_t b) {
  int32_t sa = (int32_t)(uint32_t)a, sb = (int32_t)(uint32_t)b;
  if (sb == 0) trap(c, "integer divide by zero");
  if (sa == INT32_MIN && sb == -1) return 0;
  return (uint64_t)(uint32_t)(sa % sb);
}
static inline uint64_t i32_rem_u(Ctx* c, uint64_t a, uint64_t b) {
  if ((uint32_t)b == 0) trap(c, "integer divide by zero");
  return (uint32_t)a % (uint32_t)b;
}
static inline uint64_t i64_div_s(Ctx* c, uint64_t a, uint64_t b) {
  int64_t sa = (int64_t)a, sb = (int64_t)b;
  if (sb == 0) trap(c, "integer divide by zero");
  if (sa == INT64_MIN && sb == -1) trap(c, "integer overflow");
  return (uint64_t)(sa / sb);
}
static inline uint64_t i64_div_u(Ctx* c, uint64_t a, uint64_t b) {
  if (b == 0) trap(c, "integer divide by zero");
  return a / b;
}
static inline uint64_t i64_rem_s(Ctx* c, uint64_t a, uint64_t b) {
  int64_t sa = (int64_t)a, sb = (int64_t)b;
  if (sb == 0) trap(c, "integer divide by zero");
  if (sa == INT64_MIN && sb == -1) return 0;
  return (uint64_t)(sa % sb);
}
static inline uint64_t i64_rem_u(Ctx* c, uint64_t a, uint64_t b) {
  if (b == 0) trap(c, "integer divide by zero");
  return a % b;
}
static inline uint64_t rotl32(uint64_t x, uint32_t n) {
  uint32_t v = (uint32_t)x; n &= 31;
  return (uint32_t)((v << n) | (v >> ((32 - n) & 31)));
}
static inline uint64_t rotr32(uint64_t x, uint32_t n) {
  uint32_t v = (uint32_t)x; n &= 31;
  return (uint32_t)((v >> n) | (v << ((32 - n) & 31)));
}
static inline uint64_t rotl64(uint64_t x, uint32_t n) {
  n &= 63;
  return (x << n) | (x >> ((64 - n) & 63));
}
static inline uint64_t rotr64(uint64_t x, uint32_t n) {
  n &= 63;
  return (x >> n) | (x << ((64 - n) & 63));
}
"""

_EPILOGUE = r"""
Ctx* aot_create(void) {
  Ctx* c = (Ctx*)calloc(1, sizeof(Ctx));
  return c;
}
void aot_destroy(Ctx* c) {
  if (!c) return;
  free(c->mem);
  free(c->globals);
  free(c->table);
  free(c);
}
void aot_set_memory(Ctx* c, uint32_t pages, uint32_t max_pages) {
  free(c->mem);
  c->mem = (uint8_t*)calloc(1, (uint64_t)pages << 16);
  c->mem_size = (uint64_t)pages << 16;
  c->max_pages = max_pages;
}
void aot_write_memory(Ctx* c, uint64_t addr, const char* src, uint64_t n) {
  if (addr + n <= c->mem_size) memcpy(c->mem + addr, src, n);
}
void aot_read_memory(Ctx* c, uint64_t addr, void* dst, uint64_t n) {
  if (addr + n <= c->mem_size) memcpy(dst, c->mem + addr, n);
}
uint64_t aot_memory_size(Ctx* c) { return c->mem_size; }
void aot_set_globals(Ctx* c, uint64_t* vals, uint32_t n) {
  free(c->globals);
  c->globals = (uint64_t*)malloc((n ? n : 1) * sizeof(uint64_t));
  memcpy(c->globals, vals, n * sizeof(uint64_t));
}
uint64_t aot_get_global(Ctx* c, uint32_t i) { return c->globals[i]; }
void aot_set_table(Ctx* c, int32_t* vals, uint32_t n) {
  free(c->table);
  c->table = (int32_t*)malloc((n ? n : 1) * sizeof(int32_t));
  memcpy(c->table, vals, n * sizeof(int32_t));
  c->table_len = n;
}
void aot_set_import(Ctx* c, uint32_t i, host_fn fn) {
  if (i < 256) c->imports[i] = fn;
}
const char* aot_last_error(Ctx* c) { return c->trap_msg ? c->trap_msg : ""; }

int aot_call(Ctx* c, uint32_t fidx, uint64_t* args, uint32_t n_args,
             uint64_t* results, uint32_t* n_results) {
  (void)n_args;
  if (fidx >= N_FUNCS) { c->trap_msg = "bad function index"; return 1; }
  c->trap_msg = 0;
  if (setjmp(c->trapbuf)) return 1;
  uint64_t r = FUNCS[fidx](c, args);
  *n_results = NRES[fidx];
  if (NRES[fidx]) results[0] = r;
  return 0;
}

/* out[i] = f(i) for i in [0, n): batches per-wire readback loops that are
 * otherwise one ctypes round-trip each (e.g. getPWitness). */
int aot_call_range(Ctx* c, uint32_t fidx, uint64_t n, uint64_t* out) {
  if (fidx >= N_FUNCS) { c->trap_msg = "bad function index"; return 1; }
  c->trap_msg = 0;
  if (setjmp(c->trapbuf)) return 1;
  for (uint64_t i = 0; i < n; i++) {
    uint64_t a[1] = { i };
    out[i] = FUNCS[fidx](c, a);
  }
  return 0;
}

/* The circom-2 witness readback protocol in one native loop:
 * for i: getWitness(i); for j < n32: out[i*n32+j] = readSharedRWMemory(j).
 * (reference: src/witness/witness_calculator.rs:138-149 does the same two
 * calls per limb across the Wasmer boundary). */
int aot_read_witness(Ctx* c, uint32_t f_get, uint32_t f_read, uint64_t n,
                     uint32_t n32, uint64_t* out) {
  if (f_get >= N_FUNCS || f_read >= N_FUNCS) {
    c->trap_msg = "bad function index";
    return 1;
  }
  c->trap_msg = 0;
  if (setjmp(c->trapbuf)) return 1;
  for (uint64_t i = 0; i < n; i++) {
    uint64_t a[1] = { i };
    FUNCS[f_get](c, a);
    for (uint32_t j = 0; j < n32; j++) {
      uint64_t b[1] = { j };
      out[i * n32 + j] = FUNCS[f_read](c, b);
    }
  }
  return 0;
}
"""


# ---------------------------------------------------------------------------
# C expression tables
# ---------------------------------------------------------------------------

_BIN_EXPR: Dict[int, str] = {
    # i32 compare
    0x46: "((uint32_t){x} == (uint32_t){y})",
    0x47: "((uint32_t){x} != (uint32_t){y})",
    0x48: "((int32_t)(uint32_t){x} < (int32_t)(uint32_t){y})",
    0x49: "((uint32_t){x} < (uint32_t){y})",
    0x4A: "((int32_t)(uint32_t){x} > (int32_t)(uint32_t){y})",
    0x4B: "((uint32_t){x} > (uint32_t){y})",
    0x4C: "((int32_t)(uint32_t){x} <= (int32_t)(uint32_t){y})",
    0x4D: "((uint32_t){x} <= (uint32_t){y})",
    0x4E: "((int32_t)(uint32_t){x} >= (int32_t)(uint32_t){y})",
    0x4F: "((uint32_t){x} >= (uint32_t){y})",
    # i64 compare
    0x51: "({x} == {y})",
    0x52: "({x} != {y})",
    0x53: "((int64_t){x} < (int64_t){y})",
    0x54: "({x} < {y})",
    0x55: "((int64_t){x} > (int64_t){y})",
    0x56: "({x} > {y})",
    0x57: "((int64_t){x} <= (int64_t){y})",
    0x58: "({x} <= {y})",
    0x59: "((int64_t){x} >= (int64_t){y})",
    0x5A: "({x} >= {y})",
    # i32 arithmetic
    0x6A: "(uint64_t)(uint32_t)((uint32_t){x} + (uint32_t){y})",
    0x6B: "(uint64_t)(uint32_t)((uint32_t){x} - (uint32_t){y})",
    0x6C: "(uint64_t)(uint32_t)((uint32_t){x} * (uint32_t){y})",
    0x6D: "i32_div_s(c, {x}, {y})",
    0x6E: "i32_div_u(c, {x}, {y})",
    0x6F: "i32_rem_s(c, {x}, {y})",
    0x70: "i32_rem_u(c, {x}, {y})",
    0x71: "({x} & {y})",
    0x72: "({x} | {y})",
    0x73: "({x} ^ {y})",
    0x74: "(uint64_t)(uint32_t)((uint32_t){x} << ((uint32_t){y} & 31))",
    0x75: "(uint64_t)(uint32_t)((int32_t)(uint32_t){x} >> ((uint32_t){y} & 31))",
    0x76: "(uint64_t)((uint32_t){x} >> ((uint32_t){y} & 31))",
    0x77: "rotl32({x}, (uint32_t){y})",
    0x78: "rotr32({x}, (uint32_t){y})",
    # i64 arithmetic
    0x7C: "({x} + {y})",
    0x7D: "({x} - {y})",
    0x7E: "({x} * {y})",
    0x7F: "i64_div_s(c, {x}, {y})",
    0x80: "i64_div_u(c, {x}, {y})",
    0x81: "i64_rem_s(c, {x}, {y})",
    0x82: "i64_rem_u(c, {x}, {y})",
    0x83: "({x} & {y})",
    0x84: "({x} | {y})",
    0x85: "({x} ^ {y})",
    0x86: "({x} << ({y} & 63))",
    0x87: "(uint64_t)((int64_t){x} >> ({y} & 63))",
    0x88: "({x} >> ({y} & 63))",
    0x89: "rotl64({x}, (uint32_t){y})",
    0x8A: "rotr64({x}, (uint32_t){y})",
}

_UN_EXPR: Dict[int, str] = {
    0x45: "((uint32_t){x} == 0)",
    0x50: "({x} == 0)",
    0x67: "((uint32_t){x} ? (uint64_t)__builtin_clz((uint32_t){x}) : 32)",
    0x68: "((uint32_t){x} ? (uint64_t)__builtin_ctz((uint32_t){x}) : 32)",
    0x69: "(uint64_t)__builtin_popcountll({x} & 0xFFFFFFFFull)",
    0x79: "({x} ? (uint64_t)__builtin_clzll({x}) : 64)",
    0x7A: "({x} ? (uint64_t)__builtin_ctzll({x}) : 64)",
    0x7B: "(uint64_t)__builtin_popcountll({x})",
    0xA7: "({x} & 0xFFFFFFFFull)",  # i32.wrap_i64
    0xAC: "(uint64_t)(int64_t)(int32_t)(uint32_t){x}",  # i64.extend_i32_s
    0xAD: "({x} & 0xFFFFFFFFull)",  # i64.extend_i32_u
    # sign extension
    0xC0: "(uint64_t)(uint32_t)(int32_t)(int8_t)(uint8_t){x}",
    0xC1: "(uint64_t)(uint32_t)(int32_t)(int16_t)(uint16_t){x}",
    0xC2: "(uint64_t)(int64_t)(int8_t)(uint8_t){x}",
    0xC3: "(uint64_t)(int64_t)(int16_t)(uint16_t){x}",
    0xC4: "(uint64_t)(int64_t)(int32_t)(uint32_t){x}",
}

# Loads: opcode -> (size, c_read_type, c_result_cast)
_LOAD_EXPR: Dict[int, Tuple[int, str, str]] = {
    0x28: (4, "uint32_t", "(uint64_t)"),
    0x29: (8, "uint64_t", "(uint64_t)"),
    0x2C: (1, "int8_t", "(uint64_t)(uint32_t)(int32_t)"),
    0x2D: (1, "uint8_t", "(uint64_t)"),
    0x2E: (2, "int16_t", "(uint64_t)(uint32_t)(int32_t)"),
    0x2F: (2, "uint16_t", "(uint64_t)"),
    0x30: (1, "int8_t", "(uint64_t)(int64_t)"),
    0x31: (1, "uint8_t", "(uint64_t)"),
    0x32: (2, "int16_t", "(uint64_t)(int64_t)"),
    0x33: (2, "uint16_t", "(uint64_t)"),
    0x34: (4, "int32_t", "(uint64_t)(int64_t)"),
    0x35: (4, "uint32_t", "(uint64_t)"),
}

_STORE_EXPR: Dict[int, Tuple[int, str]] = {
    0x36: (4, "uint32_t"),
    0x37: (8, "uint64_t"),
    0x3A: (1, "uint8_t"),
    0x3B: (2, "uint16_t"),
    0x3C: (1, "uint8_t"),
    0x3D: (2, "uint16_t"),
    0x3E: (4, "uint32_t"),
}


def _dataflow(code: List[tuple], n_results: int):
    """Depth-in per pc (None = unreachable) + branch-target label set."""
    n = len(code)
    depths: List[Optional[int]] = [None] * n
    labels = set()
    work = [(0, 0)]
    while work:
        pc, d = work.pop()
        if pc >= n:
            continue
        if depths[pc] is not None:
            if depths[pc] != d:
                raise WasmTrap(
                    f"stack depth mismatch at pc {pc}: {depths[pc]} vs {d}"
                )
            continue
        depths[pc] = d
        op, a, b = code[pc]
        succ: List[Tuple[int, int]] = []
        fall: Optional[int] = None
        if op == OP_BR:
            t, keep, entry = a
            succ.append((t, entry + keep))
        elif op == OP_BR_IF:
            t, keep, entry = a
            succ.append((t, entry + keep))
            fall = d - 1
        elif op == OP_IF_FALSE_JUMP:
            succ.append((a, d - 1))
            fall = d - 1
        elif op == OP_JUMP:
            succ.append((a, d))
        elif op == OP_BR_TABLE:
            targets, default = a
            for t, keep, entry in list(targets) + [default]:
                succ.append((t, entry + keep))
        elif op in (OP_RETURN, OP_UNREACHABLE):
            pass
        elif op == OP_CALL:
            np_, nr = b
            fall = d - np_ + nr
        elif op == OP_CALL_INDIRECT:
            fall = d - 1 - a + (b or 0)
        elif op in (OP_CONST, OP_LOCAL_GET, OP_GLOBAL_GET, OP_MEMSIZE):
            fall = d + 1
        elif op in (OP_LOCAL_SET, OP_GLOBAL_SET, OP_DROP):
            fall = d - 1
        elif op in (OP_LOCAL_TEE, OP_MEMGROW, OP_NOP):
            fall = d
        elif op in _UNOPS:
            fall = d
        elif op in _BINOPS:
            fall = d - 1
        elif op in _LOADS:
            fall = d
        elif op in _STORES:
            fall = d - 2
        elif op == OP_SELECT:
            fall = d - 2
        elif op in (OP_MEMCOPY, OP_MEMFILL):
            fall = d - 3
        else:
            raise WasmTrap(f"AOT: unhandled opcode {op:#x}")
        for t, td in succ:
            labels.add(t)
            work.append((t, td))
        if fall is not None:
            work.append((pc + 1, fall))
    return depths, labels


def _unwind(dst_entry: int, keep: int, src_top: int) -> List[str]:
    """Copy the top `keep` slots down to dst_entry (branch unwind)."""
    out = []
    for i in range(keep):
        src = src_top - keep + i
        if src != dst_entry + i:
            out.append(f"s{dst_entry + i} = s{src};")
    return out


def emit_function(module: Module, fidx: int, code: List[tuple],
                  n_locals: int) -> str:
    ftype = module.func_type(fidx)
    n_params = len(ftype.params)
    n_results = len(ftype.results)
    if n_results > 1:
        raise WasmTrap("AOT: multi-value functions unsupported")
    n_imp = module.num_imported_funcs

    depths, labels = _dataflow(code, n_results)
    max_depth = max((d for d in depths if d is not None), default=0) + 4

    lines: List[str] = []
    lines.append(f"static uint64_t f{fidx}(Ctx* c, uint64_t* p) {{")
    for i in range(n_params + n_locals):
        init = f"p[{i}]" if i < n_params else "0"
        lines.append(f"  uint64_t l{i} = {init};")
    for i in range(max_depth):
        lines.append(f"  uint64_t s{i} = 0;")
    lines.append("  (void)p; (void)c;")

    def L(s):
        lines.append("  " + s)

    for pc, (op, a, b) in enumerate(code):
        if pc in labels and depths[pc] is not None:
            lines.append(f"L{pc}: ;")
        d = depths[pc]
        if d is None:
            continue  # unreachable
        if op == OP_LOCAL_GET:
            L(f"s{d} = l{a};")
        elif op == OP_CONST:
            if isinstance(a, float):
                L('trap(c, "float constant");')
            else:
                L(f"s{d} = {int(a) & ((1 << 64) - 1)}ull;")
        elif op in _BIN_EXPR:
            L(f"s{d-2} = " + _BIN_EXPR[op].format(x=f"s{d-2}", y=f"s{d-1}") + ";")
        elif op in _BINOPS:  # float binop
            L('trap(c, "float op");')
        elif op == OP_LOCAL_SET:
            L(f"l{a} = s{d-1};")
        elif op == OP_LOCAL_TEE:
            L(f"l{a} = s{d-1};")
        elif op in _UN_EXPR:
            L(f"s{d-1} = " + _UN_EXPR[op].format(x=f"s{d-1}") + ";")
        elif op in _UNOPS:  # float unop / float conversion
            L('trap(c, "float op");')
        elif op in _LOAD_EXPR:
            size, rtype, rcast = _LOAD_EXPR[op]
            L(f"{{ uint64_t _a = (uint32_t)s{d-1} + {a}ull;"
              f" if (_a + {size} > c->mem_size) trap(c, \"oob load\");"
              f" {rtype} _v; memcpy(&_v, c->mem + _a, {size});"
              f" s{d-1} = {rcast}_v; }}")
        elif op in (0x2A, 0x2B):  # float loads
            L('trap(c, "float load");')
        elif op in _STORE_EXPR:
            size, wtype = _STORE_EXPR[op]
            L(f"{{ uint64_t _a = (uint32_t)s{d-2} + {a}ull;"
              f" if (_a + {size} > c->mem_size) trap(c, \"oob store\");"
              f" {wtype} _w = ({wtype})s{d-1};"
              f" memcpy(c->mem + _a, &_w, {size}); }}")
        elif op in (0x38, 0x39):  # float stores
            L('trap(c, "float store");')
        elif op == OP_BR:
            t, keep, entry = a
            for s in _unwind(entry, keep, d):
                L(s)
            L(f"goto L{t};")
        elif op == OP_BR_IF:
            t, keep, entry = a
            body = " ".join(_unwind(entry, keep, d - 1) + [f"goto L{t};"])
            L(f"if (s{d-1}) {{ {body} }}")
        elif op == OP_IF_FALSE_JUMP:
            L(f"if (!s{d-1}) goto L{a};")
        elif op == OP_JUMP:
            L(f"goto L{a};")
        elif op == OP_BR_TABLE:
            targets, default = a
            nT = len(targets)
            L(f"switch ((uint32_t)s{d-1} < {nT}u ? (uint32_t)s{d-1} : {nT}u) {{")
            for i, (t, keep, entry) in enumerate(list(targets) + [default]):
                body = " ".join(_unwind(entry, keep, d - 1) + [f"goto L{t};"])
                L(f"  case {i}: {{ {body} }}")
            L("}")
        elif op == OP_RETURN:
            L(f"return {f's{d-1}' if a else '0'};")
        elif op == OP_CALL:
            np_, nr = b
            args = ", ".join(f"s{d - np_ + i}" for i in range(np_))
            if a < n_imp:
                arr = ", ".join(f"s{d - np_ + i}" for i in range(np_)) or "0"
                L(f"{{ uint64_t _a[{max(np_, 1)}] = {{ {arr} }};"
                  f" uint64_t _r = wi{a}(c, _a); (void)_r;"
                  + (f" s{d - np_} = _r;" if nr else "") + " }")
            else:
                call = f"f{a}(c, (uint64_t[]){{ {args or '0'} }})"
                if nr:
                    L(f"s{d - np_} = {call};")
                else:
                    L(f"(void){call};")
        elif op == OP_CALL_INDIRECT:
            np_ = a
            nr = b or 0
            arr = ", ".join(f"s{d - 1 - np_ + i}" for i in range(np_)) or "0"
            L(f"{{ uint32_t _e = (uint32_t)s{d-1};"
              f" if (_e >= c->table_len || c->table[_e] < 0)"
              f" trap(c, \"undefined element in call_indirect\");"
              f" uint64_t _a[{max(np_, 1)}] = {{ {arr} }};"
              f" uint64_t _r = FUNCS[c->table[_e]](c, _a); (void)_r;"
              + (f" s{d - 1 - np_} = _r;" if nr else "") + " }")
        elif op == OP_SELECT:
            L(f"s{d-3} = s{d-1} ? s{d-3} : s{d-2};")
        elif op == OP_DROP:
            pass
        elif op == OP_GLOBAL_GET:
            L(f"s{d} = c->globals[{a}];")
        elif op == OP_GLOBAL_SET:
            L(f"c->globals[{a}] = s{d-1};")
        elif op == OP_MEMSIZE:
            L(f"s{d} = c->mem_size >> 16;")
        elif op == OP_MEMGROW:
            L(f"s{d-1} = aot_grow_impl(c, s{d-1});")
        elif op == OP_MEMCOPY:
            L(f"{{ uint64_t _n = s{d-1}, _s = s{d-2}, _d = s{d-3};"
              f" if (_s + _n > c->mem_size || _d + _n > c->mem_size)"
              f" trap(c, \"oob copy\");"
              f" memmove(c->mem + _d, c->mem + _s, _n); }}")
        elif op == OP_MEMFILL:
            L(f"{{ uint64_t _n = s{d-1}; uint64_t _v = s{d-2};"
              f" uint64_t _d = s{d-3};"
              f" if (_d + _n > c->mem_size) trap(c, \"oob fill\");"
              f" memset(c->mem + _d, (int)(_v & 0xFF), _n); }}")
        elif op == OP_NOP:
            pass
        elif op == OP_UNREACHABLE:
            L('trap(c, "unreachable executed");')
        else:
            raise WasmTrap(f"AOT emit: unhandled opcode {op:#x} at pc {pc}")

    # fallthrough off the end of the flat code = function return
    end_d = None
    # depth after the trailing NOP (the func block's end marker), if reachable
    if depths and depths[-1] is not None:
        op_last = code[-1][0]
        if op_last == OP_NOP:
            end_d = depths[-1]
    if n_results and end_d:
        lines.append(f"  return s{end_d - 1};")
    else:
        lines.append("  return 0;")
    lines.append("}")
    return "\n".join(lines)


def generate_c(module: Module, pyinst: Instance) -> str:
    n_imp = module.num_imported_funcs
    n_total = n_imp + len(module.codes)
    parts = [_PRELUDE]

    # forward declarations
    for li in range(len(module.codes)):
        parts.append(f"static uint64_t f{n_imp + li}(Ctx*, uint64_t*);")
    parts.append("static const anyfn FUNCS[];")

    # import wrappers
    imp_metas = [i for i in module.imports if i.kind == 0]
    for idx, imp in enumerate(imp_metas):
        ftype = module.types[imp.desc]
        np_, nr = len(ftype.params), len(ftype.results)
        if nr > 1:
            raise WasmTrap("AOT: multi-value import unsupported")
        parts.append(
            f"static uint64_t wi{idx}(Ctx* c, uint64_t* a) {{\n"
            f"  int64_t _res[1] = {{0}};\n"
            f"  int rc = c->imports[{idx}]((int64_t*)a, {np_}, _res, {nr});\n"
            f"  if (rc) trap(c, \"host error\");\n"
            f"  return (uint64_t)_res[0];\n"
            f"}}"
        )

    # function bodies
    for li in range(len(module.codes)):
        compiled = pyinst._compiled[li]
        if compiled is None:
            compiled = pyinst._compile(li)
            pyinst._compiled[li] = compiled
        code, n_locals, _nr = compiled
        parts.append(emit_function(module, n_imp + li, code, n_locals))

    # dispatch tables
    entries = [f"wi{i}" for i in range(n_imp)] + [
        f"f{n_imp + li}" for li in range(len(module.codes))
    ]
    parts.append(
        "static const anyfn FUNCS[] = { " + ", ".join(entries) + " };"
    )
    nres = []
    for fidx in range(n_total):
        nres.append(str(len(module.func_type(fidx).results)))
    parts.append("static const uint32_t NRES[] = { " + ", ".join(nres) + " };")
    parts.append(f"#define N_FUNCS {n_total}u")
    parts.append(_EPILOGUE)
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# Build + ctypes bridge
# ---------------------------------------------------------------------------

_BUILD_LOCK = threading.Lock()
_LIB_CACHE: Dict[str, ctypes.CDLL] = {}
build_seconds: float = 0.0  # C emission + gcc of the last module built (0 when cached)


_CODEGEN_VERSION = b"aot-torch-v1"  # bump when the emitted C ABI changes
GCC_FLAGS = ["-O2", "-shared", "-fPIC", "-fno-strict-aliasing"]


def cache_dir() -> pathlib.Path:
    return paths.cache_dir() / "aot_torch"


def _build_so(module: Module, pyinst: Instance) -> ctypes.CDLL:
    global build_seconds
    key = hashlib.sha256(module.raw + _CODEGEN_VERSION).hexdigest()[:24]
    if key in _LIB_CACHE:
        return _LIB_CACHE[key]
    with _BUILD_LOCK:
        if key in _LIB_CACHE:
            return _LIB_CACHE[key]
        out = cache_dir()
        out.mkdir(parents=True, exist_ok=True)
        so_path = out / f"{key}.so"
        if not so_path.exists():
            t0 = time.perf_counter()
            c_path = out / f"{key}.c"
            tmp_c = out / f"{key}.{os.getpid()}.tmp.c"
            tmp_c.write_text(generate_c(module, pyinst))
            _host_build.compile_shared("gcc", GCC_FLAGS, tmp_c, so_path)
            os.replace(tmp_c, c_path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so_path))
        lib.aot_create.restype = ctypes.c_void_p
        lib.aot_destroy.argtypes = [ctypes.c_void_p]
        lib.aot_set_memory.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32]
        lib.aot_write_memory.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.aot_read_memory.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ]
        lib.aot_memory_size.argtypes = [ctypes.c_void_p]
        lib.aot_memory_size.restype = ctypes.c_uint64
        lib.aot_set_globals.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32,
        ]
        lib.aot_get_global.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.aot_get_global.restype = ctypes.c_uint64
        lib.aot_set_table.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_uint32,
        ]
        lib.aot_set_import.argtypes = [ctypes.c_void_p, ctypes.c_uint32, _HOSTFN]
        lib.aot_call.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.aot_call.restype = ctypes.c_int
        lib.aot_last_error.argtypes = [ctypes.c_void_p]
        lib.aot_last_error.restype = ctypes.c_char_p
        lib.aot_call_range.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.aot_call_range.restype = ctypes.c_int
        lib.aot_read_witness.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.aot_read_witness.restype = ctypes.c_int
        _LIB_CACHE[key] = lib
        return lib


class _AotMemory:
    """Memory facade matching interp.Memory's read/write/pages surface."""

    def __init__(self, lib, ctx):
        self._lib = lib
        self._ctx = ctx

    @property
    def pages(self) -> int:
        return self._lib.aot_memory_size(self._ctx) >> 16

    def read(self, addr: int, n: int) -> bytes:
        buf = ctypes.create_string_buffer(n)
        self._lib.aot_read_memory(self._ctx, addr, buf, n)
        return buf.raw

    def write(self, addr: int, payload: bytes) -> None:
        self._lib.aot_write_memory(self._ctx, addr, payload, len(payload))


class AotInstance:
    """Drop-in for interp.Instance, executing AOT-compiled native code."""

    def __init__(self, module: Module, imports: Dict[Tuple[str, str], object]):
        # The Python instantiation applies data/elem segments, globals and
        # any start function — giving the exact post-instantiation state.
        self._pyinst = Instance(module, imports)
        self.module = module
        lib = _build_so(module, self._pyinst)
        self._lib = lib
        self._ctx = lib.aot_create()
        self._pending_exc: Optional[BaseException] = None
        self._keepalive = []

        mem = self._pyinst.memory
        data = bytes(mem.data)
        max_pages = mem.max_pages if mem.max_pages is not None else 65536
        lib.aot_set_memory(self._ctx, len(data) >> 16, max_pages)
        lib.aot_write_memory(self._ctx, 0, data, len(data))

        gl = []
        for v in self._pyinst.globals:
            if isinstance(v, float):
                raise WasmTrap("float global: AOT path unsupported")
            gl.append(int(v) & ((1 << 64) - 1))
        garr = (ctypes.c_uint64 * max(len(gl), 1))(*gl)
        lib.aot_set_globals(self._ctx, garr, len(gl))

        tbl = [(-1 if t is None else t) for t in self._pyinst.table]
        tarr = (ctypes.c_int32 * max(len(tbl), 1))(*tbl)
        lib.aot_set_table(self._ctx, tarr, len(tbl))

        for idx, host in enumerate(self._pyinst.imported_funcs):
            cb = self._make_host_cb(host.fn)
            self._keepalive.append(cb)
            lib.aot_set_import(self._ctx, idx, cb)

        self.memory = _AotMemory(lib, self._ctx)

    def __del__(self):
        try:
            self._lib.aot_destroy(self._ctx)
        except Exception:
            pass

    def _make_host_cb(self, fn):
        def cb(args_ptr, n_args, results_ptr, n_results):
            try:
                args = [args_ptr[i] & ((1 << 64) - 1) for i in range(n_args)]
                out = fn(*args)
                if n_results:
                    if out is None:
                        out = 0
                    results_ptr[0] = int(out) & ((1 << 64) - 1)
                return 0
            except BaseException as e:  # noqa: BLE001 — must not cross C
                self._pending_exc = e
                return 1

        return _HOSTFN(cb)

    # -- batched fast paths -------------------------------------------------

    def _raise_rc(self):
        if self._pending_exc is not None:
            exc = self._pending_exc
            self._pending_exc = None
            raise exc
        raise WasmTrap(self._lib.aot_last_error(self._ctx).decode())

    def call_range(self, name: str, n: int) -> List[int]:
        """[f(0), f(1), ..., f(n-1)] in one native loop."""
        idx = self.module.exports[name].index
        out = (ctypes.c_uint64 * max(n, 1))()
        self._pending_exc = None
        if self._lib.aot_call_range(self._ctx, idx, n, out):
            self._raise_rc()
        return [int(out[i]) for i in range(n)]

    def read_witness_words(self, n: int, n32: int):
        """The circom-2 readback protocol (getWitness + n32 x
        readSharedRWMemory per wire) in one native loop; returns the raw
        (n, n32) little-endian u32 word array."""
        gi = self.module.exports["getWitness"].index
        ri = self.module.exports["readSharedRWMemory"].index
        out = (ctypes.c_uint64 * (n * n32))()
        self._pending_exc = None
        if self._lib.aot_read_witness(self._ctx, gi, ri, n, n32, out):
            self._raise_rc()
        import numpy as np

        return np.ctypeslib.as_array(out).astype(np.uint32).reshape(n, n32)

    def read_witness_batch(self, n: int, n32: int) -> List[int]:
        arr = self.read_witness_words(n, n32)
        raw = arr.tobytes()  # LE u32 limbs, LSW first == LE integer bytes
        step = n32 * 4
        return [
            int.from_bytes(raw[i * step : (i + 1) * step], "little")
            for i in range(n)
        ]

    # -- Instance surface --------------------------------------------------

    def has_export(self, name: str) -> bool:
        return name in self.module.exports

    def exported(self, name: str):
        exp = self.module.exports.get(name)
        if exp is None or exp.kind != 0:
            raise WasmTrap(f"function {name} not found")
        idx = exp.index
        lib = self._lib
        ctx = self._ctx
        res = (ctypes.c_uint64 * 8)()
        nres = ctypes.c_uint32(0)

        def call(*args):
            self._pending_exc = None
            arr = (ctypes.c_uint64 * max(len(args), 1))(
                *[int(a) & ((1 << 64) - 1) for a in args]
            )
            rc = lib.aot_call(ctx, idx, arr, len(args), res, ctypes.byref(nres))
            if rc != 0:
                if self._pending_exc is not None:
                    exc = self._pending_exc
                    self._pending_exc = None
                    raise exc
                raise WasmTrap(lib.aot_last_error(ctx).decode())
            if nres.value == 0:
                return None
            if nres.value == 1:
                return int(res[0])
            return tuple(int(res[i]) for i in range(nres.value))

        return call
