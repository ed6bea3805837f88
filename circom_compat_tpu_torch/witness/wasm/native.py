"""ctypes bridge to the C++ WASM VM (hostsrc/wasm_vm.cpp), engine="native".

Split of responsibilities: the Python side keeps the module parser and the
structured-control -> flat-bytecode compiler (interp.py); this bridge
transfers the compiled functions, globals, table and memory image into the
C++ VM and exposes the same Instance surface (exported(), memory.read/
write, has_export) the WitnessCalculator drives. Host imports (runtime.*)
become C callbacks into the original Python callables: an exception raised
there is stored and re-raised after the VM unwinds with a trap.

The library is built by g++ at first use into the package's _build_cache/
(_host_build.py); nothing is written beside the source.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

from ... import _host_build
from .interp import (
    Instance,
    WasmTrap,
    OP_BR,
    OP_BR_IF,
    OP_BR_TABLE,
    OP_CALL,
    OP_CONST,
)
from .module import Module

_OP_TRAP_FLOAT = 0xFFFF1

_LOAD_LOCK = threading.Lock()

_HOSTFN = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int32,
    ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int32,
)

_lib = None


def _load_lib():
    global _lib
    with _LOAD_LOCK:
        if _lib is not None:
            return _lib
        lib = _host_build.lib("wasm_vm")
        lib.vm_create.restype = ctypes.c_void_p
        lib.vm_destroy.argtypes = [ctypes.c_void_p]
        lib.vm_set_memory.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32]
        lib.vm_write_memory.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.vm_read_memory.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ]
        lib.vm_memory_size.argtypes = [ctypes.c_void_p]
        lib.vm_memory_size.restype = ctypes.c_uint64
        lib.vm_set_globals.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32,
        ]
        lib.vm_get_global.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.vm_get_global.restype = ctypes.c_uint64
        lib.vm_set_table.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_uint32,
        ]
        lib.vm_add_import.argtypes = [
            ctypes.c_void_p, _HOSTFN, ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.vm_add_func.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_uint32,
        ]
        lib.vm_add_func.restype = ctypes.c_int
        lib.vm_call.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.vm_call.restype = ctypes.c_int
        lib.vm_last_error.argtypes = [ctypes.c_void_p]
        lib.vm_last_error.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _encode_function(compiled, n_params, n_results):
    """Flat (op, a, b) tuples -> C arrays (ops, a, b, branches, tables)."""
    code, n_locals, _n_results = compiled
    n = len(code)
    ops = (ctypes.c_uint32 * n)()
    aa = (ctypes.c_int64 * n)()
    bb = (ctypes.c_int64 * n)()
    branches: List[int] = []
    tables: List[int] = []
    n_tables = 0

    def enc_i64(v: int) -> int:
        v &= (1 << 64) - 1
        return v - (1 << 64) if v >= (1 << 63) else v

    for i, (op, a, b) in enumerate(code):
        a_enc = 0
        b_enc = 0
        if op == OP_BR or op == OP_BR_IF:
            t, keep, entry = a
            a_enc = len(branches) // 3
            branches.extend([t, keep, entry])
        elif op == OP_BR_TABLE:
            targets, default = a
            a_enc = n_tables
            n_tables += 1
            tables.append(len(targets) + 1)
            for t, keep, entry in list(targets) + [default]:
                tables.extend([t, keep, entry])
        elif op == OP_CALL:
            a_enc = a
            b_enc = b[0] | (b[1] << 16)
        elif op == OP_CONST:
            if isinstance(a, float):
                op = _OP_TRAP_FLOAT
            else:
                a_enc = enc_i64(int(a))
        elif a is not None and isinstance(a, int):
            a_enc = enc_i64(a)
        elif a is not None:
            raise WasmTrap(f"operand not natively encodable at op {op:#x}")
        ops[i] = op
        aa[i] = a_enc
        bb[i] = b_enc

    br = (ctypes.c_int32 * max(len(branches), 1))(*branches)
    tb = (ctypes.c_int32 * max(len(tables), 1))(*tables)
    return ops, aa, bb, br, len(branches) // 3, tb, len(tables), n_locals


class _NativeMemory:
    """Memory facade matching interp.Memory's read/write/pages surface."""

    def __init__(self, lib, vm):
        self._lib = lib
        self._vm = vm

    @property
    def pages(self) -> int:
        return self._lib.vm_memory_size(self._vm) >> 16

    def read(self, addr: int, n: int) -> bytes:
        buf = ctypes.create_string_buffer(n)
        self._lib.vm_read_memory(self._vm, addr, buf, n)
        return buf.raw

    def write(self, addr: int, payload: bytes) -> None:
        self._lib.vm_write_memory(self._vm, addr, payload, len(payload))


class NativeInstance:
    """Drop-in for interp.Instance, executing on the C++ VM."""

    def __init__(self, module: Module, imports: Dict[Tuple[str, str], object]):
        lib = _load_lib()
        # Parse/link/compile with the reference Python machinery first: this
        # applies data segments, globals, elem segments and runs any start
        # function, giving us the exact post-instantiation state to mirror.
        self._pyinst = Instance(module, imports)
        self.module = module

        self._vm = lib.vm_create()
        self._lib = lib
        self._pending_exc: Optional[BaseException] = None
        self._keepalive = []

        # memory image
        mem = self._pyinst.memory
        data = bytes(mem.data)
        max_pages = mem.max_pages if mem.max_pages is not None else 65536
        lib.vm_set_memory(self._vm, 0, max_pages)
        lib.vm_write_memory(self._vm, 0, data, len(data))

        # globals (integers only on the native path)
        gl = []
        for v in self._pyinst.globals:
            if isinstance(v, float):
                raise WasmTrap("float global: native path unsupported")
            gl.append(int(v) & ((1 << 64) - 1))
        garr = (ctypes.c_uint64 * max(len(gl), 1))(*gl)
        lib.vm_set_globals(self._vm, garr, len(gl))

        # table
        tbl = [(-1 if t is None else t) for t in self._pyinst.table]
        tarr = (ctypes.c_int32 * max(len(tbl), 1))(*tbl)
        lib.vm_set_table(self._vm, tarr, len(tbl))

        # imports, in function-index order
        for idx, host in enumerate(self._pyinst.imported_funcs):
            imp_meta = [i for i in module.imports if i.kind == 0][idx]
            ftype = module.types[imp_meta.desc]
            cb = self._make_host_cb(host.fn)
            self._keepalive.append(cb)
            lib.vm_add_import(self._vm, cb, len(ftype.params), len(ftype.results))

        # functions: compile every local function up front
        for li in range(len(module.codes)):
            compiled = self._pyinst._compiled[li]
            if compiled is None:
                compiled = self._pyinst._compile(li)
                self._pyinst._compiled[li] = compiled
            fidx = module.num_imported_funcs + li
            ftype = module.func_type(fidx)
            ops, aa, bb, br, nbr, tb, ntw, n_locals = _encode_function(
                compiled, len(ftype.params), len(ftype.results)
            )
            lib.vm_add_func(
                self._vm, len(ftype.params), len(ftype.results), n_locals,
                len(ops), ops, aa, bb, br, nbr, tb, ntw,
            )

        self.memory = _NativeMemory(lib, self._vm)

    def __del__(self):
        try:
            self._lib.vm_destroy(self._vm)
        except Exception:
            pass

    def _make_host_cb(self, fn):
        def cb(args_ptr, n_args, results_ptr, n_results):
            try:
                args = [args_ptr[i] for i in range(n_args)]
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

    # -- Instance surface --------------------------------------------------

    def has_export(self, name: str) -> bool:
        return name in self.module.exports

    def exported(self, name: str):
        exp = self.module.exports.get(name)
        if exp is None or exp.kind != 0:
            raise WasmTrap(f"function {name} not found")
        idx = exp.index
        lib = self._lib
        vm = self._vm
        res = (ctypes.c_uint64 * 8)()
        nres = ctypes.c_uint32(0)

        def call(*args):
            self._pending_exc = None
            arr = (ctypes.c_uint64 * max(len(args), 1))(
                *[int(a) & ((1 << 64) - 1) for a in args]
            )
            rc = lib.vm_call(vm, idx, arr, len(args), res, ctypes.byref(nres))
            if rc != 0:
                if self._pending_exc is not None:
                    exc = self._pending_exc
                    self._pending_exc = None
                    raise exc
                raise WasmTrap(lib.vm_last_error(vm).decode())
            if nres.value == 0:
                return None
            if nres.value == 1:
                return int(res[0])
            return tuple(int(res[i]) for i in range(nres.value))

        return call
