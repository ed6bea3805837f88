"""circom_compat_tpu_torch witness layer (witness/) against the JAX package.

The repo holds no Circom-compiled .wasm, so the modules are assembled here
from bytes (`ModuleBuilder`):
  - the port's WASM `Instance` and the JAX package's run the same exported
    functions on the same seeded arguments: i32/i64 arithmetic, compares,
    bit counts and conversions; memory loads and stores of every width, a
    data segment, memory.size/grow; calls, recursion, loops, call_indirect
    through a table, globals, a host import; and the traps (divide by zero,
    signed overflow, unreachable, an out-of-bounds access, a null table
    entry) — equal results, equal trap messages;
  - `mul_module()`, a circom-2 ABI witness generator for c = a * b
    (witness [1, c, a, b]; exact for a, b < 2^32, like the reference's
    mycircuit), gives the same witness and limbs through both packages'
    WitnessCalculator (the JAX one on its interpreter: CIRCOM_TPU_AOT=0,
    CIRCOM_TPU_NATIVE=0), and the same error for an unknown signal;
  - `legacy_mul_module()`, the same circuit on the circom-1 ABI (an
    imported 2000-page env.memory, SafeMemory's Fr structs, a Montgomery
    long-form value), gives the same witness through both;
  - fnv and the wtns round trip of tests/test_witness.py.
Tolerance: exact equality.
"""

import struct

import numpy as np
import pytest

from circom_compat_tpu.witness import WitnessCalculator as JaxWitnessCalculator
from circom_compat_tpu.witness import WitnessCalcError as JaxWitnessCalcError
from circom_compat_tpu.witness.wasm import interp as jax_interp
from circom_compat_tpu.witness.wasm.module import decode_module as jax_decode
from circom_compat_tpu_torch.circom.wtns import read_wtns, read_wtns_limbs, write_wtns
from circom_compat_tpu_torch.constants import R_SCALAR
from circom_compat_tpu_torch.witness import Wasm, WitnessCalculator, WitnessCalcError
from circom_compat_tpu_torch.witness.fnv import fnv, fnv1a_64
from circom_compat_tpu_torch.witness.wasm import interp
from circom_compat_tpu_torch.witness.wasm.module import decode_module

RNG = np.random.default_rng(0x7A5)
I32, I64 = 0x7F, 0x7E


# ---------------------------------------------------------------------------
# A minimal WASM assembler
# ---------------------------------------------------------------------------


def uleb(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def sleb(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        done = (n == 0 and not b & 0x40) or (n == -1 and b & 0x40)
        out.append(b | (0 if done else 0x80))
        if done:
            return bytes(out)


def _vec(items) -> bytes:
    items = list(items)
    return uleb(len(items)) + b"".join(items)


def _name(s: str) -> bytes:
    return uleb(len(s.encode())) + s.encode()


def i32c(v: int) -> bytes:
    v &= 0xFFFFFFFF
    return b"\x41" + sleb(v - (1 << 32) if v >> 31 else v)


def i64c(v: int) -> bytes:
    v &= (1 << 64) - 1
    return b"\x42" + sleb(v - (1 << 64) if v >> 63 else v)


def get(i: int) -> bytes:
    return b"\x20" + uleb(i)


def setl(i: int) -> bytes:
    return b"\x21" + uleb(i)


def call(i: int) -> bytes:
    return b"\x10" + uleb(i)


def mem(op: int, offset: int = 0, align: int = 0) -> bytes:
    return bytes([op]) + uleb(align) + uleb(offset)


class ModuleBuilder:
    """Imports first, then functions: function indices follow that order."""

    def __init__(self):
        self.types, self.imports, self.funcs = [], [], []
        self.exports, self.datas, self.globals, self.elems = [], [], [], []
        self.memory = None
        self.table = 0
        self.n_imported = 0

    def type(self, params, results) -> int:
        t = (tuple(params), tuple(results))
        if t not in self.types:
            self.types.append(t)
        return self.types.index(t)

    def import_func(self, module, name, params, results) -> int:
        assert not self.funcs
        self.imports.append(_name(module) + _name(name) + b"\x00" + uleb(self.type(params, results)))
        self.n_imported += 1
        return self.n_imported - 1

    def import_memory(self, module, name, min_pages):
        self.imports.append(_name(module) + _name(name) + b"\x02\x00" + uleb(min_pages))

    def func(self, params, results, body: bytes, locals_=(), export=None) -> int:
        idx = self.n_imported + len(self.funcs)
        self.funcs.append((self.type(params, results), list(locals_), body))
        if export:
            self.exports.append(_name(export) + b"\x00" + uleb(idx))
        return idx

    def global_(self, vt, init: bytes, mutable=True) -> int:
        self.globals.append(bytes([vt, int(mutable)]) + init + b"\x0b")
        return len(self.globals) - 1

    def build(self) -> bytes:
        def section(sid, payload):
            return bytes([sid]) + uleb(len(payload)) + payload

        out = b"\x00asm" + struct.pack("<I", 1)
        out += section(1, _vec(b"\x60" + _vec(bytes([p]) for p in ps) + _vec(bytes([r]) for r in rs)
                               for ps, rs in self.types))
        if self.imports:
            out += section(2, _vec(self.imports))
        out += section(3, _vec(uleb(t) for t, _, _ in self.funcs))
        if self.table:
            out += section(4, _vec([b"\x70\x00" + uleb(self.table)]))
        if self.memory is not None:
            out += section(5, _vec([b"\x00" + uleb(self.memory)]))
            self.exports.append(_name("memory") + b"\x02\x00")
        if self.globals:
            out += section(6, _vec(self.globals))
        out += section(7, _vec(self.exports))
        if self.elems:
            out += section(9, _vec(b"\x00" + i32c(off) + b"\x0b" + _vec(uleb(f) for f in fs)
                                   for off, fs in self.elems))
        bodies = []
        for _, locals_, body in self.funcs:
            loc = _vec(uleb(1) + bytes([vt]) for vt in locals_)
            code = loc + body + b"\x0b"
            bodies.append(uleb(len(code)) + code)
        out += section(10, _vec(bodies))
        if self.datas:
            out += section(11, _vec(b"\x00" + i32c(off) + b"\x0b" + uleb(len(data)) + data
                                    for off, data in self.datas))
        return out


# ---------------------------------------------------------------------------
# Instance parity
# ---------------------------------------------------------------------------

BINOPS = {  # name -> (opcode, value type)
    **{f"i32.{n}": (op, I32) for n, op in [
        ("eq", 0x46), ("ne", 0x47), ("lt_s", 0x48), ("lt_u", 0x49), ("gt_s", 0x4A),
        ("gt_u", 0x4B), ("le_s", 0x4C), ("le_u", 0x4D), ("ge_s", 0x4E), ("ge_u", 0x4F),
        ("add", 0x6A), ("sub", 0x6B), ("mul", 0x6C), ("div_s", 0x6D), ("div_u", 0x6E),
        ("rem_s", 0x6F), ("rem_u", 0x70), ("and", 0x71), ("or", 0x72), ("xor", 0x73),
        ("shl", 0x74), ("shr_s", 0x75), ("shr_u", 0x76), ("rotl", 0x77), ("rotr", 0x78)]},
    **{f"i64.{n}": (op, I64) for n, op in [
        ("eq", 0x51), ("ne", 0x52), ("lt_s", 0x53), ("lt_u", 0x54), ("gt_s", 0x55),
        ("gt_u", 0x56), ("le_s", 0x57), ("le_u", 0x58), ("ge_s", 0x59), ("ge_u", 0x5A),
        ("add", 0x7C), ("sub", 0x7D), ("mul", 0x7E), ("div_s", 0x7F), ("div_u", 0x80),
        ("rem_s", 0x81), ("rem_u", 0x82), ("and", 0x83), ("or", 0x84), ("xor", 0x85),
        ("shl", 0x86), ("shr_s", 0x87), ("shr_u", 0x88), ("rotl", 0x89), ("rotr", 0x8A)]},
}
UNOPS = {  # name -> (opcode, param type, result type)
    "i32.eqz": (0x45, I32, I32), "i32.clz": (0x67, I32, I32), "i32.ctz": (0x68, I32, I32),
    "i32.popcnt": (0x69, I32, I32), "i64.eqz": (0x50, I64, I32), "i64.clz": (0x79, I64, I64),
    "i64.ctz": (0x7A, I64, I64), "i64.popcnt": (0x7B, I64, I64),
    "i32.wrap_i64": (0xA7, I64, I32), "i64.extend_i32_s": (0xAC, I32, I64),
    "i64.extend_i32_u": (0xAD, I32, I64),
}
LOADS = {"i32.load": (0x28, I32, 2), "i64.load": (0x29, I64, 3), "i32.load8_s": (0x2C, I32, 0),
         "i32.load8_u": (0x2D, I32, 0), "i32.load16_s": (0x2E, I32, 1),
         "i32.load16_u": (0x2F, I32, 1), "i64.load8_s": (0x30, I64, 0),
         "i64.load8_u": (0x31, I64, 0), "i64.load16_s": (0x32, I64, 1),
         "i64.load16_u": (0x33, I64, 1), "i64.load32_s": (0x34, I64, 2),
         "i64.load32_u": (0x35, I64, 2)}
STORES = {"i32.store": (0x36, I32, 2), "i64.store": (0x37, I64, 3), "i32.store8": (0x3A, I32, 0),
          "i32.store16": (0x3B, I32, 1), "i64.store8": (0x3C, I64, 0),
          "i64.store16": (0x3D, I64, 1), "i64.store32": (0x3E, I64, 2)}


def arith_module() -> bytes:
    m = ModuleBuilder()
    for name, (op, vt) in BINOPS.items():
        res = I32 if name.split(".")[1][:2] in ("eq", "ne", "lt", "gt", "le", "ge") else vt
        m.func([vt, vt], [res], get(0) + get(1) + bytes([op]), export=name)
    for name, (op, pt, rt) in UNOPS.items():
        m.func([pt], [rt], get(0) + bytes([op]), export=name)
    return m.build()


def memory_module() -> bytes:
    m = ModuleBuilder()
    m.memory = 1
    m.datas.append((16, bytes(range(1, 33))))
    for name, (op, vt, align) in LOADS.items():
        m.func([I32], [vt], get(0) + mem(op, 3, align), export=name)  # memarg offset 3
    for name, (op, vt, align) in STORES.items():
        m.func([I32, vt], [], get(0) + get(1) + mem(op, 0, align), export=name)
    m.func([], [I32], b"\x3f\x00", export="size")
    m.func([I32], [I32], get(0) + b"\x40\x00", export="grow")
    return m.build()


def control_module():
    """Calls, recursion, loops, call_indirect, globals, select, a host import."""
    m = ModuleBuilder()
    log = m.import_func("env", "log", [I64], [])
    counter = m.global_(I64, i64c(0))
    # fact(n) = n <= 1 ? 1 : n * fact(n - 1)   (i64, recursive)
    fact = m.n_imported + len(m.funcs)  # the index it is about to get
    m.func([I64], [I64],
           get(0) + i64c(1) + b"\x57" + b"\x04" + bytes([I64]) + i64c(1) + b"\x05"
           + get(0) + get(0) + i64c(1) + b"\x7d" + call(fact) + b"\x7e" + b"\x0b",
           export="fact")
    # sum_to(n): loop with block / br_if; bumps the global once per call and logs n
    m.func([I32], [I64],
           get(0) + b"\xad" + call(log)
           + b"\x23" + uleb(counter) + i64c(1) + b"\x7c" + b"\x24" + uleb(counter)
           + b"\x02\x40" + b"\x03\x40"
           + get(0) + b"\x45" + b"\x0d\x01"
           + get(1) + get(0) + b"\xad" + b"\x7c" + setl(1)
           + get(0) + i32c(1) + b"\x6b" + setl(0)
           + b"\x0c\x00" + b"\x0b" + b"\x0b" + get(1),
           locals_=[I64], export="sum_to")
    m.func([], [I64], b"\x23" + uleb(counter), export="counter")
    # call_indirect through a table of three: [double, square, (null)]
    dbl = m.func([I64], [I64], get(0) + get(0) + b"\x7c")
    sq = m.func([I64], [I64], get(0) + get(0) + b"\x7e")
    m.table = 3
    m.elems.append((0, [dbl, sq]))
    m.func([I32, I64], [I64], get(1) + get(0) + b"\x11" + uleb(m.type([I64], [I64])) + b"\x00",
           export="dispatch")
    m.func([I32, I32, I32], [I32], get(0) + get(1) + get(2) + b"\x1b", export="select")
    m.func([], [], b"\x00", export="trap")
    return m.build()


def _instances(data: bytes):
    """(port, JAX) instances of one module, each logging host calls."""
    logs = ([], [])
    port = interp.Instance(decode_module(data), {("env", "log"): logs[0].append})
    jax = jax_interp.Instance(jax_decode(data), {("env", "log"): logs[1].append})
    return port, jax, logs


def _outcome(inst, name, args):
    try:
        return ("ok", inst.exported(name)(*args))
    except (interp.WasmTrap, jax_interp.WasmTrap) as e:
        return ("trap", str(e))


def _edge_values(bits, count):
    top = 1 << bits
    edges = [0, 1, 2, 3, top - 1, top - 2, top >> 1, (top >> 1) - 1, (top >> 1) + 1, 31, 32, 63, 64]
    rand = [int(v) for v in RNG.integers(0, top, size=count, dtype=np.uint64 if bits == 64 else np.int64)]
    return edges + rand


def test_arith_ops_match_jax():
    port, jax, _ = _instances(arith_module())
    traps = 0
    for name, (_, vt) in BINOPS.items():
        vals = _edge_values(32 if vt == I32 else 64, 8)
        for a in vals:
            for b in vals:
                got, want = _outcome(port, name, (a, b)), _outcome(jax, name, (a, b))
                assert got == want, (name, a, b)
                traps += got[0] == "trap"
    for name, (_, pt, _) in UNOPS.items():
        for a in _edge_values(32 if pt == I32 else 64, 32):
            assert _outcome(port, name, (a,)) == _outcome(jax, name, (a,)), (name, a)
    assert traps > 0  # divide by zero and signed overflow were reached


def test_memory_ops_match_jax():
    port, jax, _ = _instances(memory_module())
    for inst in (port, jax):
        assert inst.memory.read(16, 32) == bytes(range(1, 33))  # the data segment
    size = 1 << 16
    addrs = [0, 13, 100, size - 16, size - 8, size - 4, size - 3, size - 1, size]
    addrs += [int(a) for a in RNG.integers(0, size, size=24)]
    for i, addr in enumerate(addrs):
        name = list(STORES)[i % len(STORES)]
        v = int(RNG.integers(0, 1 << 63)) * 2 + i % 2
        v &= 0xFFFFFFFF if STORES[name][1] == I32 else (1 << 64) - 1
        assert _outcome(port, name, (addr, v)) == _outcome(jax, name, (addr, v)), (name, addr)
        for load in LOADS:
            assert _outcome(port, load, (addr,)) == _outcome(jax, load, (addr,)), (load, addr)
    assert port.memory.read(0, size) == jax.memory.read(0, size)
    assert _outcome(port, "i32.load", (size - 3,))[0] == "trap"  # offset 3 runs past the end
    assert [_outcome(port, n, a) for n, a in (("size", ()), ("grow", (2,)), ("size", ()))] == \
        [_outcome(jax, n, a) for n, a in (("size", ()), ("grow", (2,)), ("size", ()))]


def test_control_and_calls_match_jax():
    port, jax, logs = _instances(control_module())
    calls = [("fact", (n,)) for n in (0, 1, 5, 20, 25)]
    calls += [("sum_to", (n,)) for n in (0, 1, 10, 1000)] + [("counter", ())]
    calls += [("dispatch", (i, x)) for i in (0, 1, 2, 7) for x in (3, (1 << 63) + 5)]
    calls += [("select", (7, 9, c)) for c in (0, 1, 5)] + [("trap", ())]
    got = [_outcome(port, n, a) for n, a in calls]
    assert got == [_outcome(jax, n, a) for n, a in calls]
    assert got[2] == ("ok", 120) and got[8] == ("ok", 500500) and got[9] == ("ok", 4)
    assert [o for o, _ in got].count("trap") == 5  # null and out-of-range entries, unreachable
    assert logs[0] == logs[1] == [0, 1, 10, 1000]


# ---------------------------------------------------------------------------
# A circom-2 ABI witness generator: c = a * b, witness [1, c, a, b]
# ---------------------------------------------------------------------------

SHARED, PRIME, WIT = 0, 64, 256  # memory: shared RW words, the prime, the witness slots


def _copy32(dst_local_or_const, src_addr: bytes, dst_off: int, src_off: int) -> bytes:
    out = b""
    for k in range(4):
        out += dst_local_or_const + src_addr + mem(0x29, src_off + 8 * k, 3) + mem(0x37, dst_off + 8 * k, 3)
    return out


def mul_module() -> bytes:
    m = ModuleBuilder()
    m.memory = 1
    exc = m.import_func("runtime", "exceptionHandler", [I32], [])
    m.datas.append((PRIME, R_SCALAR.to_bytes(32, "little")))
    m.func([], [I32], i32c(8), export="getFieldNumLen32")
    m.func([], [], _copy32(i32c(0), i32c(0), SHARED, PRIME), export="getRawPrime")
    m.func([I32], [I32], get(0) + i32c(2) + b"\x74" + mem(0x28, SHARED, 2), export="readSharedRWMemory")
    m.func([I32, I32], [], get(0) + i32c(2) + b"\x74" + get(1) + mem(0x36, SHARED, 2),
           export="writeSharedRWMemory")
    # init: w0 = 1
    zero_w0 = b"".join(i32c(0) + i64c(0) + mem(0x37, WIT + 8 * k, 3) for k in range(1, 4))
    m.func([I32], [], i32c(0) + i64c(1) + mem(0x37, WIT, 3) + zero_w0, export="init")
    # setInputSignal(msb, lsb, pos): "a" -> w2, "b" -> w3, else exceptionHandler(1)
    body = b""
    for sig, slot in (("a", 2), ("b", 3)):
        msb, lsb = fnv(sig)
        body += (get(0) + i32c(msb) + b"\x46" + get(1) + i32c(lsb) + b"\x46" + b"\x71"
                 + b"\x04\x40" + _copy32(i32c(0), i32c(0), WIT + 32 * slot, SHARED) + b"\x0f\x0b")
    m.func([I32, I32, I32], [], body + i32c(1) + call(exc), export="setInputSignal")
    m.func([], [I32], i32c(2), export="getInputSize")
    m.func([], [I32], i32c(4), export="getWitnessSize")
    m.func([], [I32], i32c(0), export="getMessageChar")
    # getWitness(i): w1 = lo64(a) * lo64(b), then copy slot i to the shared words
    w1 = (i32c(0) + i32c(0) + mem(0x29, WIT + 64, 3) + i32c(0) + mem(0x29, WIT + 96, 3) + b"\x7e"
          + mem(0x37, WIT + 32, 3)
          + b"".join(i32c(0) + i64c(0) + mem(0x37, WIT + 32 + 8 * k, 3) for k in range(1, 4)))
    m.func([I32], [], w1 + get(0) + i32c(5) + b"\x74" + setl(1)
           + _copy32(i32c(0), get(1), SHARED, WIT), locals_=[I32], export="getWitness")
    return m.build()


def legacy_mul_module() -> bytes:
    """The same circuit on the circom-1 ABI: an imported env.memory, Fr
    structs (8-byte header + 32 bytes; w0 stored as 1 in Montgomery form),
    getSignalOffset32 / setSignal / getPWitness."""
    m = ModuleBuilder()
    err = m.import_func("runtime", "error", [I32], [])
    m.import_memory("env", "memory", 1)
    slots = 512  # signal i's Fr struct at 512 + 40 i
    m.datas += [(0, struct.pack("<I", 1024)), (PRIME, R_SCALAR.to_bytes(32, "little")),
                (slots, struct.pack("<II", 0, 0xC0000000) + ((1 << 256) % R_SCALAR).to_bytes(32, "little"))]
    m.func([], [I32], i32c(40), export="getFrLen")
    m.func([], [I32], i32c(PRIME), export="getPRawPrime")
    m.func([], [I32], i32c(4), export="getNVars")
    m.func([I32], [], b"", export="init")
    body = b""
    for sig, idx in (("a", 2), ("b", 3)):
        msb, lsb = fnv(sig)
        body += (get(2) + i32c(msb) + b"\x46" + get(3) + i32c(lsb) + b"\x46" + b"\x71"
                 + b"\x04\x40" + get(0) + i32c(idx) + mem(0x36, 0, 2) + b"\x0f\x0b")
    m.func([I32] * 4, [], body + i32c(1) + call(err), export="getSignalOffset32")
    copy = b"".join(get(4) + get(3) + mem(0x29, 8 * k, 3) + mem(0x37, 8 * k, 3) for k in range(5))
    m.func([I32] * 4, [], get(2) + i32c(40) + b"\x6c" + i32c(slots) + b"\x6a" + setl(4) + copy,
           locals_=[I32], export="setSignal")

    def value(slot):  # the low 64 bits of a short or a long (non-Montgomery) Fr
        return (i32c(0) + mem(0x2D, slot + 7, 0) + i32c(0x80) + b"\x71" + b"\x04" + bytes([I64])
                + i32c(0) + mem(0x29, slot + 8, 3) + b"\x05" + i32c(0) + mem(0x35, slot, 2) + b"\x0b")

    c = slots + 40
    product = (i32c(0) + i32c(0) + mem(0x36, c, 2) + i32c(0) + i32c(0x80000000) + mem(0x36, c + 4, 2)
               + i32c(0) + value(slots + 80) + value(slots + 120) + b"\x7e" + mem(0x37, c + 8, 3)
               + b"".join(i32c(0) + i64c(0) + mem(0x37, c + 8 * k, 3) for k in range(2, 5)))
    m.func([I32], [I32], product + get(0) + i32c(40) + b"\x6c" + i32c(slots) + b"\x6a",
           export="getPWitness")
    return m.build()


@pytest.fixture
def jax_interpreter(monkeypatch):
    """The JAX WitnessCalculator on its interpreter, not its AOT or native engine."""
    monkeypatch.setenv("CIRCOM_TPU_AOT", "0")
    monkeypatch.setenv("CIRCOM_TPU_NATIVE", "0")


@pytest.mark.parametrize("a,b", [(3, 11), (2**32 - 50, 11), (0, 7), (2**32 - 1, 2**32 - 1)])
def test_circom2_witness_matches_jax(jax_interpreter, a, b):
    data = mul_module()
    wc, jwc = WitnessCalculator(data), JaxWitnessCalculator(data)
    assert type(jwc.instance) is jax_interp.Instance
    assert (wc.n32, wc.prime, wc.n64, wc.legacy) == (jwc.n32, jwc.prime, jwc.n64, jwc.legacy) \
        == (8, R_SCALAR, 4, False)
    inputs = {"a": a, "b": str(b)}
    w = wc.calculate_witness(inputs)
    assert w == jwc.calculate_witness(inputs) == [1, a * b, a, b]
    limbs = wc.calculate_witness_limbs(inputs)
    assert limbs.dtype == np.uint32 and np.array_equal(limbs, jwc.calculate_witness_limbs(inputs))


@pytest.mark.parametrize("a,b", [(3, 11), (2**31 + 5, 2**32 - 1)])
def test_legacy_witness_matches_jax(jax_interpreter, a, b):
    data = legacy_mul_module()
    wc, jwc = WitnessCalculator(data), JaxWitnessCalculator(data)
    assert wc.legacy and jwc.legacy and (wc.n32, wc.prime) == (jwc.n32, jwc.prime) == (8, R_SCALAR)
    assert wc.instance.memory.pages == 2000  # the host's env.memory
    inputs = {"a": a, "b": [b]}
    assert wc.calculate_witness(inputs) == jwc.calculate_witness(inputs) == [1, a * b, a, b]
    assert np.array_equal(wc.calculate_witness_limbs(inputs), jwc.calculate_witness_limbs(inputs))
    for calc, err in ((wc, WitnessCalcError), (jwc, JaxWitnessCalcError)):
        with pytest.raises(err, match=r"runtime error, exiting early: \(1,\)"):
            calc.calculate_witness({"c": 1})


def test_circom2_errors_match_jax(jax_interpreter):
    data = mul_module()
    for calc, err in ((WitnessCalculator(data), WitnessCalcError),
                      (JaxWitnessCalculator(data), JaxWitnessCalcError)):
        with pytest.raises(err, match="^Signal not found.$"):
            calc.calculate_witness({"bogus": 1, "b": 2})
        with pytest.raises(err, match="Not all inputs have been set. Only 1 out of 2"):
            calc.calculate_witness({"a": 1})


def test_wasm_facade_on_the_module():
    wasm = Wasm(WitnessCalculator(mul_module()).instance)
    assert wasm.get_field_num_len32() == 8
    wasm.get_raw_prime()
    assert sum(wasm.read_shared_rw_memory(i) << (32 * i) for i in range(8)) == R_SCALAR
    wasm.write_shared_rw_memory(3, 0xDEADBEEF)
    assert wasm.read_shared_rw_memory(3) == 0xDEADBEEF
    assert wasm.get_witness_size() == 4
    with pytest.raises(interp.WasmTrap, match="getNVars"):
        wasm.get_n_vars()


def test_fnv():
    assert fnv1a_64("") == 0xCBF29CE484222325
    msb, lsb = fnv("a")
    assert (msb << 32) | lsb == fnv1a_64("a")
    from circom_compat_tpu.witness.fnv import fnv as jax_fnv

    for name in ("a", "b", "main.in[3]", "ünïcode"):
        assert fnv(name) == jax_fnv(name)


def test_wtns_roundtrip(tmp_path):
    values = [1, 33, 3, 11, R_SCALAR - 1]
    path = tmp_path / "out.wtns"
    write_wtns(values, path)
    assert read_wtns(path) == values
    assert read_wtns_limbs(path).tolist() == [[(v >> (16 * i)) & 0xFFFF for i in range(16)]
                                              for v in values]
