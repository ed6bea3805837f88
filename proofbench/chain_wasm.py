"""A WASM witness generator for the squaring chain: the frozen copy of
circom_compat_tpu_torch/utils/chain_wasm.py (`chain_wasm`, without
`instructions_per_square`) and of circom_compat_tpu_torch/witness/fnv.py.

chain_wasm(k) assembles a circom-2-ABI module whose witness is
reference.chain_witness(k, a): wires [1, out, a, b1..b_{k-1}], b1 = a^2,
b_{i+1} = b_i^2, out = b_{k-1}^2 mod r. Setting the input signal `a` runs
the chain. The field multiply is CIOS Montgomery over 8 x 32-bit limbs in
WASM i64 ops, unrolled. Memory (bytes): [0, 32) the shared RW words,
[32, 64) R^2 mod r, [64, 96) the multiply's scratch, [96, 128) r, then
the k + 2 wires of 32 bytes.
"""

from __future__ import annotations

import struct

from reference import R as R_SCALAR

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_M64 = 0xFFFFFFFFFFFFFFFF


def fnv1a_64(name: str) -> int:
    h = FNV_OFFSET
    for byte in name.encode("utf-8"):
        h = ((h ^ byte) * FNV_PRIME) & _M64
    return h


def fnv(name: str):
    """Return the (msb_u32, lsb_u32) split circom's setInputSignal expects."""
    h = fnv1a_64(name)
    return (h >> 32) & 0xFFFFFFFF, h & 0xFFFFFFFF


I32, I64 = 0x7F, 0x7E
SHARED, R2, SCRATCH, PRIME, WIRES = 0, 32, 64, 96, 128
PAGE = 1 << 16
_N = [(R_SCALAR >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
_NPRIME = (-pow(R_SCALAR, -1, 1 << 32)) % (1 << 32)


# ---------------------------------------------------------------------------
# A small emitter
# ---------------------------------------------------------------------------


def _uleb(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _sleb(n: int) -> bytes:
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
    return _uleb(len(items)) + b"".join(items)


def _name(s: str) -> bytes:
    return _uleb(len(s)) + s.encode()


def i32c(v: int) -> bytes:
    v &= 0xFFFFFFFF
    return b"\x41" + _sleb(v - (1 << 32) if v >> 31 else v)


def i64c(v: int) -> bytes:
    v &= (1 << 64) - 1
    return b"\x42" + _sleb(v - (1 << 64) if v >> 63 else v)


def get(i: int) -> bytes:
    return b"\x20" + _uleb(i)


def setl(i: int) -> bytes:
    return b"\x21" + _uleb(i)


def tee(i: int) -> bytes:
    return b"\x22" + _uleb(i)


def call(i: int) -> bytes:
    return b"\x10" + _uleb(i)


def mem(op: int, offset: int, align: int) -> bytes:
    return bytes([op]) + _uleb(align) + _uleb(offset)


ADD, SUB, MUL, AND, SHR_U, GE_S = b"\x7c", b"\x7d", b"\x7e", b"\x83", b"\x88", b"\x59"
LOAD32_U = lambda off: mem(0x35, off, 2)  # noqa: E731  i64.load32_u
STORE32 = lambda off: mem(0x3E, off, 2)  # noqa: E731  i64.store32
MASK = i64c(0xFFFFFFFF)


def _copy32(dst: bytes, src: bytes) -> bytes:
    """Copy 32 bytes from address `src` to `dst` (each an i32 expression)."""
    return b"".join(dst + src + mem(0x29, 8 * q, 3) + mem(0x37, 8 * q, 3) for q in range(4))


class _Module:
    """Imports first, then functions: function indices follow that order."""

    def __init__(self, pages: int):
        self.pages = pages
        self.types, self.imports, self.funcs, self.exports, self.datas = [], [], [], [], []

    def _type(self, params, results) -> int:
        t = (tuple(params), tuple(results))
        if t not in self.types:
            self.types.append(t)
        return self.types.index(t)

    def import_func(self, module: str, name: str, params, results) -> int:
        self.imports.append(_name(module) + _name(name) + b"\x00"
                            + _uleb(self._type(params, results)))
        return len(self.imports) - 1

    def func(self, params, results, body: bytes, locals_=(), export=None) -> int:
        idx = len(self.imports) + len(self.funcs)
        self.funcs.append((self._type(params, results), locals_, body))
        if export:
            self.exports.append(_name(export) + b"\x00" + _uleb(idx))
        return idx

    def build(self) -> bytes:
        def section(sid, payload):
            return bytes([sid]) + _uleb(len(payload)) + payload

        out = b"\x00asm" + struct.pack("<I", 1)
        out += section(1, _vec(b"\x60" + _vec(bytes([p]) for p in ps) + _vec(bytes([r]) for r in rs)
                               for ps, rs in self.types))
        if self.imports:
            out += section(2, _vec(self.imports))
        out += section(3, _vec(_uleb(t) for t, _, _ in self.funcs))
        out += section(5, _vec([b"\x00" + _uleb(self.pages)]))
        out += section(7, _vec(self.exports + [_name("memory") + b"\x02\x00"]))
        bodies = []
        for _, locals_, body in self.funcs:
            code = _vec(_uleb(n) + bytes([vt]) for n, vt in locals_) + body + b"\x0b"
            bodies.append(_uleb(len(code)) + code)
        out += section(10, _vec(bodies))
        if self.datas:
            out += section(11, _vec(b"\x00" + i32c(off) + b"\x0b" + _uleb(len(data)) + data
                                    for off, data in self.datas))
        return out


# ---------------------------------------------------------------------------
# The field multiply
# ---------------------------------------------------------------------------

_MONT_LOCALS = ((8, I64), (10, I64), (4, I64), (1, I32))  # a0..a7, t0..t9, c s m bi, ge


def _mont_body() -> bytes:
    """mont(dst, x, y): the 8 words at dst = x y 2^-256 mod r, for x, y < r
    (CIOS, one conditional subtraction of r at the end). dst must not
    overlap x or y."""
    A = lambda j: 3 + j  # noqa: E731  the words of x
    T = lambda j: 11 + j  # noqa: E731  t0..t9
    C, S, M, BI, GE = 21, 22, 23, 24, 25

    def step(dst_t, *terms):
        """s = sum(terms) + c; t[dst_t] = s mod 2^32; c = s >> 32."""
        body = terms[0] + b"".join(t + ADD for t in terms[1:])
        return (body + get(C) + ADD + tee(S) + MASK + AND + setl(T(dst_t))
                + get(S) + i64c(32) + SHR_U + setl(C))

    code = b"".join(get(1) + LOAD32_U(4 * j) + setl(A(j)) for j in range(8))
    for i in range(8):
        code += get(2) + LOAD32_U(4 * i) + setl(BI) + i64c(0) + setl(C)
        for j in range(8):  # t += x * y_i
            code += step(j, get(T(j)), get(A(j)) + get(BI) + MUL)
        code += (get(T(8)) + get(C) + ADD + tee(S) + MASK + AND + setl(T(8))
                 + get(S) + i64c(32) + SHR_U + setl(T(9)))
        # m = t0 n' mod 2^32; t = (t + m r) / 2^32
        code += get(T(0)) + i64c(_NPRIME) + MUL + MASK + AND + setl(M)
        code += get(T(0)) + get(M) + i64c(_N[0]) + MUL + ADD + i64c(32) + SHR_U + setl(C)
        for j in range(1, 8):
            code += step(j - 1, get(T(j)), get(M) + i64c(_N[j]) + MUL)
        code += (get(T(8)) + get(C) + ADD + tee(S) + MASK + AND + setl(T(7))
                 + get(S) + i64c(32) + SHR_U + setl(C))
        code += get(T(9)) + get(C) + ADD + setl(T(8))
    # d = t - r into the x words, c the borrow; keep d where no borrow is left
    code += i64c(0) + setl(C)
    for j in range(8):
        code += (get(T(j)) + i64c(_N[j]) + SUB + get(C) + SUB + tee(S) + i64c(63) + SHR_U + setl(C)
                 + get(S) + MASK + AND + setl(A(j)))
    code += get(T(8)) + get(C) + SUB + i64c(0) + GE_S + setl(GE)
    code += b"".join(get(0) + get(A(j)) + get(T(j)) + get(GE) + b"\x1b" + STORE32(4 * j)
                     for j in range(8))
    return code


# ---------------------------------------------------------------------------
# The chain's witness generator
# ---------------------------------------------------------------------------


def chain_pages(k: int) -> int:
    """Memory pages of chain_wasm(k)."""
    return -(-(WIRES + 32 * (k + 2)) // PAGE)


def chain_wasm(k: int) -> bytes:
    """The circom-2-ABI witness generator of chain_circuit(k) (k >= 1)."""
    if k < 1:
        raise ValueError(f"the chain needs k >= 1 squares, not {k}")
    m = _Module(pages=chain_pages(k))
    exc = m.import_func("runtime", "exceptionHandler", [I32], [])
    m.datas += [(R2, ((1 << 512) % R_SCALAR).to_bytes(32, "little")),
                (PRIME, R_SCALAR.to_bytes(32, "little"))]
    mont = m.func([I32] * 3, [], _mont_body(), locals_=_MONT_LOCALS)
    # square(dst, src): dst = src^2 in normal form
    square = m.func([I32] * 2, [], i32c(SCRATCH) + get(1) + get(1) + call(mont)
                    + get(0) + i32c(SCRATCH) + i32c(R2) + call(mont))
    # run(): b1 = a^2, b_{i+1} = b_i^2 for k - 1 wires from wire 3, then out = b_{k-1}^2
    wire = lambda i: i32c(WIRES + 32 * i)  # noqa: E731
    src, dst, left = 0, 1, 2
    loop = (b"\x02\x40\x03\x40" + get(left) + b"\x45" + b"\x0d\x01"
            + get(dst) + get(src) + call(square)
            + get(dst) + setl(src) + get(dst) + i32c(32) + b"\x6a" + setl(dst)
            + get(left) + i32c(1) + b"\x6b" + setl(left) + b"\x0c\x00\x0b\x0b")
    run = m.func([], [], wire(2) + setl(src) + wire(3) + setl(dst) + i32c(k - 1) + setl(left)
                 + loop + wire(1) + get(src) + call(square), locals_=((3, I32),))

    m.func([], [I32], i32c(8), export="getFieldNumLen32")
    m.func([], [], _copy32(i32c(SHARED), i32c(PRIME)), export="getRawPrime")
    m.func([I32], [I32], get(0) + i32c(2) + b"\x74" + mem(0x28, SHARED, 2),
           export="readSharedRWMemory")
    m.func([I32, I32], [], get(0) + i32c(2) + b"\x74" + get(1) + mem(0x36, SHARED, 2),
           export="writeSharedRWMemory")
    m.func([I32], [], i32c(WIRES) + i64c(1) + mem(0x37, 0, 3)
           + b"".join(i32c(WIRES) + i64c(0) + mem(0x37, 8 * q, 3) for q in range(1, 4)),
           export="init")
    msb, lsb = fnv("a")
    is_a = get(0) + i32c(msb) + b"\x46" + get(1) + i32c(lsb) + b"\x46" + b"\x71"
    m.func([I32] * 3, [],
           is_a + b"\x04\x40" + get(2) + b"\x04\x40" + i32c(6) + call(exc) + b"\x0f\x0b"
           + _copy32(wire(2), i32c(SHARED)) + call(run) + b"\x0f\x0b"
           + i32c(1) + call(exc), export="setInputSignal")
    m.func([], [I32], i32c(1), export="getInputSize")
    m.func([], [I32], i32c(k + 2), export="getWitnessSize")
    m.func([], [I32], i32c(0), export="getMessageChar")
    m.func([I32], [], _copy32(i32c(SHARED), get(0) + i32c(5) + b"\x74" + i32c(WIRES) + b"\x6a"),
           export="getWitness")
    return m.build()
