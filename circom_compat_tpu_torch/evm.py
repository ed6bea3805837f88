"""Minimal EVM for on-chain Groth16 verifier conformance, no external node.

The reference proves its Ethereum serialization end-to-end by spawning an
Anvil EVM and calling the compiled `tests/verifier.sol` over JSON-RPC
(reference: tests/solidity.rs:17-58, 39-43). Without an EVM node, this
module executes the SAME compiled contract bytecode (reference:
tests/verifier_artifact.json, deployedBytecode) in-process: a small EVM
interpreter plus the BN254 precompiles (ecAdd 0x06, ecMul 0x07,
ecPairing 0x08) and identity / sha256 (0x04, 0x02), backed by the
package's refmath, so the real Solidity code path runs against the proof
bytes.

Scope: enough of the Berlin/London opcode set for solc 0.7-0.8 view
functions: no gas accounting, no state commitment, storage is a dict.
Not a consensus EVM; a conformance harness. Host code only. The copy of
circom_compat_tpu/evm.py.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

from .constants import Q, R_SCALAR
from .refmath import curve as rc

U256 = 1 << 256
MASK = U256 - 1
SIGN_BIT = 1 << 255

# ---------------------------------------------------------------------------
# keccak-256 (pure python keccak-f[1600], original Keccak padding 0x01)
# ---------------------------------------------------------------------------

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROTC = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_M64 = (1 << 64) - 1


def _rotl64(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _M64


def _keccak_f(a):
    for rnd in range(24):
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl64(a[x][y], _ROTC[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= _RC[rnd]
    return a


def keccak256(data: bytes) -> bytes:
    rate = 136  # bytes, for 256-bit output
    # pad10*1 with domain byte 0x01 (original keccak, as used by Ethereum)
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    a = [[0] * 5 for _ in range(5)]
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            a[i % 5][i // 5] ^= lane
        a = _keccak_f(a)
    out = bytearray()
    for i in range(4):  # 4 lanes = 32 bytes
        out += a[i % 5][i // 5].to_bytes(8, "little")
    return bytes(out)


# ---------------------------------------------------------------------------
# Precompiles (EIP-196/197 semantics; failure = (False, b""))
# ---------------------------------------------------------------------------


def _word(data: bytes, i: int) -> int:
    chunk = data[32 * i : 32 * i + 32]
    return int.from_bytes(chunk.ljust(32, b"\x00"), "big")


def _g1_from_words(x: int, y: int):
    if x >= Q or y >= Q:
        raise ValueError("coordinate >= field modulus")
    if x == 0 and y == 0:
        return None
    p = (x, y)
    if not rc.G1.is_on_curve(p):
        raise ValueError("not on curve")
    return p


def _pre_ecadd(data: bytes) -> Tuple[bool, bytes]:
    try:
        p1 = _g1_from_words(_word(data, 0), _word(data, 1))
        p2 = _g1_from_words(_word(data, 2), _word(data, 3))
    except ValueError:
        return False, b""
    r = rc.G1.add(p1, p2)
    x, y = r if r is not None else (0, 0)
    return True, x.to_bytes(32, "big") + y.to_bytes(32, "big")


def _pre_ecmul(data: bytes) -> Tuple[bool, bytes]:
    try:
        p = _g1_from_words(_word(data, 0), _word(data, 1))
    except ValueError:
        return False, b""
    k = _word(data, 2)  # NOT reduced requirement: any u256 scalar is valid
    r = rc.G1.mul(p, k) if p is not None else None
    x, y = r if r is not None else (0, 0)
    return True, x.to_bytes(32, "big") + y.to_bytes(32, "big")


def _pre_ecpairing(data: bytes) -> Tuple[bool, bytes]:
    from .refmath import pairing as rp

    if len(data) % 192 != 0:
        return False, b""
    pairs = []
    for i in range(len(data) // 192):
        base = 6 * i
        ax, ay = _word(data, base), _word(data, base + 1)
        # G2 words: x_imag(c1), x_real(c0), y_imag(c1), y_real(c0)
        bx1, bx0 = _word(data, base + 2), _word(data, base + 3)
        by1, by0 = _word(data, base + 4), _word(data, base + 5)
        try:
            g1 = _g1_from_words(ax, ay)
        except ValueError:
            return False, b""
        if any(v >= Q for v in (bx0, bx1, by0, by1)):
            return False, b""
        if bx0 == bx1 == by0 == by1 == 0:
            g2 = None
        else:
            g2 = ((bx0, bx1), (by0, by1))
            if not rc.G2.is_on_curve(g2):
                return False, b""
            if rc.G2.mul(g2, R_SCALAR) is not None:  # r-order subgroup check
                return False, b""
        if g1 is None or g2 is None:
            continue  # e(O, Q) = e(P, O) = 1
        pairs.append((g1, g2))
    ok = rp.multi_pairing(pairs) == rp.FQ12.one() if pairs else True
    return True, int(ok).to_bytes(32, "big")


def _pre_identity(data: bytes) -> Tuple[bool, bytes]:
    return True, data


def _pre_sha256(data: bytes) -> Tuple[bool, bytes]:
    return True, hashlib.sha256(data).digest()


PRECOMPILES = {
    2: _pre_sha256,
    4: _pre_identity,
    6: _pre_ecadd,
    7: _pre_ecmul,
    8: _pre_ecpairing,
}


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------


class EVMError(Exception):
    pass


def _to_signed(v: int) -> int:
    return v - U256 if v & SIGN_BIT else v


class MiniEVM:
    """Executes one call frame (plus precompile sub-calls). No gas."""

    def __init__(self, code: bytes, storage: Optional[Dict[int, int]] = None):
        self.code = code
        self.storage = storage if storage is not None else {}
        self.jumpdests = self._scan_jumpdests(code)

    @staticmethod
    def _scan_jumpdests(code: bytes):
        dests, i = set(), 0
        while i < len(code):
            op = code[i]
            if op == 0x5B:
                dests.add(i)
            if 0x60 <= op <= 0x7F:
                i += op - 0x5F
            i += 1
        return dests

    def call(self, calldata: bytes, caller: int = 0xBEEF) -> Tuple[bool, bytes]:
        """Returns (success, returndata); success=False means REVERT/invalid."""
        stack: list = []
        mem = bytearray()
        returndata = b""
        pc = 0
        code = self.code

        def push(v):
            if len(stack) >= 1024:
                raise EVMError("stack overflow")
            stack.append(v & MASK)

        def pop():
            return stack.pop()

        def mgrow(off, size):
            if size == 0:
                return
            end = off + size
            if end > len(mem):
                mem.extend(b"\x00" * (((end + 31) // 32) * 32 - len(mem)))

        def mread(off, size):
            mgrow(off, size)
            return bytes(mem[off : off + size])

        def mwrite(off, data):
            mgrow(off, len(data))
            mem[off : off + len(data)] = data

        while pc < len(code):
            op = code[pc]
            pc += 1
            if 0x60 <= op <= 0x7F:  # PUSH1..PUSH32
                n = op - 0x5F
                push(int.from_bytes(code[pc : pc + n], "big"))
                pc += n
            elif 0x80 <= op <= 0x8F:  # DUP
                push(stack[-(op - 0x7F)])
            elif 0x90 <= op <= 0x9F:  # SWAP
                n = op - 0x8F
                stack[-1], stack[-1 - n] = stack[-1 - n], stack[-1]
            elif op == 0x00:  # STOP
                return True, b""
            elif op == 0x01:
                push(pop() + pop())
            elif op == 0x02:
                push(pop() * pop())
            elif op == 0x03:
                a, b = pop(), pop()
                push(a - b)
            elif op == 0x04:
                a, b = pop(), pop()
                push(a // b if b else 0)
            elif op == 0x05:  # SDIV
                a, b = _to_signed(pop()), _to_signed(pop())
                if b == 0:
                    push(0)
                else:
                    q = abs(a) // abs(b)
                    push(-q if (a < 0) != (b < 0) else q)
            elif op == 0x06:
                a, b = pop(), pop()
                push(a % b if b else 0)
            elif op == 0x07:  # SMOD
                a, b = _to_signed(pop()), _to_signed(pop())
                if b == 0:
                    push(0)
                else:
                    r = abs(a) % abs(b)
                    push(-r if a < 0 else r)
            elif op == 0x08:  # ADDMOD
                a, b, n = pop(), pop(), pop()
                push((a + b) % n if n else 0)
            elif op == 0x09:  # MULMOD
                a, b, n = pop(), pop(), pop()
                push((a * b) % n if n else 0)
            elif op == 0x0A:  # EXP
                a, b = pop(), pop()
                push(pow(a, b, U256))
            elif op == 0x0B:  # SIGNEXTEND
                k, v = pop(), pop()
                if k < 31:
                    bit = 8 * (k + 1) - 1
                    if v & (1 << bit):
                        v |= MASK ^ ((1 << (bit + 1)) - 1)
                    else:
                        v &= (1 << (bit + 1)) - 1
                push(v)
            elif op == 0x10:  # LT
                a, b = pop(), pop()
                push(int(a < b))
            elif op == 0x11:  # GT
                a, b = pop(), pop()
                push(int(a > b))
            elif op == 0x12:  # SLT
                a, b = _to_signed(pop()), _to_signed(pop())
                push(int(a < b))
            elif op == 0x13:  # SGT
                a, b = _to_signed(pop()), _to_signed(pop())
                push(int(a > b))
            elif op == 0x14:  # EQ
                push(int(pop() == pop()))
            elif op == 0x15:  # ISZERO
                push(int(pop() == 0))
            elif op == 0x16:
                push(pop() & pop())
            elif op == 0x17:
                push(pop() | pop())
            elif op == 0x18:
                push(pop() ^ pop())
            elif op == 0x19:
                push(MASK ^ pop())
            elif op == 0x1A:  # BYTE
                i, v = pop(), pop()
                push((v >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
            elif op == 0x1B:  # SHL
                s, v = pop(), pop()
                push(v << s if s < 256 else 0)
            elif op == 0x1C:  # SHR
                s, v = pop(), pop()
                push(v >> s if s < 256 else 0)
            elif op == 0x1D:  # SAR
                s, v = pop(), _to_signed(pop())
                push((v >> s if s < 256 else (-1 if v < 0 else 0)))
            elif op == 0x20:  # SHA3
                off, size = pop(), pop()
                push(int.from_bytes(keccak256(mread(off, size)), "big"))
            elif op == 0x30:  # ADDRESS
                push(0xC0FFEE)
            elif op == 0x33:  # CALLER
                push(caller)
            elif op == 0x34:  # CALLVALUE
                push(0)
            elif op == 0x35:  # CALLDATALOAD
                off = pop()
                push(int.from_bytes(calldata[off : off + 32].ljust(32, b"\x00"), "big"))
            elif op == 0x36:  # CALLDATASIZE
                push(len(calldata))
            elif op == 0x37:  # CALLDATACOPY
                doff, soff, size = pop(), pop(), pop()
                mwrite(doff, calldata[soff : soff + size].ljust(size, b"\x00"))
            elif op == 0x38:  # CODESIZE
                push(len(code))
            elif op == 0x39:  # CODECOPY
                doff, soff, size = pop(), pop(), pop()
                mwrite(doff, code[soff : soff + size].ljust(size, b"\x00"))
            elif op == 0x3A:  # GASPRICE
                push(0)
            elif op == 0x3D:  # RETURNDATASIZE
                push(len(returndata))
            elif op == 0x3E:  # RETURNDATACOPY
                doff, soff, size = pop(), pop(), pop()
                if soff + size > len(returndata):
                    raise EVMError("returndatacopy out of bounds")
                mwrite(doff, returndata[soff : soff + size])
            elif op in (0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48):
                push(0)  # block context: irrelevant for a pure verifier
            elif op == 0x50:  # POP
                pop()
            elif op == 0x51:  # MLOAD
                push(int.from_bytes(mread(pop(), 32), "big"))
            elif op == 0x52:  # MSTORE
                off, v = pop(), pop()
                mwrite(off, v.to_bytes(32, "big"))
            elif op == 0x53:  # MSTORE8
                off, v = pop(), pop()
                mwrite(off, bytes([v & 0xFF]))
            elif op == 0x54:  # SLOAD
                push(self.storage.get(pop(), 0))
            elif op == 0x55:  # SSTORE
                k, v = pop(), pop()
                self.storage[k] = v
            elif op == 0x56:  # JUMP
                dest = pop()
                if dest not in self.jumpdests:
                    raise EVMError(f"bad jump dest {dest}")
                pc = dest
            elif op == 0x57:  # JUMPI
                dest, cond = pop(), pop()
                if cond:
                    if dest not in self.jumpdests:
                        raise EVMError(f"bad jump dest {dest}")
                    pc = dest
            elif op == 0x58:  # PC
                push(pc - 1)
            elif op == 0x59:  # MSIZE
                push(len(mem))
            elif op == 0x5A:  # GAS
                push(10**15)
            elif op == 0x5B:  # JUMPDEST
                pass
            elif 0xA0 <= op <= 0xA4:  # LOG0..LOG4
                off, size = pop(), pop()
                for _ in range(op - 0xA0):
                    pop()
                mread(off, size)
            elif op in (0xF1, 0xFA):  # CALL / STATICCALL
                pop()  # gas
                addr = pop()
                if op == 0xF1:
                    value = pop()
                    if value:
                        raise EVMError("value transfer unsupported")
                aoff, asize, roff, rsize = pop(), pop(), pop(), pop()
                args = mread(aoff, asize)
                fn = PRECOMPILES.get(addr)
                if fn is None:
                    returndata = b""
                    push(0)  # unknown target: behave as failed call
                else:
                    ok, out = fn(args)
                    returndata = out
                    if ok:
                        mwrite(roff, out[:rsize].ljust(min(rsize, len(out)), b"\x00"))
                    push(int(ok))
            elif op == 0xF3:  # RETURN
                off, size = pop(), pop()
                return True, mread(off, size)
            elif op == 0xFD:  # REVERT
                off, size = pop(), pop()
                return False, mread(off, size)
            elif op == 0xFE:  # INVALID
                return False, b""
            else:
                raise EVMError(f"unimplemented opcode 0x{op:02x} at {pc - 1}")
        return True, b""


# ---------------------------------------------------------------------------
# ABI helpers for TestVerifier.verify (reference: tests/verifier.sol:20-37)
# ---------------------------------------------------------------------------

VERIFY_SELECTOR = bytes.fromhex("9416c1ee")


def _w(v: int) -> bytes:
    return int(v).to_bytes(32, "big")


def encode_verify_calldata(inputs, proof, vk) -> bytes:
    """ABI-encode TestVerifier.verify(uint256[] input, Proof proof,
    VerifyingKey vk) from our ethereum-layer types (ethereum.Inputs /
    Proof / VerifyingKey — reference: src/ethereum.rs:10,98,131)."""
    input_words = list(inputs.elements) if hasattr(inputs, "elements") else list(inputs)
    (ax, ay), ((bx1, bx0), (by1, by0)), (cx, cy) = proof.as_tuple()
    vk_t = vk.as_tuple()  # (alpha1, beta2, gamma2, delta2, ic_list)
    (vax, vay), vb, vg, vd, ic = vk_t

    # head: ptr(input) | proof 8 words inline | ptr(vk)
    proof_words = [ax, ay, bx1, bx0, by1, by0, cx, cy]
    head_size = 32 + 32 * len(proof_words) + 32

    input_tail = _w(len(input_words)) + b"".join(_w(v) for v in input_words)

    # vk tuple: alfa1(2) beta2(4) gamma2(4) delta2(4) ptr_IC(1) | IC tail
    vk_head_words = [vax, vay, *vb[0], *vb[1], *vg[0], *vg[1], *vd[0], *vd[1]]
    ic_tail = _w(len(ic)) + b"".join(_w(x) + _w(y) for (x, y) in ic)
    vk_blob = (
        b"".join(_w(v) for v in vk_head_words) + _w(32 * 15) + ic_tail
    )

    body = (
        _w(head_size)  # offset of input[]
        + b"".join(_w(v) for v in proof_words)
        + _w(head_size + len(input_tail))  # offset of vk
        + input_tail
        + vk_blob
    )
    return VERIFY_SELECTOR + body


def load_verifier(artifact_path: str) -> MiniEVM:
    """MiniEVM over the deployed TestVerifier bytecode from a solc/hardhat
    artifact (reference: tests/verifier_artifact.json)."""
    import json

    art = json.load(open(artifact_path))
    obj = art["deployedBytecode"]["object"]
    return MiniEVM(bytes.fromhex(obj[2:] if obj.startswith("0x") else obj))


def check_proof_onchain(verifier: MiniEVM, inputs, proof, vk) -> bool:
    """Run Verifier.verify on the EVM; True iff it returns ABI-true.
    Reverts (bad input lengths, out-of-field values) raise EVMError with
    the decoded Solidity Error(string) message when present."""
    ok, ret = verifier.call(encode_verify_calldata(inputs, proof, vk))
    if not ok:
        msg = ""
        if ret[:4] == keccak256(b"Error(string)")[:4] and len(ret) >= 68:
            slen = int.from_bytes(ret[36:68], "big")
            msg = ret[68 : 68 + slen].decode("utf-8", "replace")
        raise EVMError(f"revert: {msg or ret.hex()}")
    return bool(int.from_bytes(ret, "big"))
