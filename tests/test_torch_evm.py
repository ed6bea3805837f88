"""circom_compat_tpu_torch's in-process EVM (evm.py) against the JAX package's:
  - keccak256 on the known vectors and on seeded inputs of every length
    around the 136-byte rate;
  - the precompiles (sha256 0x02, identity 0x04, ecAdd 0x06, ecMul 0x07,
    ecPairing 0x08): tests/test_solidity.py's identities, and the same
    success flag and output bytes as the JAX package's on valid and invalid
    inputs, ecPairing on the Groth16 equation of the chain254 golden proof
    as the verifier contract feeds it (true; false when A is not negated);
  - encode_verify_calldata on that proof, byte for byte;
  - MiniEVM.call on programs assembled here (asm): arithmetic and
    comparisons, memory and calldata, jumps and a loop, a STATICCALL to
    each precompile, a revert with Error(string), INVALID and a bad jump:
    the same (success, return bytes) or the same EVMError;
  - check_proof_onchain over assembled stand-ins of the verifier contract
    (return true, return false, revert with a message).
The reference's compiled verifier (verifier_artifact.json) is not in the
repository, so the Solidity contract itself is not run. Inputs are fixed
or drawn from a numpy seed. Tolerance: exact equality of bytes.
"""

import hashlib
import json

import numpy as np
import pytest

from circom_compat_tpu import evm as jevm
from circom_compat_tpu_torch import ethereum as eth
from circom_compat_tpu_torch import evm
from circom_compat_tpu_torch.circom.zkey import read_zkey
from circom_compat_tpu_torch.constants import Q, R_SCALAR
from circom_compat_tpu_torch.refmath import curve as rc
from circom_compat_tpu_torch.utils.chain import chain_circuit
from test_torch_groth16 import GOLDEN, _golden

RNG = np.random.default_rng(0xE7)
ZKEY = GOLDEN / "chain254.zkey"

OPCODES = {
    "STOP": 0x00, "ADD": 0x01, "MUL": 0x02, "SUB": 0x03, "DIV": 0x04, "SDIV": 0x05,
    "MOD": 0x06, "SMOD": 0x07, "ADDMOD": 0x08, "MULMOD": 0x09, "EXP": 0x0A,
    "SIGNEXTEND": 0x0B, "LT": 0x10, "GT": 0x11, "SLT": 0x12, "SGT": 0x13, "EQ": 0x14,
    "ISZERO": 0x15, "AND": 0x16, "OR": 0x17, "XOR": 0x18, "NOT": 0x19, "BYTE": 0x1A,
    "SHL": 0x1B, "SHR": 0x1C, "SAR": 0x1D, "SHA3": 0x20, "ADDRESS": 0x30, "CALLER": 0x33,
    "CALLVALUE": 0x34, "CALLDATALOAD": 0x35, "CALLDATASIZE": 0x36, "CALLDATACOPY": 0x37,
    "CODESIZE": 0x38, "CODECOPY": 0x39, "GASPRICE": 0x3A, "RETURNDATASIZE": 0x3D,
    "RETURNDATACOPY": 0x3E, "TIMESTAMP": 0x42, "POP": 0x50, "MLOAD": 0x51, "MSTORE": 0x52,
    "MSTORE8": 0x53, "SLOAD": 0x54, "SSTORE": 0x55, "JUMP": 0x56, "JUMPI": 0x57, "PC": 0x58,
    "MSIZE": 0x59, "GAS": 0x5A, "JUMPDEST": 0x5B, "DUP1": 0x80, "DUP2": 0x81, "SWAP1": 0x90,
    "LOG1": 0xA1, "CALL": 0xF1, "RETURN": 0xF3, "STATICCALL": 0xFA, "REVERT": 0xFD,
    "INVALID": 0xFE,
}


def asm(*prog) -> bytes:
    """EVM bytecode from opcode names, ints (pushed with the fewest bytes),
    ("label", name) jump destinations and ("ref", name) pushes of a
    label's offset (always PUSH2)."""
    def size(item):
        if isinstance(item, str):
            return 1
        if isinstance(item, int):
            return 2 + max(0, (item.bit_length() - 1) // 8)
        return 1 if item[0] == "label" else 3

    labels, pos = {}, 0
    for item in prog:
        if isinstance(item, tuple) and item[0] == "label":
            labels[item[1]] = pos
        pos += size(item)
    out = bytearray()
    for item in prog:
        if isinstance(item, str):
            out.append(OPCODES[item])
        elif isinstance(item, int):
            n = size(item) - 1
            out += bytes([0x5F + n]) + item.to_bytes(n, "big")
        elif item[0] == "label":
            out.append(OPCODES["JUMPDEST"])
        else:
            out += bytes([0x61]) + labels[item[1]].to_bytes(2, "big")
    return bytes(out)


def ret(off, size):
    return (size, off, "RETURN")


def run_both(code, calldata=b""):
    """(success, return bytes) of both packages' MiniEVM, or the message
    of the EVMError both raised."""
    out = []
    for mod in (evm, jevm):
        try:
            out.append(mod.MiniEVM(code).call(calldata))
        except mod.EVMError as exc:
            out.append(("EVMError", str(exc)))
    assert out[0] == out[1]
    return out[0]


def test_keccak256_vectors():
    assert evm.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert evm.keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")
    assert evm.keccak256(b"a" * 200) == evm.keccak256(bytes([97]) * 200)
    for n in (1, 31, 32, 135, 136, 137, 271, 272, 300):
        data = RNG.bytes(n)
        assert evm.keccak256(data) == jevm.keccak256(data)


def _words(*vals) -> bytes:
    return b"".join(int(v).to_bytes(32, "big") for v in vals)


def test_precompile_ecadd_ecmul_identities():
    """tests/test_solidity.py's identities on the port's precompiles."""
    g = (1, 2)
    ok, out = evm._pre_ecadd(_words(*g, 0, 0))
    assert ok and int.from_bytes(out[:32], "big") == 1
    ok1, dbl = evm._pre_ecadd(_words(*g, *g))
    ok2, mul = evm._pre_ecmul(_words(*g, 2))
    assert ok1 and ok2 and dbl == mul
    assert not evm._pre_ecadd(_words(1, 3, 0, 0))[0]


def _g2_words(p):
    (x0, x1), (y0, y1) = p
    return (x1, x0, y1, y0)


def pairing_input(proof, vk, public) -> bytes:
    """The ecPairing input the Groth16 verifier contract builds:
    e(-A, B) e(alpha, beta) e(vk_x, gamma) e(C, delta), vk_x = IC_0 +
    sum_i public_i IC_(i+1)."""
    vk_x = vk.gamma_abc_g1[0]
    for x, ic in zip(public, vk.gamma_abc_g1[1:]):
        vk_x = rc.G1.add(vk_x, rc.G1.mul(ic, x))
    pairs = [(rc.G1.neg(proof.a), proof.b), (vk.alpha_g1, vk.beta_g2), (vk_x, vk.gamma_g2),
             (proof.c, vk.delta_g2)]
    return b"".join(_words(*p1, *_g2_words(p2)) for p1, p2 in pairs)


def _chain254():
    pk, _ = read_zkey(ZKEY)
    return pk.vk, _golden()[1], chain_circuit(k=254, a=3).get_public_inputs()


def test_precompiles_match_jax():
    vk, proof, public = _chain254()
    good = pairing_input(proof, vk, public)
    p = rc.G1.mul(rc.g1_generator(), 0xABC)
    cases = {
        2: [b"", b"abc", RNG.bytes(200)],
        4: [b"", RNG.bytes(77)],
        6: [_words(*p, *p), _words(*p, 0, 0), _words(*p, *rc.G1.neg(p)), _words(1, 3, 0, 0),
            _words(Q, 0, 0, 0), _words(*p)],
        7: [_words(*p, 0), _words(*p, R_SCALAR), _words(*p, (1 << 256) - 1), _words(0, 0, 5),
            _words(1, 3, 5)],
        8: [b"", good, good[:192], good[:-1], good[:96] + _words(0, 0, 0, 0) + good[192:],
            good[:64] + _words(Q, 0, 0, 0) + good[192:], good[:64] + _words(1, 0, 2, 0)
            + good[192:]],
    }
    for addr, inputs in cases.items():
        for data in inputs:
            assert evm.PRECOMPILES[addr](data) == jevm.PRECOMPILES[addr](data), (addr, data[:8])
    assert evm._pre_ecpairing(good) == (True, _words(1))
    assert evm._pre_sha256(b"abc")[1] == hashlib.sha256(b"abc").digest()


def test_groth16_pairing_and_calldata_match_jax():
    """The chain254 golden proof through ecPairing as the verifier contract
    feeds it, and TestVerifier.verify's calldata."""
    vk, proof, public = _chain254()
    data = pairing_input(proof, vk, public)
    assert evm._pre_ecpairing(data) == jevm._pre_ecpairing(data) == (True, _words(1))
    bad = pairing_input(type(proof)(a=rc.G1.neg(proof.a), b=proof.b, c=proof.c), vk, public)
    assert evm._pre_ecpairing(bad) == jevm._pre_ecpairing(bad) == (True, _words(0))
    wrong_input = pairing_input(proof, vk, [(public[0] + 1) % R_SCALAR])
    assert evm._pre_ecpairing(wrong_input) == (True, _words(0))

    from circom_compat_tpu import ethereum as jeth
    from circom_compat_tpu.circom.zkey import read_zkey as jax_read_zkey
    from circom_compat_tpu.models.groth16 import Proof as JaxProof

    jvk = jax_read_zkey(ZKEY)[0].vk
    got = evm.encode_verify_calldata(eth.Inputs.from_fr(public), eth.Proof.from_ark(proof),
                                     eth.VerifyingKey.from_ark(vk))
    want = jevm.encode_verify_calldata(jeth.Inputs.from_fr(public),
                                       jeth.Proof.from_ark(JaxProof(proof.a, proof.b, proof.c)),
                                       jeth.VerifyingKey.from_ark(jvk))
    assert got == want and got[:4] == evm.VERIFY_SELECTOR


def _binary_program(cases):
    """Each (op, a, b[, n]) computed and stored at 32-byte slots, then all
    slots returned."""
    prog = []
    for i, (op, *args) in enumerate(cases):
        prog += [*reversed(args), op, 32 * i, "MSTORE"]
    return asm(*prog, *ret(0, 32 * len(cases)))


BIG = (1 << 256) - 1
NEG7 = (1 << 256) - 7


def test_arithmetic_programs_match_jax():
    vals = [0, 1, 2, 7, 31, 255, 256, NEG7, BIG, 1 << 255, Q, R_SCALAR,
            int.from_bytes(RNG.bytes(32), "big")]
    binary = ["ADD", "MUL", "SUB", "DIV", "SDIV", "MOD", "SMOD", "EXP", "SIGNEXTEND", "LT",
              "GT", "SLT", "SGT", "EQ", "AND", "OR", "XOR", "BYTE", "SHL", "SHR", "SAR"]
    for op in binary:
        cases = [(op, a, b) for a in vals for b in vals[:8] + vals[-3:]]
        ok, out = run_both(_binary_program(cases))
        assert ok and len(out) == 32 * len(cases)
    for op in ("ADDMOD", "MULMOD"):
        cases = [(op, a, b, n) for a in vals[:8] for b in vals[-4:] for n in (0, 7, Q, BIG)]
        assert run_both(_binary_program(cases))[0]
    unary = asm(*[x for i, v in enumerate(vals) for x in (v, "ISZERO", v, "NOT", "ADD",
                                                           32 * i, "MSTORE")],
                *ret(0, 32 * len(vals)))
    assert run_both(unary)[0]
    ok, out = run_both(_binary_program([("SUB", 10, 3), ("SDIV", NEG7, 2), ("SMOD", NEG7, 3)]))
    assert out == _words(7, (1 << 256) - 3, (1 << 256) - 1)


def test_memory_and_calldata_programs_match_jax():
    calldata = RNG.bytes(100)
    code = asm(
        0, "CALLDATALOAD", 0, "MSTORE",           # word 0 of calldata
        90, "CALLDATALOAD", 32, "MSTORE",         # a word read past the end
        "CALLDATASIZE", 64, "MSTORE",
        50, 3, 96, "CALLDATACOPY",                # calldata[3:53] at 96
        0xAB, 200, "MSTORE8",
        7, 5, 230, "CODECOPY",                    # code[5:12] at 230
        "CODESIZE", 256, "MSTORE",
        32, 0, "SHA3", 288, "MSTORE",
        96, "MLOAD", 320, "MSTORE",
        "MSIZE", 352, "MSTORE",
        "PC", "GAS", "ADDRESS", "CALLER", "CALLVALUE", "GASPRICE", "TIMESTAMP",
        "ADD", "ADD", "ADD", "ADD", "ADD", "POP", "POP",
        5, 9, "SSTORE", 9, "SLOAD", 384, "MSTORE",
        7, 416, 0, "LOG1",
        *ret(0, 416),
    )
    ok, out = run_both(code, calldata)
    assert ok and out[:32] == calldata[:32] and out[96:146] == calldata[3:53]


def test_jump_programs_match_jax():
    # sum 1..10 in a loop: i at slot 0, acc at slot 32
    loop = asm(10, 0, "MSTORE", 0, 32, "MSTORE",
               ("label", "top"),
               0, "MLOAD", "ISZERO", ("ref", "end"), "JUMPI",
               0, "MLOAD", 32, "MLOAD", "ADD", 32, "MSTORE",
               1, 0, "MLOAD", "SUB", 0, "MSTORE",
               ("ref", "top"), "JUMP",
               ("label", "end"), *ret(32, 32))
    assert run_both(loop) == (True, _words(55))
    assert run_both(asm(1, "JUMP"))[0] == "EVMError"
    assert run_both(asm(1, 3, "JUMPI"))[0] == "EVMError"
    assert run_both(asm(0, 3, "JUMPI", "STOP")) == (True, b"")
    assert run_both(asm("INVALID")) == (False, b"")
    assert run_both(bytes([0x0C]))[0] == "EVMError"  # an unimplemented opcode


def _call_program(addr, op="STATICCALL", out_size=64):
    """Calldata to memory, one call to addr, then (flag, returndatasize,
    the output region) returned."""
    value = (0,) if op == "CALL" else ()
    return asm("CALLDATASIZE", 0, 0, "CALLDATACOPY",
               out_size, 1024, "CALLDATASIZE", 0, *value, addr, 100000, op,
               2048, "MSTORE", "RETURNDATASIZE", 2080, "MSTORE",
               "RETURNDATASIZE", 0, 2112, "RETURNDATACOPY",
               2048, "MLOAD", 4096, "MSTORE", 1024, "MLOAD", 4128, "MSTORE",
               *ret(2048, 64 + out_size))


def test_precompile_calls_match_jax():
    vk, proof, public = _chain254()
    p = rc.G1.mul(rc.g1_generator(), 99)
    calls = [(2, b"abc"), (4, RNG.bytes(40)), (6, _words(*p, *p)), (6, _words(1, 3, 0, 0)),
             (7, _words(*p, 12345)), (8, pairing_input(proof, vk, public)), (8, b"\x01"),
             (9, b"")]
    for addr, data in calls:
        for op in ("STATICCALL", "CALL"):
            ok, out = run_both(_call_program(addr, op), data)
            assert ok
            if addr == 8 and len(data) == 6 * 32 * 4:
                assert out[:32] == _words(1) and out[64:96] == _words(1)


def _revert_code(msg: str) -> bytes:
    data = (bytes.fromhex("08c379a0") + _words(32, len(msg))
            + msg.encode().ljust(-(-len(msg) // 32) * 32, b"\0"))
    prog = []
    for i in range(0, len(data), 32):
        prog += [int.from_bytes(data[i : i + 32].ljust(32, b"\0"), "big"), i, "MSTORE"]
    return asm(*prog, len(data), 0, "REVERT")


def test_revert_and_onchain_checks_match_jax():
    msg = "verifier-bad-input"
    code = _revert_code(msg)
    ok, out = run_both(code)
    assert not ok and out[:4] == evm.keccak256(b"Error(string)")[:4]
    vk, proof, public = _chain254()
    args = (eth.Inputs.from_fr(public), eth.Proof.from_ark(proof), eth.VerifyingKey.from_ark(vk))
    with pytest.raises(evm.EVMError, match=f"revert: {msg}"):
        evm.check_proof_onchain(evm.MiniEVM(code), *args)
    assert evm.check_proof_onchain(evm.MiniEVM(asm(1, 0, "MSTORE", *ret(0, 32))), *args)
    assert not evm.check_proof_onchain(evm.MiniEVM(asm(*ret(0, 32))), *args)
    with pytest.raises(evm.EVMError, match="revert: 00"):
        evm.check_proof_onchain(evm.MiniEVM(asm(0, 0, "MSTORE8", 1, 0, "REVERT")), *args)


def test_load_verifier(tmp_path):
    code = asm(1, 0, "MSTORE", *ret(0, 32))
    path = tmp_path / "artifact.json"
    for prefix in ("0x", ""):
        path.write_text(json.dumps({"deployedBytecode": {"object": prefix + code.hex()}}))
        assert evm.load_verifier(str(path)).code == jevm.load_verifier(str(path)).code == code
    with pytest.raises(FileNotFoundError):
        evm.load_verifier(str(tmp_path / "absent.json"))
