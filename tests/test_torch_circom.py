"""circom_compat_tpu_torch artifact layer (circom/r1cs, wtns, circuit,
builder) against the JAX package, on in-repo bytes:
  - read_r1cs / parse_r1cs_file on tests/test_r1cs.py's SAMPLE, field by
    field equal to the JAX reader, and the same R1CSParseError message for a
    bad magic, version, prime, map and a truncated file;
  - `r1cs_bytes`, an .r1cs writer for the tests, read back alike by both
    packages (the c = a * b circuit of test_torch_witness.mul_module);
  - a wtns written by each package read by the other, as ints and as limbs;
  - the squaring chain's CircomCircuit (utils/chain.py) equal to the JAX
    one: to_matrices, full_assignment, get_public_inputs, is_satisfied and
    which_is_unsatisfied on a broken witness; a wire-mapped circuit too;
  - CircomConfig / CircomBuilder on the assembled module and its .r1cs.
Tolerance: exact equality.
"""

import io
import struct

import numpy as np
import pytest

from circom_compat_tpu.circom import builder as jax_builder
from circom_compat_tpu.circom import r1cs as jax_r1cs
from circom_compat_tpu.circom import wtns as jax_wtns
from circom_compat_tpu.circom.circuit import CircomCircuit as JaxCircomCircuit
from circom_compat_tpu.utils.chain import chain_circuit as jax_chain_circuit
from circom_compat_tpu_torch.circom import r1cs as tr1cs
from circom_compat_tpu_torch.circom import wtns as twtns
from circom_compat_tpu_torch.circom.builder import CircomBuilder, CircomConfig
from circom_compat_tpu_torch.circom.circuit import CircomCircuit
from circom_compat_tpu_torch.constants import R_BYTES_LE, R_SCALAR
from circom_compat_tpu_torch.utils.chain import chain_circuit
from test_r1cs import SAMPLE
from test_torch_witness import mul_module

MUL_CONSTRAINTS = [([(2, 1)], [(3, 1)], [(1, 1)])]  # a * b = c over wires [1, c, a, b]


def r1cs_bytes(n_wires, n_pub_out, n_pub_in, n_prv_in, constraints, wire_map=None) -> bytes:
    """An .r1cs file (version 1; header, constraints, wire map)."""

    def lc(terms):
        return struct.pack("<I", len(terms)) + b"".join(
            struct.pack("<I", w) + (c % R_SCALAR).to_bytes(32, "little") for w, c in terms)

    header = (struct.pack("<I", 32) + R_BYTES_LE
              + struct.pack("<IIIIQI", n_wires, n_pub_out, n_pub_in, n_prv_in, n_wires,
                            len(constraints)))
    body = b"".join(lc(a) + lc(b) + lc(c) for a, b, c in constraints)
    wmap = b"".join(struct.pack("<Q", w) for w in (wire_map or range(n_wires)))
    out = b"r1cs" + struct.pack("<II", 1, 3)
    for sid, payload in ((1, header), (2, body), (3, wmap)):
        out += struct.pack("<IQ", sid, len(payload)) + payload
    return out


def mul_r1cs() -> bytes:
    return r1cs_bytes(4, 1, 0, 2, MUL_CONSTRAINTS)


def _fields(f):
    return (f.version, vars(f.header), f.constraints, f.wire_mapping)


@pytest.mark.parametrize("data", [SAMPLE, mul_r1cs()], ids=["sample", "mul"])
def test_read_r1cs_matches_jax(data, tmp_path):
    got = tr1cs.parse_r1cs_file(io.BytesIO(data))
    assert _fields(got) == _fields(jax_r1cs.parse_r1cs_file(io.BytesIO(data)))
    path = tmp_path / "c.r1cs"
    path.write_bytes(data)
    want = vars(jax_r1cs.read_r1cs(data))
    for src in (data, path, io.BytesIO(data)):
        assert vars(tr1cs.read_r1cs(src)) == want
    if data is SAMPLE:
        assert got.header.n_wires == 7 and got.constraints[0][0][0] == (5, 3)
        assert tr1cs.read_r1cs(data).num_inputs == 4


def _corrupt(kind):
    if kind == "magic":
        return b"nope" + SAMPLE[4:]
    if kind == "version":
        return SAMPLE[:4] + (2).to_bytes(4, "little") + SAMPLE[8:]
    if kind == "prime":
        i = SAMPLE.index(R_BYTES_LE)
        return SAMPLE[:i] + bytes([SAMPLE[i] ^ 1]) + SAMPLE[i + 1 :]
    if kind == "truncated":
        return SAMPLE[:200]
    if kind == "wire0":
        i = len(SAMPLE) - 7 * 8  # the map section's first entry
        return SAMPLE[:i] + struct.pack("<Q", 5) + SAMPLE[i + 8 :]
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["magic", "version", "prime", "truncated", "wire0"])
def test_r1cs_parse_errors_match_jax(kind):
    data = _corrupt(kind)
    with pytest.raises(jax_r1cs.R1CSParseError) as want:
        jax_r1cs.read_r1cs(data)
    with pytest.raises(tr1cs.R1CSParseError) as got:
        tr1cs.read_r1cs(data)
    assert str(got.value) == str(want.value)


def test_wtns_cross_read(tmp_path):
    rng = np.random.default_rng(0x3A1)
    values = [1, 0, R_SCALAR - 1] + [int.from_bytes(rng.bytes(32), "little") % R_SCALAR
                                     for _ in range(61)]
    tp, jp = tmp_path / "t.wtns", tmp_path / "j.wtns"
    twtns.write_wtns(values, tp)
    jax_wtns.write_wtns(values, jp)
    assert tp.read_bytes() == jp.read_bytes()
    assert twtns.read_wtns(jp) == jax_wtns.read_wtns(tp) == values
    got = twtns.read_wtns_limbs(jp)
    want = jax_wtns.read_wtns_limbs(tp)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    buf = io.BytesIO()
    twtns.write_wtns(values, buf)
    assert np.array_equal(twtns.read_wtns_limbs(buf.getvalue()), want)
    with pytest.raises(twtns.WtnsParseError, match="magic"):
        twtns.read_wtns(b"nope" + buf.getvalue()[4:])


def test_chain_circuit_matches_jax():
    c, jc = chain_circuit(k=30, a=5), jax_chain_circuit(k=30, a=5)
    assert isinstance(c, CircomCircuit)
    assert vars(c.r1cs) == vars(jc.r1cs)
    assert c.to_matrices() == jc.to_matrices()
    assert c.full_assignment() == jc.full_assignment()
    assert c.get_public_inputs() == jc.get_public_inputs()
    assert c.is_satisfied() and c.which_is_unsatisfied() is None
    for i in (3, 17, 31):
        c.witness[i] += 1
        jc.witness[i] += 1
        assert c.which_is_unsatisfied() == jc.which_is_unsatisfied() == i - 3
        c.witness[i] -= 1
        jc.witness[i] -= 1


def test_wire_mapped_circuit_matches_jax():
    witness = [1] + [7 * i + 3 for i in range(1, 400)]  # the map names labels up to 324
    c = CircomCircuit(r1cs=tr1cs.read_r1cs(SAMPLE), witness=list(witness))
    jc = JaxCircomCircuit(r1cs=jax_r1cs.read_r1cs(SAMPLE), witness=list(witness))
    assert c.get_public_inputs() == jc.get_public_inputs()
    assert c.full_assignment() == jc.full_assignment()
    assert c.to_matrices() == jc.to_matrices()
    assert c.which_is_unsatisfied() == jc.which_is_unsatisfied() == 0
    assert CircomCircuit(r1cs=c.r1cs).get_public_inputs() is None
    with pytest.raises(ValueError, match="no witness"):
        CircomCircuit(r1cs=c.r1cs).full_assignment()


def test_builder_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("CIRCOM_TPU_AOT", "0")
    monkeypatch.setenv("CIRCOM_TPU_NATIVE", "0")
    wasm, r1cs = tmp_path / "mul.wasm", tmp_path / "mul.r1cs"
    wasm.write_bytes(mul_module())
    r1cs.write_bytes(mul_r1cs())
    built = []
    for cfg_cls, b_cls in ((CircomConfig, CircomBuilder),
                           (jax_builder.CircomConfig, jax_builder.CircomBuilder)):
        b = b_cls(cfg_cls(wasm, r1cs))
        b.push_input("a", 3)
        b.push_input("b", 11)
        assert b.setup().witness is None
        built.append(b.build())
    c, jc = built
    assert c.witness == jc.witness == [1, 33, 3, 11]
    assert c.get_public_inputs() == jc.get_public_inputs() == [33]
    bad = CircomBuilder(CircomConfig.new(wasm, r1cs))
    bad.push_input("a", 2**32)  # beyond the module's 64-bit product
    bad.push_input("b", 2**32)
    with pytest.raises(ValueError, match="Unsatisfied constraint: 0"):
        bad.build()
