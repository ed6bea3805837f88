"""circom_compat_tpu_torch Groth16 prover on the CPU against the JAX package.

  - chain254 proved with device="cpu" (every kernel wrapper on its plain
    version) equals tests/golden/chain254_proof.json byte for byte and
    verifies, once with the key read from tests/golden/chain254.zkey and once
    with the JAX package's generate_parameters key carried across by
    convert.proving_key_from_numpy;
  - the fixture zkey is exactly what the JAX package writes for that key;
  - no file of the port (or chip_smoke.py) imports jax or circom_compat_tpu;
  - with no card, the default device raises and names the device argument.
The byte-exact comparison with groth16_jax.prove costs minutes of XLA build
here and rides the slow tier.
"""

import ast
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from circom_compat_tpu.circom.zkey_writer import write_zkey
from circom_compat_tpu.models import generate_parameters
from circom_compat_tpu.utils.chain import chain_circuit as jax_chain_circuit
from circom_compat_tpu_torch import convert
from circom_compat_tpu_torch.circom.zkey import read_zkey
from circom_compat_tpu_torch.constants import R_SCALAR
from circom_compat_tpu_torch.models import groth16_device as gd
from circom_compat_tpu_torch.models.groth16 import Groth16, Proof
from circom_compat_tpu_torch.ops import field_kernels as fk
from circom_compat_tpu_torch.ops import limbs as tl
from circom_compat_tpu_torch.utils.chain import chain_circuit

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
TOXIC = dict(alpha=0xA, beta=0xB, gamma=0xC, delta=0xD, t=0xE1)


def _golden():
    rec = json.loads((GOLDEN / "chain254_proof.json").read_text())
    p = rec["proof"]
    proof = Proof(a=tuple(int(v, 16) for v in p["a"]),
                  b=tuple(tuple(int(v, 16) for v in c) for c in p["b"]),
                  c=tuple(int(v, 16) for v in p["c"]))
    return rec, proof


@pytest.fixture(scope="module")
def jax_setup():
    circuit = jax_chain_circuit(k=254, a=3)
    pk = generate_parameters(circuit, **TOXIC)
    ma, mb, _ = circuit.to_matrices()
    return circuit, pk, ma, mb


def test_chain254_golden_from_fixture_zkey():
    rec, golden = _golden()
    pk, m = read_zkey(GOLDEN / "chain254.zkey")
    circuit = chain_circuit(k=254, a=3)
    proof = Groth16.create_proof_with_reduction_and_matrices(
        pk, rec["r"], rec["s"], m, m.num_instance_variables, m.num_constraints,
        circuit.full_assignment(), device="cpu")
    assert proof == golden
    assert Groth16.verify_proof(pk.vk, proof, circuit.get_public_inputs())
    bad = Proof(a=proof.a, b=proof.b, c=golden.a)
    assert not Groth16.verify_proof(pk.vk, bad, circuit.get_public_inputs())


def _coo(rows_list):
    rows, cols, vals = [], [], []
    for r, entries in enumerate(rows_list):
        for v, sig in entries:
            rows.append(r)
            cols.append(sig)
            vals.append(v % R_SCALAR * (1 << 256) % R_SCALAR)
    return np.array(rows), np.array(cols), tl.ints_to_limbs(vals, dtype=np.uint16)


def _numpy_dict(pk, ma, mb, num_inputs):
    """The JAX package's key and matrices as plain numpy arrays and ints."""
    d = dict(
        a_query=pk.a_query.limbs, b_g1_query=pk.b_g1_query.limbs,
        b_g2_query=pk.b_g2_query.limbs, l_query=pk.l_query.limbs, h_query=pk.h_query.limbs,
        alpha_g1=pk.vk.alpha_g1, beta_g1=pk.beta_g1, delta_g1=pk.delta_g1,
        beta_g2=pk.vk.beta_g2, gamma_g2=pk.vk.gamma_g2, delta_g2=pk.vk.delta_g2,
        gamma_abc_g1=pk.vk.gamma_abc_g1, n_vars=pk.n_vars, n_public=pk.n_public,
        domain_size=pk.domain_size, num_instance_variables=num_inputs,
        num_constraints=len(ma))
    for name, rows_list in (("a", ma), ("b", mb)):
        d[f"{name}_rows"], d[f"{name}_cols"], d[f"{name}_values_mont"] = _coo(rows_list)
    return d


def test_chain254_golden_from_converted_jax_key(jax_setup):
    """The JAX setup key, carried across; w = 5 also shows the proof does
    not depend on the window width."""
    circuit, pk, ma, mb = jax_setup
    d = _numpy_dict(pk, ma, mb, circuit.r1cs.num_inputs)
    tpk, tm = convert.proving_key_from_numpy(d), convert.matrices_from_numpy(d)
    rec, golden = _golden()
    dpk = gd.DeviceProvingKey.build(tpk, tm, len(ma), device="cpu")
    proof = gd.prove_prepared(dpk, rec["r"], rec["s"], circuit.full_assignment(), window_bits=5)
    assert proof == golden
    assert Groth16.verify_proof(tpk.vk, proof, circuit.get_public_inputs())


def test_convert_rejects_bad_shapes(jax_setup):
    circuit, pk, ma, mb = jax_setup
    d = _numpy_dict(pk, ma, mb, circuit.r1cs.num_inputs)
    with pytest.raises(ValueError, match="b_g2_query"):
        convert.proving_key_from_numpy({**d, "b_g2_query": pk.b_g1_query.limbs})
    with pytest.raises(ValueError, match="l_query"):
        convert.proving_key_from_numpy({**d, "l_query": pk.l_query.limbs[:-1]})
    with pytest.raises(ValueError, match="a:"):
        convert.matrices_from_numpy({**d, "a_cols": d["a_cols"][:-1]})


def test_fixture_zkey_is_the_jax_setup_key(jax_setup):
    circuit, pk, ma, mb = jax_setup
    buf = io.BytesIO()
    write_zkey(buf, pk, ma, mb, len(ma))
    assert buf.getvalue() == (GOLDEN / "chain254.zkey").read_bytes()


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((REPO / "circom_compat_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "circom_compat_tpu"), f"{path}: imports {name}"


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pk, m = read_zkey(GOLDEN / "chain254.zkey")
    with pytest.raises(RuntimeError, match="device"):
        gd.DeviceProvingKey.build(pk, m, m.num_constraints)
    with pytest.raises(RuntimeError, match="device"):
        Groth16.create_proof_with_reduction_and_matrices(
            pk, 1, 2, m, m.num_instance_variables, m.num_constraints,
            chain_circuit(k=254, a=3).full_assignment())
    assert gd.resolve_device("cpu") == torch.device("cpu")


def test_wrappers_check_their_operands():
    a = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        fk.fr_binary("mul", a, torch.zeros(4, 16, dtype=torch.int32))
    with pytest.raises(ValueError):
        fk.fr_binary("mul", a, a.to(torch.int64))
    with pytest.raises(ValueError):
        fk.fr_tile_scan(a.reshape(2, 2, 8), torch.zeros(2, 2, dtype=torch.int32))
    meta = a.to("meta")  # neither the CPU (plain version) nor CUDA (kernel)
    with pytest.raises(ValueError, match="CUDA"):
        fk.fr_binary("add", meta, meta)


@pytest.mark.slow
def test_chain254_matches_groth16_jax(jax_setup):
    """Byte-exact against the JAX device prover (its CPU build takes ~2 min)."""
    from circom_compat_tpu.models import groth16_jax

    circuit, pk, ma, mb = jax_setup
    d = _numpy_dict(pk, ma, mb, circuit.r1cs.num_inputs)
    r, s = 0x1234, 0x5678

    class _Rows:
        a = ma
        b = mb
        num_instance_variables = circuit.r1cs.num_inputs

    want = groth16_jax.prove(pk, r, s, _Rows, circuit.r1cs.num_inputs, len(ma),
                             circuit.full_assignment())
    got = gd.prove(convert.proving_key_from_numpy(d), r, s, convert.matrices_from_numpy(d),
                   circuit.r1cs.num_inputs, len(ma), circuit.full_assignment(), device="cpu")
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
