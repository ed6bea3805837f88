"""circom_compat_tpu_torch batch prover (models/batch.py) on the CPU: the
c = a * b circuit of test_torch_witness.mul_module, a dev-mode key from
its .r1cs (setup on the CPU), and prove_batch over two input sets with two
witness workers. Each proof verifies by pairing against its own public
output, in input order, and not against the other's; without a card the
default device raises. Tolerance: exact equality.
"""

import random

import pytest
import torch

from circom_compat_tpu_torch.circom.circuit import CircomCircuit
from circom_compat_tpu_torch.circom.r1cs import read_r1cs
from circom_compat_tpu_torch.circom.zkey_writer import write_zkey
from circom_compat_tpu_torch.models import generate_random_parameters
from circom_compat_tpu_torch.models.batch import BatchProver, prove_batch
from circom_compat_tpu_torch.models.groth16 import verify_proof
from test_torch_circom import mul_r1cs
from test_torch_witness import mul_module

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("batch")
    circuit = CircomCircuit(r1cs=read_r1cs(mul_r1cs()))
    pk = generate_random_parameters(circuit, rng=random.Random(3), device="cpu")
    ma, mb, _ = circuit.to_matrices()
    zkey, wasm = d / "mul.zkey", d / "mul.wasm"
    write_zkey(str(zkey), pk, ma, mb, len(ma))
    wasm.write_bytes(mul_module())
    return pk, zkey, wasm


def test_prove_batch_verifies_in_order(artifacts):
    pk, zkey, wasm = artifacts
    inputs = [{"a": 3, "b": 11}, {"a": 2**32 - 50, "b": 11}]
    results = prove_batch(zkey, wasm, inputs, rs=[(5, 6), (7, 8)], workers=2, window_bits=4,
                          device="cpu")
    assert [r.public_inputs for r in results] == [[33], [(2**32 - 50) * 11]]
    for i, res in enumerate(results):
        assert res.witness is None
        assert verify_proof(pk.vk, res.proof, res.public_inputs)
        assert not verify_proof(pk.vk, res.proof, results[1 - i].public_inputs)


def test_batch_prover_checks_its_arguments():
    dpk = type("Key", (), {"n_vars": 4, "domain_size": 4})()
    with pytest.raises(TypeError, match="path or bytes"):
        BatchProver(dpk, 42)
    bp = BatchProver(dpk, mul_module())
    assert bp.window_bits == 8
    with pytest.raises(ValueError, match="rs length"):
        bp.prove_many([{"a": 1, "b": 2}], rs=[])


def test_prove_batch_defaults_to_the_card(artifacts, monkeypatch):
    _, zkey, wasm = artifacts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        prove_batch(zkey, wasm, [{"a": 3, "b": 11}])
