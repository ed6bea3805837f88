"""The golden gate from inputs: utils/chain_wasm.chain_wasm(254) with
{"a": 3} through the AOT engine, proved on the CPU on
tests/golden/chain254.zkey at r = 77, s = 88, gives
tests/golden/chain254_proof.json byte for byte (its hex strings), and the
witness is utils/chain.chain_witness(254, 3). The CLI's `witness` on the
same module and inputs writes a .wtns equal byte for byte to
write_wtns(chain_witness(254, 3)) on every engine.
This file holds one CPU prove (~20-30 s, the plain bucket reduce).
Tolerance: exact equality.
"""

import json
import pathlib

import pytest
import torch

from circom_compat_tpu_torch.circom.wtns import write_wtns
from circom_compat_tpu_torch.circom.zkey import read_zkey
from circom_compat_tpu_torch.cli import main
from circom_compat_tpu_torch.models.groth16 import Groth16
from circom_compat_tpu_torch.utils.chain import chain_witness
from circom_compat_tpu_torch.utils.chain_wasm import chain_wasm
from circom_compat_tpu_torch.witness import WitnessCalculator

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def test_chain254_golden_from_inputs():
    rec = json.loads((GOLDEN / "chain254_proof.json").read_text())
    wc = WitnessCalculator(chain_wasm(254))
    assert wc.engine == "aot"
    witness = wc.calculate_witness({"a": 3})
    assert witness == chain_witness(254, 3)
    pk, m = read_zkey(GOLDEN / "chain254.zkey")
    proof = Groth16.create_proof_with_reduction_and_matrices(
        pk, rec["r"], rec["s"], m, m.num_instance_variables, m.num_constraints, witness,
        device="cpu")
    got = {"a": [hex(v) for v in proof.a], "b": [[hex(v) for v in c] for c in proof.b],
           "c": [hex(v) for v in proof.c]}
    assert json.dumps(got) == json.dumps(rec["proof"])
    assert Groth16.verify_proof(pk.vk, proof, witness[1 : m.num_instance_variables])


@pytest.mark.parametrize("engine", ["native", "aot", "interp"])
def test_cli_witness_writes_the_chain_wtns(tmp_path, capsys, engine):
    wasm, inputs = tmp_path / "chain.wasm", tmp_path / "input.json"
    wasm.write_bytes(chain_wasm(254))
    inputs.write_text(json.dumps({"a": 3}))
    out, want = tmp_path / "out.wtns", tmp_path / "want.wtns"
    assert main(["witness", str(wasm), str(inputs), str(out), "--engine", engine]) == 0
    assert capsys.readouterr().out == f"wrote 256 witness values to {out}\n"
    write_wtns(chain_witness(254, 3), want)
    assert out.read_bytes() == want.read_bytes()
