"""circom_compat_tpu_torch CLI (`python -m circom_compat_tpu_torch`) with
--device cpu, against the JAX package's CLI wherever the inputs are the same:
  - r1cs-info on tests/test_r1cs.py's SAMPLE and on the c = a * b circuit:
    the same lines;
  - prove -> verify -> export-vkey -> export-calldata on
    tests/golden/chain254.zkey: the proof verifies through both CLIs (a
    tampered public input returns 1), the vkey JSON and the calldata line
    equal the JAX CLI's, and the line is the ethereum.Proof tuple's;
  - witness on the assembled circom-2 module (test_torch_witness.mul_module):
    the same .wtns bytes as the JAX CLI's on its interpreter;
  - setup from a small .r1cs, then fullprove with the module, then verify;
  - without a card, prove's default device raises.
Tolerance: exact equality (file bytes, stdout lines, exit codes).
"""

import json
import pathlib

import pytest
import torch

from circom_compat_tpu.cli import main as jax_main
from circom_compat_tpu_torch import ethereum as eth
from circom_compat_tpu_torch.circom.wtns import read_wtns, write_wtns
from circom_compat_tpu_torch.cli import _proof_from_json, main
from circom_compat_tpu_torch.utils.chain import chain_circuit
from test_r1cs import SAMPLE
from test_torch_circom import mul_r1cs
from test_torch_witness import mul_module

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
ZKEY = str(pathlib.Path(__file__).resolve().parent / "golden" / "chain254.zkey")


def _out(capsys, fn, argv):
    capsys.readouterr()
    rc = fn(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("data", [SAMPLE, mul_r1cs()], ids=["sample", "mul"])
def test_r1cs_info_matches_jax(tmp_path, capsys, data):
    path = tmp_path / "c.r1cs"
    path.write_bytes(data)
    got = _out(capsys, main, ["r1cs-info", str(path)])
    assert got == _out(capsys, jax_main, ["r1cs-info", str(path)])
    assert got[0] == 0 and "# wires:" in got[1]


def test_prove_verify_export_chain254(tmp_path, capsys):
    p = {name: str(tmp_path / name) for name in
         ("w.wtns", "proof.json", "public.json", "vk.json", "jvk.json", "bad.json")}
    circuit = chain_circuit(k=254, a=3)
    write_wtns(circuit.full_assignment(), p["w.wtns"])
    assert main(["prove", ZKEY, p["w.wtns"], p["proof.json"], p["public.json"],
                 "--device", "cpu"]) == 0
    assert json.load(open(p["public.json"])) == [str(v) for v in circuit.get_public_inputs()]

    assert _out(capsys, main, ["export-vkey", ZKEY, p["vk.json"]])[0] == 0
    assert _out(capsys, jax_main, ["export-vkey", ZKEY, p["jvk.json"]])[0] == 0
    assert json.load(open(p["vk.json"])) == json.load(open(p["jvk.json"]))

    for fn in (main, jax_main):
        assert _out(capsys, fn, ["verify", p["vk.json"], p["public.json"], p["proof.json"]]) == \
            (0, "OK!\n")
    assert _out(capsys, main, ["verify", ZKEY, p["public.json"], p["proof.json"]])[0] == 0
    json.dump(["5"], open(p["bad.json"], "w"))
    for fn in (main, jax_main):
        assert _out(capsys, fn, ["verify", p["vk.json"], p["bad.json"], p["proof.json"]]) == \
            (1, "INVALID proof\n")

    rc, line = _out(capsys, main, ["export-calldata", p["public.json"], p["proof.json"]])
    assert (rc, line) == _out(capsys, jax_main, ["export-calldata", p["public.json"], p["proof.json"]])
    (ax, ay), ((bx1, bx0), (by1, by0)), (cx, cy) = eth.Proof.from_ark(
        _proof_from_json(json.load(open(p["proof.json"])))).as_tuple()
    words = [ax, ay, bx1, bx0, by1, by0, cx, cy] + circuit.get_public_inputs()
    assert [int(v, 16) for v in line.replace("[", "").replace("]", "").replace('"', "")
            .strip().split(",")] == words


def test_witness_matches_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("CIRCOM_TPU_AOT", "0")
    monkeypatch.setenv("CIRCOM_TPU_NATIVE", "0")
    wasm, inputs = tmp_path / "mul.wasm", tmp_path / "in.json"
    wasm.write_bytes(mul_module())
    json.dump({"a": "3", "b": 11}, open(inputs, "w"))
    got, want = tmp_path / "t.wtns", tmp_path / "j.wtns"
    assert _out(capsys, main, ["witness", str(wasm), str(inputs), str(got)]) == \
        (0, f"wrote 4 witness values to {got}\n")
    assert jax_main(["witness", str(wasm), str(inputs), str(want)]) == 0
    assert got.read_bytes() == want.read_bytes()
    assert read_wtns(got) == [1, 33, 3, 11]


def test_setup_fullprove_verify(tmp_path, capsys):
    p = {n: str(tmp_path / n) for n in ("c.r1cs", "c.zkey", "vk.json", "in.json", "proof.json",
                                        "public.json", "mul.wasm")}
    pathlib.Path(p["c.r1cs"]).write_bytes(mul_r1cs())
    pathlib.Path(p["mul.wasm"]).write_bytes(mul_module())
    rc, out = _out(capsys, main, ["setup", p["c.r1cs"], p["c.zkey"], p["vk.json"], "--device", "cpu"])
    assert rc == 0 and out.startswith("dev-mode setup: 4 vars, domain 4;")
    assert json.load(open(p["vk.json"]))["nPublic"] == 1
    json.dump({"a": 6, "b": 7}, open(p["in.json"], "w"))
    assert main(["fullprove", p["in.json"], p["mul.wasm"], p["c.zkey"], p["proof.json"],
                 p["public.json"], "--device", "cpu"]) == 0
    assert json.load(open(p["public.json"])) == ["42"]
    assert _out(capsys, main, ["verify", p["vk.json"], p["public.json"], p["proof.json"]]) == \
        (0, "OK!\n")


def test_prove_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = str(tmp_path / "w.wtns")
    write_wtns(chain_circuit(k=254, a=3).full_assignment(), w)
    with pytest.raises(RuntimeError, match="device"):
        main(["prove", ZKEY, w, str(tmp_path / "p.json"), str(tmp_path / "q.json")])
