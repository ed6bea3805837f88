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
  - without a card, prove's default device raises;
  - contribute (--device cpu) on a delta-one key, then verify-chain
    through both CLIs: 0 on the chain and on a fresh key, 1 on a tampered
    chain, the same lines;
  - verify-onchain: without the artifact both CLIs raise
    FileNotFoundError; with assembled stand-ins of the verifier contract
    (true, false, a revert) the same lines and exit codes as the JAX CLI's;
  - --help lists every subcommand of the JAX CLI.
Tolerance: exact equality (file bytes, stdout lines, exit codes).
"""

import dataclasses
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
from test_torch_evm import asm, ret
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


def test_contribute_and_verify_chain(tmp_path, capsys):
    from circom_compat_tpu_torch import models
    from circom_compat_tpu_torch.circom.zkey import read_zkey
    from circom_compat_tpu_torch.circom.zkey_writer import write_zkey

    p = {n: str(tmp_path / n) for n in ("k0.zkey", "k1.zkey", "bad.zkey")}
    c = chain_circuit(k=14, a=3)
    ma, mb, _ = c.to_matrices()
    write_zkey(p["k0.zkey"], models.generate_parameters(c, 5, 7, 11, 1, 13), ma, mb, len(ma))
    for fn in (main, jax_main):
        assert _out(capsys, fn, ["verify-chain", p["k0.zkey"]]) == (0, "0 contribution(s): chain OK\n")
    rc, out = _out(capsys, main, ["contribute", p["k0.zkey"], p["k1.zkey"], "--name", "alice",
                                  "--entropy", "one", "--device", "cpu"])
    assert rc == 0 and out.startswith(f"contribution #1 applied; wrote {p['k1.zkey']}\nnote: ")
    ok = _out(capsys, main, ["verify-chain", p["k1.zkey"]])
    assert ok[0] == 0 and ok[1].startswith("1 contribution(s): chain OK\nnote: ")
    assert ok == _out(capsys, jax_main, ["verify-chain", p["k1.zkey"]])
    pk, m = read_zkey(p["k1.zkey"])
    assert [x.name for x in pk.mpc.contributions] == ["alice"]
    first = dataclasses.replace(pk.mpc.contributions[0], g1_sx=pk.delta_g1)
    bad = dataclasses.replace(pk, mpc=dataclasses.replace(pk.mpc, contributions=[first]))
    write_zkey(p["bad.zkey"], bad, m.a, m.b, m.num_constraints)
    for fn in (main, jax_main):
        assert _out(capsys, fn, ["verify-chain", p["bad.zkey"]]) == \
            (1, "1 contribution(s): chain INVALID\n")


def test_verify_onchain(tmp_path, capsys):
    p = {n: str(tmp_path / n) for n in ("w.wtns", "proof.json", "public.json", "vk.json", "art.json")}
    circuit = chain_circuit(k=254, a=3)
    from test_torch_groth16 import _golden

    json.dump({"pi_a": [str(v) for v in _golden()[1].a] + ["1"],
               "pi_b": [[str(v) for v in c] for c in _golden()[1].b] + [["1", "0"]],
               "pi_c": [str(v) for v in _golden()[1].c] + ["1"], "protocol": "groth16",
               "curve": "bn128"}, open(p["proof.json"], "w"))
    json.dump([str(v) for v in circuit.get_public_inputs()], open(p["public.json"], "w"))
    assert main(["export-vkey", ZKEY, p["vk.json"]]) == 0
    args = [p["vk.json"], p["public.json"], p["proof.json"]]
    for fn in (main, jax_main):
        with pytest.raises(FileNotFoundError):
            fn(["verify-onchain", *args])
        with pytest.raises(FileNotFoundError):
            fn(["verify-onchain", *args, "--artifact", str(tmp_path / "absent.json")])
    msg = "verifier-bad-input".encode()
    revert = asm(0x08C379A0 << 224, 0, "MSTORE", 32, 4, "MSTORE", len(msg), 36, "MSTORE",
                 int.from_bytes(msg.ljust(32, b"\0"), "big"), 68, "MSTORE", 100, 0, "REVERT")
    stand_ins = [(asm(1, 0, "MSTORE", *ret(0, 32)), 0, "OK! (on-chain)\n"),
                 (asm(*ret(0, 32)), 1, "INVALID proof (on-chain)\n"),
                 (revert, 1, "EVM revert: verifier-bad-input\n")]
    for code, rc, line in stand_ins:
        json.dump({"deployedBytecode": {"object": "0x" + code.hex()}}, open(p["art.json"], "w"))
        for vkey in (p["vk.json"], ZKEY):
            got = _out(capsys, main, ["verify-onchain", vkey, *args[1:], "--artifact", p["art.json"]])
            assert got == (rc, line)
        assert got == _out(capsys, jax_main, ["verify-onchain", *args, "--artifact", p["art.json"]])


def test_help_lists_every_jax_subcommand(capsys):
    def commands(fn):
        with pytest.raises(SystemExit) as exc:
            fn(["--help"])
        assert exc.value.code == 0
        usage = capsys.readouterr().out
        return set(usage[usage.index("{") + 1 : usage.index("}")].split(","))

    want = commands(jax_main)
    assert {"contribute", "verify-chain", "verify-onchain"} <= want <= commands(main)
