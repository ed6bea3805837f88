"""circom_compat_tpu_torch prove server (server.py) on the CPU, mirroring
tests/test_server.py on tests/golden/chain254.zkey:
  - ProveServer(zkey, device="cpu") warms up (one prove on a zero
    assignment) and serves on a unix socket under the test's temp dir;
  - ping reports the key's shape and the warm-up time (compile_s);
  - a witness_file request (read as (N, 16) limbs) with the golden r/s
    answers tests/golden/chain254_proof.json's proof, point for point, and
    the chain's public output;
  - bad requests (no witness, bad JSON, inputs without a wasm, a missing
    file) answer ok: false and the server keeps serving; prove-client pings;
  - without a card the default device raises.
Tolerance: exact equality.
"""

import json
import pathlib
import socket
import threading

import pytest
import torch

from circom_compat_tpu_torch.circom.wtns import write_wtns
from circom_compat_tpu_torch.cli import main
from circom_compat_tpu_torch.server import ProveServer, request
from circom_compat_tpu_torch.utils.chain import chain_circuit

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
ZKEY = str(GOLDEN / "chain254.zkey")


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("srv") / "p.sock")
    srv = ProveServer(ZKEY, device="cpu")
    srv.warmup()
    ready = threading.Event()
    t = threading.Thread(target=srv.serve, args=(sock,), kwargs={"ready_cb": ready.set},
                         daemon=True)
    t.start()
    assert ready.wait(30)
    yield sock, srv
    assert request(sock, {"cmd": "shutdown"}, timeout=10) == {"ok": True, "bye": True}
    t.join(timeout=10)
    assert not t.is_alive()


def test_ping_reports_warmup(server):
    sock, srv = server
    resp = request(sock, {"cmd": "ping"})
    assert resp["ok"] and resp["compile_s"] is not None
    assert (resp["n_vars"], resp["domain_size"], resp["window_bits"]) == (256, 256, srv.window_bits)


def test_fixed_rs_matches_golden(server, tmp_path):
    sock, _ = server
    rec = json.loads((GOLDEN / "chain254_proof.json").read_text())
    circuit = chain_circuit(k=254, a=3)
    wtns = tmp_path / "w.wtns"
    write_wtns(circuit.full_assignment(), wtns)
    resp = request(sock, {"witness_file": str(wtns), "r": str(rec["r"]), "s": str(rec["s"])})
    assert resp["ok"], resp
    assert resp["public"] == [str(v) for v in circuit.get_public_inputs()]
    g, p = rec["proof"], resp["proof"]
    assert [int(v) for v in p["pi_a"]] == [int(v, 16) for v in g["a"]] + [1]
    assert [[int(v) for v in c] for c in p["pi_b"]] == \
        [[int(v, 16) for v in c] for c in g["b"]] + [[1, 0]]
    assert [int(v) for v in p["pi_c"]] == [int(v, 16) for v in g["c"]] + [1]
    assert resp["prove_s"] > 0


def _raw(sock_path, line: bytes) -> dict:
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(60)
    c.connect(sock_path)
    with c, c.makefile("rwb") as fh:
        fh.write(line)
        fh.flush()
        return json.loads(fh.readline())


def test_bad_requests_keep_serving(server, tmp_path, capsys):
    sock, srv = server
    n = srv.n_proofs
    resp = request(sock, {"nonsense": 1})
    assert resp == {"ok": False, "error": "no inputs/witness in request"}
    assert "bad json" in _raw(sock, b"{not json\n")["error"]
    assert "without a wasm" in request(sock, {"inputs": {"a": 1}})["error"]
    missing = request(sock, {"witness_file": str(tmp_path / "absent.wtns")})
    assert not missing["ok"] and "FileNotFoundError" in missing["error"]
    assert request(sock, {"cmd": "ping"})["ok"]
    assert main(["prove-client", "--socket", sock]) == 0
    assert json.loads(capsys.readouterr().out)["n_proofs"] == srv.n_proofs == n


def test_server_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        ProveServer(ZKEY)
