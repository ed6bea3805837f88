"""circom_compat_tpu_torch parallel/multihost.py on the CPU.

  - dist_dryrun with two gloo worker processes of two shards each (the
    global mesh, four shards) on chain254 with the golden key's toxic waste
    and the golden r and s: every worker's proof equals the single-process
    prove (dist_dryrun checks it) and tests/golden/chain254_proof.json (the
    JAX package's bytes);
  - initialize refuses backend="nccl" for two ranks on one card and on the
    CPU, and without a card asks for platform="cpu" (no card needed: the
    checks run before any process group forms);
  - the CLI's dist-dryrun passes its flags through.
Tolerance: exact equality (proof bytes).
"""

import json
import pathlib

import pytest
import torch
import torch.distributed as dist

from circom_compat_tpu_torch import cli
from circom_compat_tpu_torch.parallel import multihost as mh

torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def test_two_gloo_processes_prove_the_golden_proof():
    rec = json.loads((GOLDEN / "chain254_proof.json").read_text())
    got = mh.dist_dryrun(num_processes=2, local_devices=2, chain_k=254, device="cpu",
                         r=rec["r"], s=rec["s"], window_bits=4, timeout=600)
    assert got["proof_matches_single_process"]
    assert (got["processes"], got["devices"], got["mesh"]) == (2, 4, {"shards": 4})
    assert got["physical_devices"] == ["cpu"] and got["backend"] == "gloo"
    want = rec["proof"]
    assert got["proof"] == {"a": [str(int(v, 16)) for v in want["a"]],
                            "b": [[str(int(v, 16)) for v in c] for c in want["b"]],
                            "c": [str(int(v, 16)) for v in want["c"]]}
    assert not dist.is_initialized()  # the group lived in the workers only


def test_nccl_refuses_shared_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        mh.initialize("127.0.0.1:1", 2, 0, platform="cuda", backend="nccl")
    with pytest.raises(ValueError, match="backend='gloo'"):  # the default on cards is NCCL
        mh.initialize("127.0.0.1:1", 2, 1, local_device_count=1)
    with pytest.raises(ValueError, match="CPU takes backend='gloo'"):
        mh.initialize("127.0.0.1:1", 2, 0, platform="cpu", backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="platform='cpu'"):
        mh.initialize("127.0.0.1:1", 2, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mh.dist_dryrun()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        mh.global_mesh()


def test_cli_dist_dryrun_flags(monkeypatch, capsys):
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"processes": 4, "devices": 8, "mesh": {"dcn": 4, "shards": 2},
                "physical_devices": ["cpu"], "backend": "gloo", "wall_s": 1.0,
                "worker_prove_s": [0.5] * 4, "launches": {"fr_binary": 0}}

    monkeypatch.setattr(mh, "dist_dryrun", fake)
    assert cli.main(["dist-dryrun", "--processes", "4", "--local-devices", "2", "--chain-k", "30",
                     "--two-level", "--timeout", "60", "--device", "cpu",
                     "--backend", "gloo"]) == 0
    assert seen == dict(num_processes=4, local_devices=2, chain_k=30, two_level=True,
                        timeout=60.0, device="cpu", backend="gloo")
    line = json.loads(capsys.readouterr().out)
    assert line["ok"] and line["mesh"] == {"dcn": 4, "shards": 2}
