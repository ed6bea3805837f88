"""circom_compat_tpu_torch parallel/prove_sharded.py on the CPU.

  - chain254 from tests/golden/chain254.zkey proved with
    build_sharded_prover(..., dist_ntt=True) on ["cpu"] * 2 (the mesh
    repeats one device) with the golden r and s equals
    tests/golden/chain254_proof.json (the JAX package's bytes) and
    verifies; its trace holds the prove's stages and prove.msm/gather, and
    the digit-0 counts are read once a shard;
  - the default turns the distributed NTT on where the domain splits over
    the mesh, and off where it does not;
  - the staged shards hold the key's rows, H in TD order;
  - without a card the default mesh raises and names the argument.
Tolerance: exact equality (proof bytes, words).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from circom_compat_tpu_torch.circom.zkey import read_zkey
from circom_compat_tpu_torch.models import groth16_device as gd
from circom_compat_tpu_torch.models.groth16 import Groth16
from circom_compat_tpu_torch.ops import limbs as tl
from circom_compat_tpu_torch.ops import msm as msm_ops
from circom_compat_tpu_torch.parallel import mesh as pm
from circom_compat_tpu_torch.parallel import ntt_sharded as ns
from circom_compat_tpu_torch.parallel import prove_sharded as ps
from circom_compat_tpu_torch.utils import trace
from circom_compat_tpu_torch.utils.chain import chain_circuit

torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


@pytest.fixture(scope="module")
def key():
    pk, m = read_zkey(GOLDEN / "chain254.zkey")
    return gd.DeviceProvingKey.build(pk, m, m.num_constraints, device="cpu")


def test_chain254_sharded_dist_ntt_is_golden(key, monkeypatch):
    rec = json.loads((GOLDEN / "chain254_proof.json").read_text())
    circuit = chain_circuit(k=254, a=3)
    mesh = pm.make_mesh(devices=["cpu"] * 2)
    prover = ps.build_sharded_prover(key, mesh, window_bits=4, dist_ntt=True)
    reads, counts = [], msm_ops.digit_zero_counts
    monkeypatch.setattr(msm_ops, "digit_zero_counts",
                        lambda sorts: reads.append(len(sorts)) or counts(sorts))
    times = {}
    with trace.collect() as tr:
        proof = ps.prove_sharded(key, prover, rec["r"], rec["s"], circuit.full_assignment(),
                                 stage_times=times)
    want = rec["proof"]
    assert proof.a == tuple(int(v, 16) for v in want["a"])
    assert proof.b == tuple(tuple(int(v, 16) for v in c) for c in want["b"])
    assert proof.c == tuple(int(v, 16) for v in want["c"])
    assert Groth16.verify_proof(key.pk.vk, proof, circuit.get_public_inputs())
    assert reads == [4, 4]  # one a shard, for both groups (B2's rows are A's)
    assert [name for name, _ in tr.stages] == [
        "prove.encode", "prove.witness_map", "prove.msm/sorts", "prove.msm/msm_g1",
        "prove.msm/msm_g2", "prove.msm/gather", "prove.msm", "prove.assemble/readback",
        "prove.assemble/fold", "prove.assemble"]
    assert set(times) == {"encode", "witness_map", "sorts", "msm_g1", "msm_g2", "gather",
                          "readback", "assemble"}


def test_default_dist_ntt_and_staged_shards(key):
    mesh = pm.make_mesh(devices=["cpu"] * 2)
    prover = ps.build_sharded_prover(key, mesh)
    assert prover.dist_ntt and prover.n_pad == 256 and prover.total == 2
    assert prover.window_bits == 8  # pick_window_bits of a shard's 128 rows
    plan = ns.get_dist_plan(256, 2)
    h_td = tl.words_view(key.pk.h_query.limbs)[np.argsort(plan.td_perm)]
    l_rows = tl.words_view(key.pk.l_query.limbs)  # 254 rows: shard 1 ends in two of infinity
    for i, (g1, g2) in enumerate(zip(prover.g1, prover.g2)):
        assert g1.shape == (4, 128, 2, 8) and g2.shape == (128, 2, 2, 8)
        rows = slice(128 * i, 128 * (i + 1))
        assert np.array_equal(g1[0].numpy(), tl.words_view(key.pk.a_query.limbs)[rows])
        assert np.array_equal(g1[3].numpy(), h_td[rows])
        assert np.array_equal(g1[2, : 128 - 2 * i].numpy(), l_rows[rows])
        assert not g1[2, 128 - 2 * i :].any()
    assert prover.g1[0].data_ptr() != prover.g1[1].data_ptr()
    # a domain of 256 does not split over 32 shards (n1 = 32, n2 = 8)
    assert not ps.build_sharded_prover(key, pm.make_mesh(devices=["cpu"] * 32)).dist_ntt
    with pytest.raises(ValueError, match="another key"):
        ps.prove_sharded(object(), prover, 1, 2, [1])


def test_sharded_prover_needs_a_mesh_without_a_card(key, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        ps.build_sharded_prover(key, pm.make_mesh())
