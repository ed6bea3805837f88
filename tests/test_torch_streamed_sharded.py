"""circom_compat_tpu_torch parallel/streamed_sharded.py on the CPU.

  - chain254 from tests/golden/chain254.zkey streamed over ["cpu"] * 2 at
    chunk_points=128 (two chunks, each split into two parts of 64 rows;
    L ends inside the last part) with the golden r and s equals
    tests/golden/chain254_proof.json (the JAX package's bytes); its trace
    holds the streamed prove's stages, and the digit-0 counts are read once
    a shard a chunk;
  - the chunk rule is the JAX package's (streamed_sharded.py:176-183);
  - a section longer than its scalars is refused, and without a card the
    default mesh raises and names the argument.
Tolerance: exact equality (proof bytes).
"""

import json
import pathlib

import pytest
import torch

from circom_compat_tpu_torch.circom.zkey import read_zkey
from circom_compat_tpu_torch.models import streamed as sm
from circom_compat_tpu_torch.ops import msm as msm_ops
from circom_compat_tpu_torch.parallel import mesh as pm
from circom_compat_tpu_torch.parallel import streamed_sharded as ss
from circom_compat_tpu_torch.utils import trace
from circom_compat_tpu_torch.utils.chain import chain_circuit

torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


@pytest.fixture(scope="module")
def key():
    return read_zkey(GOLDEN / "chain254.zkey")


def test_chain254_streamed_sharded_two_chunks_is_golden(key, monkeypatch):
    rec = json.loads((GOLDEN / "chain254_proof.json").read_text())
    pk, m = key
    spk = sm.StreamedProvingKey.build(pk, m, m.num_constraints, chunk_points=128, device="cpu")
    reads, counts = [], msm_ops.digit_zero_counts
    monkeypatch.setattr(msm_ops, "digit_zero_counts",
                        lambda sorts: reads.append(len(sorts)) or counts(sorts))
    with trace.collect() as tr:
        proof = ss.prove_streamed_sharded(spk, pm.make_mesh(devices=["cpu"] * 2), rec["r"],
                                          rec["s"], chain_circuit(k=254, a=3).full_assignment(),
                                          window_bits=4)
    want = rec["proof"]
    assert proof.a == tuple(int(v, 16) for v in want["a"])
    assert proof.b == tuple(tuple(int(v, 16) for v in c) for c in want["b"])
    assert proof.c == tuple(int(v, 16) for v in want["c"])
    assert reads == [4] * 4  # one a shard a chunk, for both groups
    assert [name for name, _ in tr.stages] == [
        "prove.encode", "prove.witness_map/witness_map.sparse", "prove.witness_map",
        "prove.msm_stream/scans", "prove.msm_stream/gather", "prove.msm_stream",
        "prove.assemble/readback", "prove.assemble/fold", "prove.assemble"]
    assert ss.LAST_CHUNK_MS == {}  # chunk times are the card's only


def _jax_chunk(chunk_points, n_vars, D):
    """The JAX package's rule, circom_compat_tpu/parallel/streamed_sharded.py:176-183."""
    chunk = min(chunk_points, 1 << max(n_vars - 1, 1).bit_length())
    chunk = max(chunk, D)
    return -(-chunk // D) * D


@pytest.mark.parametrize("chunk_points,n_vars,D", [
    (128, 256, 2), (100, 256, 8), (1 << 20, 256, 4), (3, 256, 4), (1 << 20, (1 << 20) + 5, 4),
    (3 << 17, 1 << 20, 4), (1, 2, 1)])
def test_chunk_rule_is_jax(key, chunk_points, n_vars, D):
    pk, m = key
    spk = sm.StreamedProvingKey.build(pk, m, m.num_constraints, chunk_points=chunk_points,
                                      device="cpu")
    spk.n_vars = n_vars
    assert ss.chunk_rows(spk, D) == _jax_chunk(chunk_points, n_vars, D)


def test_refusals(key, monkeypatch):
    pk, m = key
    spk = sm.StreamedProvingKey.build(pk, m, m.num_constraints, device="cpu")
    spk.n_vars = 255  # B2's 256 rows now outrun their scalars
    with pytest.raises(ValueError, match="section A has"):
        ss.prove_streamed_sharded(spk, pm.make_mesh(devices=["cpu"] * 2), 1, 2, [1] * 255)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        ss.prove_streamed_sharded(spk, None, 1, 2, [1] * 256)
