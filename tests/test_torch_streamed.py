"""circom_compat_tpu_torch streamed prover (models/streamed.py) on the CPU.

  - chain254 from tests/golden/chain254.zkey streamed at chunk_points=100
    (three chunks, the last padded; L and H end inside the loop) with the
    golden r and s equals tests/golden/chain254_proof.json (the JAX
    package's bytes) and verifies; the trace holds the streamed prove's
    stages;
  - G1 bucket sums accumulated chunk by chunk with point_add (K6/K7) equal
    one bucket_sums over the whole vector, and in buckets 1 .. B-1 the JAX
    package's bucket_sums_affine_impl (XLA), operands carried across by
    convert.affine_words_from_limbs, compared as decoded affine points;
    bucket 0 is the identity in every window;
  - a section longer than the scalars that cover it is refused by name;
  - staged rows past a section's end are zero;
  - utils/chain.chain_matrices (numpy) equals matrices_from_rows over
    chain_circuit's row lists;
  - the key's default device is the card, and an unknown facade backend
    is refused.
Inputs come from a numpy seed. Tolerance: exact equality (proof bytes,
affine group elements, arrays).
"""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from circom_compat_tpu.ops import curve_jax as cj
from circom_compat_tpu.ops import msm as jmsm
from circom_compat_tpu_torch import convert
from circom_compat_tpu_torch.circom.zkey import G1Section, G2Section, read_zkey
from circom_compat_tpu_torch.constants import R_SCALAR
from circom_compat_tpu_torch.models import groth16_device as gd
from circom_compat_tpu_torch.models import streamed
from circom_compat_tpu_torch.models.groth16 import Groth16
from circom_compat_tpu_torch.ops import curve as cv
from circom_compat_tpu_torch.ops import curve_kernels as ck
from circom_compat_tpu_torch.ops import limbs as tl
from circom_compat_tpu_torch.ops import msm as tmsm
from circom_compat_tpu_torch.refmath import curve as rc
from circom_compat_tpu_torch.utils import trace
from circom_compat_tpu_torch.utils.chain import chain_circuit, chain_matrices

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
RNG = np.random.default_rng(0x57E4)


def _chain254():
    pk, m = read_zkey(GOLDEN / "chain254.zkey")
    return pk, m


def test_chain254_streamed_three_chunks_is_golden():
    rec = json.loads((GOLDEN / "chain254_proof.json").read_text())
    pk, m = _chain254()
    circuit = chain_circuit(k=254, a=3)
    with trace.collect() as tr:
        spk = streamed.StreamedProvingKey.build(pk, m, m.num_constraints, chunk_points=100,
                                                device="cpu")
        proof = streamed.prove_streamed(spk, rec["r"], rec["s"], circuit.full_assignment())
    # 256 rows in chunks of 100; L (254 rows) and H (256) end inside the loop
    assert (len(pk.l_query), len(pk.h_query), spk.n_vars) == (254, 256, 256)
    want = rec["proof"]
    assert proof.a == tuple(int(v, 16) for v in want["a"])
    assert proof.b == tuple(tuple(int(v, 16) for v in c) for c in want["b"])
    assert proof.c == tuple(int(v, 16) for v in want["c"])
    assert Groth16.verify_proof(pk.vk, proof, circuit.get_public_inputs())
    names = [name for name, _ in tr.stages]
    assert ["key.stage", "prove.encode", "prove.witness_map", "prove.msm_stream",
            "prove.assemble"] == [n for n in names if "/" not in n]
    assert streamed.LAST_CHUNK_MS == []  # chunk times are the card's only


def test_chunked_bucket_sums_vs_whole_and_jax():
    n, wbits, chunk = 40, 4, 16
    pool = [rc.G1.mul(rc.g1_generator(), int(k)) for k in RNG.integers(1, 1 << 62, size=8)]
    pts = [pool[i] for i in RNG.integers(0, 8, size=n)]
    pts[3] = pts[n - 1] = None
    vals = [int.from_bytes(RNG.bytes(32), "little") % R_SCALAR for _ in range(n)]
    vals[0], vals[5] = 0, R_SCALAR - 1
    xy = cv.encode_g1_affine(pts)
    u16 = np.ascontiguousarray(xy).view("<u2")
    jx, jy = u16[:, 0].astype(np.uint32), u16[:, 1].astype(np.uint32)
    assert np.array_equal(convert.affine_words_from_limbs(jx, jy), xy)
    sc = torch.from_numpy(tl.ints_to_words(vals))

    whole = tmsm.bucket_sums([torch.from_numpy(xy)], [tmsm.window_orders(sc, wbits)], wbits)[0]
    W, B = tmsm.num_windows(wbits), 1 << wbits
    acc = cv.proj_identity_const(False).expand((1, W, B, 3, 8)).contiguous()
    rows = np.empty((chunk, 2, 8), np.int32)
    for lo in range(0, n, chunk):  # 16, 16, then 8 rows and 8 padding
        streamed.stage_rows(xy, lo, rows)
        part = streamed._padded(sc[lo : lo + chunk], chunk)
        acc = ck.point_add(acc, tmsm.bucket_sums([torch.from_numpy(rows.copy())],
                                                 [tmsm.window_orders(part, wbits)], wbits))
    got = cv.decode_g1_proj(acc[0])
    assert got == cv.decode_g1_proj(whole)

    limbs = jax.numpy.asarray(tl.ints_to_limbs(vals))
    fn = jax.jit(jmsm.bucket_sums_affine_impl, static_argnums=(0, 4, 5))
    jb = fn(cj.FQ_ADAPTER, jax.numpy.asarray(jx), jax.numpy.asarray(jy), limbs, wbits, False)
    # bucket 0 (digit 0, multiplied by 0 in every window sum) is the identity:
    # the port gathers only the rows of nonzero digit
    assert got[::B] == [None] * W
    assert [p for i, p in enumerate(got) if i % B] == \
        [p for i, p in enumerate(cj.decode_g1_proj(jb)) if i % B]
    assert sum(p is not None for p in got) > W  # buckets beyond one a window were hit


def _with_section(pk, name, extra):
    """pk with `extra` zero rows appended to section `name`."""
    attr = {"A": "a_query", "B1": "b_g1_query", "L": "l_query", "H": "h_query",
            "B2": "b_g2_query"}[name]
    sec = getattr(pk, attr)
    limbs = np.concatenate((sec.limbs, np.zeros((extra,) + sec.limbs.shape[1:], np.uint16)))
    kind = G2Section if name == "B2" else G1Section
    return dataclasses.replace(pk, **{attr: kind(limbs)})


@pytest.mark.parametrize("name,extra", [("A", 1), ("B1", 1), ("L", 3), ("H", 1), ("B2", 1)])
def test_section_longer_than_its_scalars_is_refused(name, extra):
    pk, m = _chain254()
    spk = streamed.StreamedProvingKey.build(_with_section(pk, name, extra), m, m.num_constraints,
                                            device="cpu")
    with pytest.raises(ValueError, match=f"section {name} has"):
        streamed.prove_streamed(spk, 1, 2, chain_circuit(k=254, a=3).full_assignment())


def test_staged_rows_past_the_end_are_zero():
    pk, m = _chain254()
    spk = streamed.StreamedProvingKey.build(pk, m, m.num_constraints, device="cpu")
    g1, g2 = streamed._host_pack(100, pin=False)
    g1.fill_(-1)
    g2.fill_(-1)
    streamed._stage_pack(spk, 200, g1, g2)  # the last of three chunks of 100
    for m_, sec in enumerate(spk.g1_sections):
        rows = sec.shape[0] - 200  # 56 for A, B1, H; 54 for L
        assert np.array_equal(g1[m_, :rows].numpy(), sec[200:])
        assert not g1[m_, rows:].any()
    assert np.array_equal(g2[:56].numpy(), spk.g2_section[200:])
    assert not g2[56:].any()
    # the views are the key's limbs, not copies
    assert np.shares_memory(spk.g1_sections[0], pk.a_query.limbs)
    assert spk.g2_section.shape == (256, 2, 2, 8)


@pytest.mark.parametrize("k", [6, 30, 254])
def test_chain_matrices_equal_the_row_lists(k):
    rows = chain_circuit(k=k, a=3).to_matrices()
    want = gd.matrices_from_rows(rows[0], rows[1], 2, k, k + 2)
    got = chain_matrices(k)
    for f in ("a_rows", "a_cols", "a_values_mont", "b_rows", "b_cols", "b_values_mont"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert getattr(got, f).dtype == getattr(want, f).dtype
    for f in ("num_instance_variables", "num_witness_variables", "num_constraints"):
        assert getattr(got, f) == getattr(want, f)


def test_streamed_defaults_to_the_card_and_backends(monkeypatch):
    pk, m = _chain254()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        streamed.StreamedProvingKey.build(pk, m, m.num_constraints)
    with pytest.raises(ValueError, match="backend"):
        Groth16.create_proof_with_reduction_and_matrices(
            pk, 1, 2, m, 2, m.num_constraints, [1, 2], device="cpu", backend="resident")
