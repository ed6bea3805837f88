"""circom_compat_tpu_torch's phase-2 ceremony (circom/contribute.py, zkey
section 10, verify_mpc_chain) against the JAX package on
tests/golden/chain254.zkey with fixed entropy:
  - delta_g1, delta_g2, the L and H sections, the transcript and g2_spx of
    the port's contribute (device="cpu": scalar_mul_const and the batch
    inversion on the kernels' plain versions) equal the JAX package's
    contribute byte for byte (g1_s and g1_sx come from os.urandom in both,
    so they are not compared);
  - each package's verify_mpc_chain gives the JAX package's verdict on each
    package's output: False, because chain254's delta is a dev-mode
    delta (0xD), not the G1 generator the chain check starts from;
  - a proof under the port's contributed key verifies and fails under the
    old verifying key;
  - section 10 from both writers is byte-identical for the same MPCParams
    (empty, the contributed chain, a beacon with every parameter and an
    infinity point);
  - each package's reader reads the other's file: the JAX writer's bytes
    read by the port and written again are the same bytes, and the JAX
    reader reads the port's file into the same sections and chain;
  - the JAX-contributed key carried across by
    convert.proving_key_from_numpy (mpc included) makes the port's writer
    write the JAX writer's bytes;
  - a section 10 shorter than 68 bytes reads as an empty chain and a
    missing one as None;
  - without a card, contribute's default device raises.
Tolerance: exact equality of bytes and group elements.
"""

import dataclasses
import io
import struct

import numpy as np
import pytest
import torch

from circom_compat_tpu.circom import contribute as jc
from circom_compat_tpu.circom import zkey as jz
from circom_compat_tpu.circom import zkey_writer as jw
from circom_compat_tpu_torch import convert
from circom_compat_tpu_torch.circom import contribute as tc
from circom_compat_tpu_torch.circom import zkey as tz
from circom_compat_tpu_torch.circom import zkey_writer as tw
from circom_compat_tpu_torch.models.groth16 import Groth16
from circom_compat_tpu_torch.refmath import curve as rc
from circom_compat_tpu_torch.utils.chain import chain_circuit
from test_torch_groth16 import GOLDEN, _numpy_dict

torch.set_num_threads(1)
ZKEY = GOLDEN / "chain254.zkey"
ENTROPY = b"chain254 deterministic entropy"


@pytest.fixture(scope="module")
def keys():
    """(port key, its matrices, JAX key, JAX matrices, port contributed,
    JAX contributed)."""
    pk, m = tz.read_zkey(ZKEY)
    jpk, jm = jz.read_zkey(str(ZKEY))
    return (pk, m, jpk, jm, tc.contribute(pk, entropy=ENTROPY, name="alice", device="cpu"),
            jc.contribute(jpk, entropy=ENTROPY, name="alice"))


def _port_file(pk, m) -> bytes:
    buf = io.BytesIO()
    tw.write_zkey(buf, pk, m.a, m.b, m.num_constraints)
    return buf.getvalue()


def _jax_file(jpk, jm) -> bytes:
    buf = io.BytesIO()
    jw.write_zkey(buf, jpk, jm.a, jm.b, jm.num_constraints)
    return buf.getvalue()


def test_contribution_matches_jax(keys):
    pk, _, _, _, got, want = keys
    assert got.delta_g1 == want.delta_g1 != pk.delta_g1
    assert got.vk.delta_g2 == want.vk.delta_g2 != pk.vk.delta_g2
    for name in ("l_query", "h_query"):
        g, w = getattr(got, name).limbs, np.asarray(getattr(want, name).limbs)
        assert g.shape == w.shape and np.array_equal(g, w.astype(np.uint16)), name
        assert not np.array_equal(g, getattr(pk, name).limbs)
    for name in ("a_query", "b_g1_query", "b_g2_query"):
        assert getattr(got, name) is getattr(pk, name)
    gc, wc = got.mpc.contributions[-1], want.mpc.contributions[-1]
    assert (gc.delta_after, gc.g2_spx, gc.transcript, gc.name, gc.contrib_type) == (
        wc.delta_after, wc.g2_spx, wc.transcript, wc.name, wc.contrib_type)
    assert got.mpc.cs_hash == want.mpc.cs_hash and len(got.mpc.contributions) == 1
    assert rc.G1.mul(gc.g1_s, tc.derive_secret(ENTROPY)) == gc.g1_sx


def test_chain_verdicts_match_jax(keys):
    pk, m, jpk, jm, got, want = keys
    verdict = jz.verify_mpc_chain(want)
    assert verdict is False  # chain254's delta is not the G1 generator
    assert tz.verify_mpc_chain(got) is verdict
    assert tz.verify_mpc_chain(tz.read_zkey(io.BytesIO(_jax_file(want, jm)))[0]) is verdict
    assert jz.verify_mpc_chain(jz.read_zkey(io.BytesIO(_port_file(got, m)))[0]) is verdict
    assert tz.verify_mpc_chain(pk) is jz.verify_mpc_chain(jpk) is True  # no contributions


def test_proof_under_contributed_key(keys):
    _, m, _, _, got, _ = keys
    old = tz.read_zkey(ZKEY)[0]
    c = chain_circuit(k=254, a=3)
    proof = Groth16.create_proof_with_reduction_and_matrices(
        got, 77, 88, m, m.num_instance_variables, m.num_constraints, c.full_assignment(),
        device="cpu")
    assert Groth16.verify_proof(got.vk, proof, c.get_public_inputs())
    assert not Groth16.verify_proof(old.vk, proof, c.get_public_inputs())


def _mpc_pair(kind, want):
    """The same MPCParams as the JAX package's and the port's classes."""
    if kind == "none":
        return None, None
    if kind == "contributed":
        jmpc = want.mpc
    else:
        g2 = rc.G2.mul(rc.g2_generator(), 5)
        jmpc = jz.MPCParams(cs_hash=bytes(range(64)), contributions=[
            jz.Contribution(delta_after=rc.G1.mul(rc.g1_generator(), 3), g1_s=None,
                            g1_sx=(1, 2), g2_spx=g2, transcript=b"\x07" * 64, contrib_type=1,
                            name="beacon é", num_iterations_exp=10,
                            beacon_hash=b"\xab" * 64),
            jz.Contribution(delta_after=(1, 2), g1_s=(1, 2), g1_sx=(1, 2), g2_spx=None,
                            transcript=b"\x01" * 64)])
    return jmpc, convert._mpc(jmpc)


@pytest.mark.parametrize("kind", ["none", "contributed", "beacon"])
def test_section10_bytes_match_jax_writer(keys, kind):
    jmpc, tmpc = _mpc_pair(kind, keys[5])
    assert tw._mpc_bytes(tmpc) == jw._mpc_bytes(jmpc)
    if tmpc is not None:
        assert dataclasses.asdict(tmpc) == dataclasses.asdict(jmpc)


def test_readers_read_each_others_files(keys):
    pk, m, jpk, jm, got, want = keys
    jax_bytes = _jax_file(want, jm)
    back, bm = tz.read_zkey(io.BytesIO(jax_bytes))
    assert _port_file(back, bm) == jax_bytes
    assert dataclasses.asdict(back.mpc) == dataclasses.asdict(want.mpc)
    jback, _ = jz.read_zkey(io.BytesIO(_port_file(got, m)))
    assert dataclasses.asdict(jback.mpc) == dataclasses.asdict(got.mpc)
    for name in ("l_query", "h_query", "a_query"):
        assert np.array_equal(np.asarray(getattr(jback, name).limbs), getattr(got, name).limbs)
    assert (jback.delta_g1, jback.vk.delta_g2) == (got.delta_g1, got.vk.delta_g2)


def test_converted_jax_key_keeps_its_chain(keys):
    _, m, _, jm, _, want = keys
    d = _numpy_dict(want, jm.a, jm.b, jm.num_instance_variables)
    tpk = convert.proving_key_from_numpy({**d, "mpc": want.mpc})
    assert dataclasses.asdict(tpk.mpc) == dataclasses.asdict(want.mpc)
    assert _port_file(tpk, m) == _jax_file(want, jm)
    assert convert.proving_key_from_numpy(d).mpc is None


def _with_section10(data: bytes, payload) -> bytes:
    """A zkey's bytes with its last section (10, as both writers put it)
    replaced by payload, or dropped when payload is None."""
    count = struct.unpack("<I", data[8:12])[0]
    size = len(tw._mpc_bytes(None))  # the key has no contributions
    assert data[-size - 12 : -size] == struct.pack("<IQ", 10, size)
    body = data[: -size - 12]
    if payload is None:
        return body[:8] + struct.pack("<I", count - 1) + body[12:]
    return body + struct.pack("<IQ", 10, len(payload)) + payload


def test_short_and_missing_section10(keys):
    pk, m = keys[0], keys[1]
    data = _port_file(pk, m)
    short = tz.read_zkey(io.BytesIO(_with_section10(data, struct.pack("<I", 0))))[0]
    assert short.mpc == tz.MPCParams()
    assert tz.read_zkey(io.BytesIO(_with_section10(data, None)))[0].mpc is None
    assert jz.read_zkey(io.BytesIO(_with_section10(data, None)))[0].mpc is None


def test_contribute_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        tc.contribute(tz.read_zkey(ZKEY)[0], entropy=ENTROPY)
