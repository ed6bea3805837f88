"""The ceremony's chain check (zkey.verify_mpc_chain) on keys whose delta is
the G1 generator, as a fresh snarkjs key's is: a delta-one key from each
package's generate_parameters (the squaring chain at k = 30, toxic waste
alpha 5, beta 7, gamma 11, delta 1, t 13; the two keys byte for byte the
same), then two contributions in each package with the same entropies:
  - the port's contributed deltas, L and H equal the JAX package's;
  - both packages' verify_mpc_chain accept both chains (each read through
    the other package's writer and reader);
  - a tampered link (g1_sx no longer g1_s * s) and an unlinked delta (a
    self-consistent contributor key whose secret did not make delta_after;
    a chain missing its first contribution) are refused by both.
Tolerance: exact equality of bytes and group elements, and of verdicts.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from circom_compat_tpu.circom import contribute as jc
from circom_compat_tpu.circom import zkey as jz
from circom_compat_tpu.circom import zkey_writer as jw
from circom_compat_tpu.models import generate_parameters as jax_generate_parameters
from circom_compat_tpu.utils.chain import chain_circuit as jax_chain_circuit
from circom_compat_tpu_torch import models
from circom_compat_tpu_torch.circom import contribute as tc
from circom_compat_tpu_torch.circom import zkey as tz
from circom_compat_tpu_torch.circom import zkey_writer as tw
from circom_compat_tpu_torch.constants import R_SCALAR
from circom_compat_tpu_torch.refmath import curve as rc
from circom_compat_tpu_torch.utils.chain import chain_circuit

torch.set_num_threads(1)
K = 30
TOXIC = (5, 7, 11, 1, 13)  # alpha, beta, gamma, delta = 1, t
STEPS = ((b"first contribution", "alice"), (b"second contribution", "bob"))


@pytest.fixture(scope="module")
def chains():
    """(port chain, JAX chain, row lists, constraint count)."""
    c = chain_circuit(k=K, a=3)
    pk = models.generate_parameters(c, *TOXIC)
    jpk = jax_generate_parameters(jax_chain_circuit(k=K, a=3), *TOXIC)
    assert pk.delta_g1 == rc.g1_generator() == jpk.delta_g1
    for name in ("l_query", "h_query", "a_query", "b_g2_query"):
        assert np.array_equal(getattr(pk, name).limbs, np.asarray(getattr(jpk, name).limbs))
    for entropy, name in STEPS:
        pk = tc.contribute(pk, entropy=entropy, name=name, device="cpu")
        jpk = jc.contribute(jpk, entropy=entropy, name=name)
    ma, mb, _ = c.to_matrices()
    return pk, jpk, (ma, mb), len(c.r1cs.constraints)


def _to_jax(pk, rows, nc):
    buf = io.BytesIO()
    tw.write_zkey(buf, pk, rows[0], rows[1], nc)
    buf.seek(0)
    return jz.read_zkey(buf)[0]


def _to_port(jpk, rows, nc):
    buf = io.BytesIO()
    jw.write_zkey(buf, jpk, rows[0], rows[1], nc)
    buf.seek(0)
    return tz.read_zkey(buf)[0]


def test_delta_one_chain_verifies_in_both_packages(chains):
    pk, jpk, rows, nc = chains
    assert pk.delta_g1 == jpk.delta_g1 and pk.vk.delta_g2 == jpk.vk.delta_g2
    for name in ("l_query", "h_query"):
        assert np.array_equal(getattr(pk, name).limbs, np.asarray(getattr(jpk, name).limbs))
    assert [c.name for c in pk.mpc.contributions] == ["alice", "bob"]
    assert tz.verify_mpc_chain(pk) is True
    assert jz.verify_mpc_chain(jpk) is True
    assert tz.verify_mpc_chain(_to_port(jpk, rows, nc)) is True
    back = _to_jax(pk, rows, nc)
    assert jz.verify_mpc_chain(back) is True
    assert dataclasses.asdict(back.mpc) == dataclasses.asdict(pk.mpc)


def _tampered(pk):
    mpc = pk.mpc
    first = dataclasses.replace(mpc.contributions[0], g1_sx=pk.delta_g1)
    return dataclasses.replace(pk, mpc=dataclasses.replace(
        mpc, contributions=[first, *mpc.contributions[1:]]))


def _unlinked(pk):
    """The last contribution's key swapped for a self-consistent one with
    another secret: the key's own pairing and the final delta still pass."""
    s_forge = 0xF00D % R_SCALAR
    g1_s = rc.G1.mul(rc.g1_generator(), 7)
    last = dataclasses.replace(pk.mpc.contributions[-1], g1_s=g1_s,
                               g1_sx=rc.G1.mul(g1_s, s_forge),
                               g2_spx=rc.G2.mul(rc.g2_generator(), s_forge))
    return dataclasses.replace(pk, mpc=dataclasses.replace(
        pk.mpc, contributions=[*pk.mpc.contributions[:-1], last]))


def _first_dropped(pk):
    return dataclasses.replace(pk, mpc=dataclasses.replace(
        pk.mpc, contributions=pk.mpc.contributions[1:]))


@pytest.mark.parametrize("forge", [_tampered, _unlinked, _first_dropped],
                         ids=["tampered_link", "unlinked_delta", "first_dropped"])
def test_forged_chains_refused(chains, forge):
    pk, _, rows, nc = chains
    bad = forge(pk)
    assert tz.verify_mpc_chain(bad) is False
    assert jz.verify_mpc_chain(_to_jax(bad, rows, nc)) is False
    assert tz.verify_mpc_chain(pk) is True  # the forgery left the key alone
