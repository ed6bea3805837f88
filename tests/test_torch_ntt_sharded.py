"""circom_compat_tpu_torch parallel/ntt_sharded.py on the CPU, against the
JAX package.

  - get_dist_plan(256, D) for D = 2, 4, 8: n1, n2, td_perm and the tables
    (row twiddles, the (n2, n1) inter-step twiddles, 1/n) equal the JAX
    package's get_dist_plan word for word, and both refuse the same shapes;
  - the distributed fft / ifft (make_dist_ntt) on ["cpu"] * D at n = 256
    equal the JAX package's make_dist_ntt on make_mesh(D) and refmath's
    FFT, mod r (as tests/test_ntt_sharded.py);
  - the sharded witness map (make_sharded_witness_map, and the replicated
    evaluation of witness_map_dist) on chain254's matrices equals the
    port's single-device witness_map permuted by td_perm, mod r.
Inputs come from a seed. Tolerance: exact equality mod r.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_compat_tpu.ops import field_jax as fj
from circom_compat_tpu.parallel import ntt_sharded as jns
from circom_compat_tpu.parallel.mesh import make_mesh as jax_make_mesh
from circom_compat_tpu_torch.circom.zkey import read_zkey
from circom_compat_tpu_torch.constants import R_SCALAR
from circom_compat_tpu_torch.models import groth16_device as gd
from circom_compat_tpu_torch.ops import field_kernels as fk
from circom_compat_tpu_torch.ops import limbs as tl
from circom_compat_tpu_torch.parallel import mesh as pm
from circom_compat_tpu_torch.parallel import ntt_sharded as ns
from circom_compat_tpu_torch.parallel import prove_sharded as ps
from circom_compat_tpu_torch.refmath import poly
from circom_compat_tpu_torch.utils.chain import chain_circuit

torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
RNG = np.random.default_rng(0x4F7)
RINV = pow(1 << 256, -1, R_SCALAR)


def _ints(words):
    """Montgomery words (any shape (..., 8)) -> flat canonical ints."""
    arr = words.numpy() if isinstance(words, torch.Tensor) else np.asarray(words)
    return [v * RINV % R_SCALAR for v in tl.words_to_ints(arr.reshape(-1, 8))]


def _jax_words(limbs):
    return tl.words_view(np.asarray(limbs).astype(np.uint16))


@pytest.mark.parametrize("D", [2, 4, 8])
def test_plan_equals_jax(D):
    got, want = ns.get_dist_plan(256, D), jns.get_dist_plan(256, D)
    assert (got.n, got.n1, got.n2, got.n_devices) == (want.n, want.n1, want.n2, want.n_devices)
    assert np.array_equal(got.td_perm, want.td_perm)
    for name in ("tw1_fwd", "tw1_inv", "tw2_fwd", "tw2_inv", "twiddle_fwd", "twiddle_inv",
                 "n_inv"):
        assert np.array_equal(getattr(got, name), _jax_words(getattr(want, name))), name


@pytest.mark.parametrize("n,D", [(96, 2), (256, 3), (4, 8)])
def test_plan_refuses_what_jax_refuses(n, D):
    with pytest.raises(ValueError) as jerr:
        jns.get_dist_plan(n, D)
    with pytest.raises(ValueError) as err:
        ns.get_dist_plan(n, D)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_dist_fft_ifft_equal_jax(D):
    n = 256
    vals = [int.from_bytes(RNG.bytes(32), "little") % R_SCALAR for _ in range(n)]
    vals[:3] = [0, 1, R_SCALAR - 1]
    plan, jplan = ns.get_dist_plan(n, D), jns.get_dist_plan(n, D)
    mont = tl.ints_to_words([v * (1 << 256) % R_SCALAR for v in vals])
    fft_d, ifft_d = ns.make_dist_ntt(plan, pm.make_mesh(devices=["cpu"] * D))
    y = fft_d(torch.from_numpy(mont).reshape(plan.n1, plan.n2, 8))
    jf, ji = jns.make_dist_ntt(jplan, jax_make_mesh(D))
    jy = jax.jit(jf)(jnp.asarray(fj.encode_mont(vals, fj.FR)).reshape(jplan.n1, jplan.n2, 16))
    assert _ints(y) == fj.decode(np.asarray(jy).reshape(n, 16), fj.FR)
    td = _ints(y)
    assert [td[plan.td_perm[j]] for j in range(n)] == poly.fft(vals)
    back = ifft_d(y)
    assert _ints(back) == fj.decode(np.asarray(jax.jit(ji)(jy)).reshape(n, 16), fj.FR) == vals


@pytest.fixture(scope="module")
def chain254():
    pk, m = read_zkey(GOLDEN / "chain254.zkey")
    dpk = gd.DeviceProvingKey.build(pk, m, m.num_constraints, device="cpu")
    asg = torch.from_numpy(gd.encode_assignment(chain_circuit(k=254, a=3).full_assignment()))
    asg_mont = fk.fr_to_mont(asg)
    return dpk, asg_mont, _ints(dpk.matrices.witness_map(asg_mont))


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_witness_map_equals_single_device(chain254, D):
    dpk, asg_mont, want = chain254
    plan = ns.get_dist_plan(dpk.domain_size, D)
    mesh = pm.make_mesh(devices=["cpu"] * D)
    wm = ns.make_sharded_witness_map(plan, mesh, *ps._td_coo(dpk, plan, D))
    blocks = wm(asg_mont)
    assert [tuple(b.shape) for b in blocks] == [(plan.n // D, 8)] * D
    got = _ints(torch.cat(blocks))
    assert [got[plan.td_perm[j]] for j in range(plan.n)] == want

    # the replicated evaluation: rows mapped to TD positions, then the same chain
    m = dpk.matrices
    td = torch.from_numpy(plan.td_perm.astype(np.int64))

    def coo(rows, cols, vals):
        r = td[rows]
        order = torch.argsort(r, stable=True)
        return r[order], cols[order], vals[order]

    pub = td[m.num_constraints : m.num_constraints + m.num_inputs]
    got2 = _ints(ns.witness_map_dist(plan, mesh, *coo(m.a_rows, m.a_cols, m.a_vals),
                                     *coo(m.b_rows, m.b_cols, m.b_vals), asg_mont,
                                     m.num_constraints, m.num_inputs, pub))
    assert got2 == got


def test_partition_coo_td_pads_sorted():
    plan = ns.get_dist_plan(16, 2)
    rows = np.array([0, 1, 1, 9, 12])
    r, c, v = ns.partition_coo_td(plan, rows, np.arange(5), np.ones((5, 8), np.int32), 2)
    assert r.tolist() == [[0, 1, 1], [1, 4, 7]]  # shard 1 padded at its top row, local rows
    assert c.tolist() == [[0, 1, 2], [3, 4, 0]]
    assert not v[1, 2].any() and v[0].all() and v[1, :2].all()
