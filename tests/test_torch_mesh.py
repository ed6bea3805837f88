"""circom_compat_tpu_torch parallel/mesh.py and parallel/msm_sharded.py on
the CPU, against the JAX package.

  - make_mesh cuts to n_devices and to a power of two, takes a device
    repeated, and without a card raises and names the argument;
  - all_gather / all_to_all / transpose_a2a on ["cpu"] * 4 give fresh
    tensors equal to a numpy stack or transpose;
  - tree_fold equals the JAX package's segments.tree_fold on plain ints
    with a combine that is not commutative;
  - msm_g1_sharded on 37 points, one of them infinity and one scalar zero,
    on meshes of 4 and 8 "cpu" entries, equals the JAX package's
    msm_g1_sharded on make_mesh(8) and refmath's MSM (the case of
    tests/test_msm_sharded.py).
Inputs come from a seed. Tolerance: exact equality (ints, arrays, affine
points).
"""

import random

import numpy as np
import pytest
import torch

from circom_compat_tpu.ops import curve_jax as cj
from circom_compat_tpu.ops import segments as jseg
from circom_compat_tpu.parallel.mesh import make_mesh as jax_make_mesh
from circom_compat_tpu.parallel.msm_sharded import msm_g1_sharded as jax_msm_g1_sharded
from circom_compat_tpu_torch.constants import R_SCALAR
from circom_compat_tpu_torch.ops import curve as cv
from circom_compat_tpu_torch.parallel import mesh as pm
from circom_compat_tpu_torch.parallel import msm_sharded as ms
from circom_compat_tpu_torch.refmath import curve as rc

torch.set_num_threads(1)
RNG = np.random.default_rng(0x3E5)


def test_make_mesh_cuts_to_a_power_of_two_and_repeats():
    mesh = pm.make_mesh(devices=["cpu"] * 6)
    assert mesh.size == 4 and mesh.shape == {pm.SHARD_AXIS: 4}
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.physical() == ["cpu"]
    assert pm.make_mesh(3, devices=["cpu"] * 8).size == 2
    assert pm.make_mesh(devices=["cpu"]).size == 1
    with pytest.raises(ValueError, match="at least one"):
        pm.make_mesh(devices=[])
    with pytest.raises(ValueError, match="cuda:0"):
        pm.make_mesh(devices=["cuda"] * 2)


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        pm.make_mesh()
    with pytest.raises(RuntimeError, match="devices="):
        ms.msm_g1_sharded(np.zeros((3, 2, 8), np.int32), [1, 2, 3])


def _shards(count, shape):
    return [torch.from_numpy(RNG.integers(-2**31, 2**31, size=shape, dtype=np.int32))
            for _ in range(count)]


def test_all_gather_gives_fresh_stacks():
    shards = _shards(4, (5, 3, 8))
    out = pm.all_gather(shards)
    want = np.stack([s.numpy() for s in shards])
    assert len(out) == 4
    ptrs = {s.data_ptr() for s in shards}
    for o in out:
        assert np.array_equal(o.numpy(), want)
        assert o.data_ptr() not in ptrs
        ptrs.add(o.data_ptr())
    out[0].zero_()  # a repeated device never aliases one shard's copy into another's
    assert np.array_equal(out[1].numpy(), want)
    assert np.array_equal(pm.all_gather(shards, ["cpu"])[0].numpy(), want)


def test_all_to_all_and_transpose_match_numpy():
    D, R, C = 4, 8, 12
    x = RNG.integers(-2**31, 2**31, size=(R, C, 8), dtype=np.int32)
    blocks = pm.scatter_rows(torch.from_numpy(x), pm.make_mesh(devices=["cpu"] * D))
    got = pm.all_to_all(blocks, 1, 0)  # device j: columns j of every row block
    for j, g in enumerate(got):
        assert np.array_equal(g.numpy(), x[:, j * C // D : (j + 1) * C // D])
    t = pm.transpose_a2a(blocks)
    assert np.array_equal(np.concatenate([b.numpy() for b in t]), x.transpose(1, 0, 2))
    assert len({b.data_ptr() for b in blocks + got + t}) == 3 * D
    assert np.array_equal(pm.gather_rows(blocks, "cpu").numpy(), x)
    assert np.array_equal(pm.rows_of(blocks, 6, 10, "cpu")[:2].numpy(), x[6:8])
    assert not pm.rows_of(blocks, 6, 10, "cpu")[2:].any()
    with pytest.raises(ValueError, match="differ"):
        pm.all_to_all(blocks, 1, 1)
    with pytest.raises(ValueError, match="split"):
        pm.all_to_all(pm.scatter_rows(torch.zeros(6, 3, 8), pm.make_mesh(devices=["cpu"] * 2)), 1, 0)


@pytest.mark.parametrize("length", [1, 2, 8])
def test_tree_fold_equals_jax(length):
    vals = RNG.integers(0, 1000, size=(length, 3), dtype=np.int64)

    def combine(a, b):  # not commutative: the halves' order shows
        return (a * 7 + b) % 1000003

    want = np.asarray(jseg.tree_fold(combine, vals, length))
    assert np.array_equal(pm.tree_fold(combine, vals, length), want)
    assert np.array_equal(pm.tree_fold(combine, torch.from_numpy(vals), length).numpy(), want)
    with pytest.raises(ValueError, match="power of two"):
        pm.tree_fold(combine, vals, 3)


@pytest.fixture(scope="module")
def msm_case():
    rng = random.Random(0x5A)  # the inputs of tests/test_msm_sharded.py
    n = 37  # not a multiple of the mesh size: pads with infinity
    pts = [rc.G1.mul(rc.g1_generator(), rng.randrange(1, 1 << 62)) for _ in range(n)]
    pts[4] = None
    scalars = [rng.randrange(R_SCALAR) for _ in range(n)]
    scalars[0] = 0
    jax_got = jax_msm_g1_sharded(cj.encode_g1_affine(pts), scalars, jax_make_mesh(8),
                                 window_bits=4)
    return pts, scalars, rc.G1.msm(pts, scalars), jax_got


@pytest.mark.parametrize("D", [4, 8])
def test_msm_g1_sharded_matches_jax_and_refmath(msm_case, D):
    pts, scalars, want, jax_got = msm_case
    assert jax_got == want
    mesh = pm.make_mesh(devices=["cpu"] * D)
    got = ms.msm_g1_sharded(cv.encode_g1_affine(pts), scalars, mesh, window_bits=2)
    assert got == want


def test_pad_shard_inputs_pads_with_infinity():
    xy = torch.ones(37, 2, 8, dtype=torch.int32)
    sc = torch.ones(37, 8, dtype=torch.int32)
    pxy, psc = ms.pad_shard_inputs(xy, sc, 8)
    assert pxy.shape == (40, 2, 8) and psc.shape == (40, 8)
    assert not pxy[37:].any() and not psc[37:].any()
    assert torch.equal(pxy[:37], xy)
    assert ms.msm_g1_sharded(torch.zeros(0, 2, 8, dtype=torch.int32), [],
                             pm.make_mesh(devices=["cpu"])) is None
