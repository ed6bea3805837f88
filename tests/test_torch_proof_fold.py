"""K10 (ops/curve_kernels.proof_fold): the proof's A, B2 and C from the five
MSMs' window sums, a Horner fold each and the r/s algebra. On the CPU: its
plain version at a tiny size and assemble_proof's host route for sums on
the CPU, each against the JAX package's assemble_proof on the same
sums and its refmath's proof of the known discrete logs, and the key points
DeviceProvingKey stages for it. The helpers here build window sums of known
discrete logs; tests/test_torch_cuda.py uses them at full size on the card,
where the JAX package is not imported.
"""

import random
import types

import numpy as np
import pytest
import torch

from circom_compat_tpu_torch.constants import Q, R_SCALAR
from circom_compat_tpu_torch.ops import curve as cv
from circom_compat_tpu_torch.ops import curve_kernels as ck
from circom_compat_tpu_torch.ops import limbs as lc
from circom_compat_tpu_torch.refmath import curve as rc
from circom_compat_tpu_torch.refmath import field as rf

torch.set_num_threads(1)


def proj_words(points, g2: bool, rng) -> torch.Tensor:
    """Affine points (None for infinity) -> projective Montgomery words with
    a random Z each: (N, 3, 8) or (N, 3, 2, 8)."""
    vals = []
    for p in points:
        if g2:
            z = (rng.randrange(1, Q), rng.randrange(Q))
            coords = ([(0, 0), (1, 0), (0, 0)] if p is None
                      else [rf.fq2_mul(p[0], z), rf.fq2_mul(p[1], z), z])
            vals += [c for xy in coords for c in xy]
        else:
            z = rng.randrange(1, Q)
            vals += [0, 1, 0] if p is None else [p[0] * z % Q, p[1] * z % Q, z]
    words = lc.ints_to_words([(v << 256) % Q for v in vals])
    return torch.from_numpy(words.reshape((len(points), 3) + ((2, 8) if g2 else (8,))))


class FoldCase:
    """Window sums S = k G of known discrete logs k: G1 (4, W) for [A, B1, L,
    H] and G2 (W,) for B2 (k = 0 an identity window), and key points alpha1,
    beta1, delta1, beta2, delta2, with the proof refmath computes from them."""

    def __init__(self, W: int, c: int, rng):
        self.W, self.c, self.rng = W, c, rng
        self.g1_logs = [[rng.randrange(R_SCALAR) for _ in range(W)] for _ in range(4)]
        self.g2_logs = [rng.randrange(R_SCALAR) for _ in range(W)]
        self.keys = [rc.G1.mul(rc.g1_generator(), rng.randrange(1, R_SCALAR)) for _ in range(3)]
        self.keys2 = [rc.G2.mul(rc.g2_generator(), rng.randrange(1, R_SCALAR)) for _ in range(2)]
        self.pk = types.SimpleNamespace(
            vk=types.SimpleNamespace(alpha_g1=self.keys[0], beta_g2=self.keys2[0],
                                     delta_g2=self.keys2[1]),
            beta_g1=self.keys[1], delta_g1=self.keys[2])

    def sums(self, device=None):
        g1 = torch.stack([proj_words([rc.G1.mul(rc.g1_generator(), k) for k in row], False,
                                     self.rng) for row in self.g1_logs])
        g2 = proj_words([rc.G2.mul(rc.g2_generator(), k) for k in self.g2_logs], True, self.rng)
        return g1.to(device), g2.to(device)

    def fixed(self, device=None):
        return (proj_words(self.keys, False, self.rng).to(device),
                proj_words(self.keys2, True, self.rng).to(device))

    def expected(self, r: int, s: int):
        """(A, B2, C) affine, by the JAX package's refmath."""
        from circom_compat_tpu.refmath import curve as jrc

        G1, G2, g1, g2 = jrc.G1, jrc.G2, jrc.g1_generator(), jrc.g2_generator()

        def msm(logs):
            return sum(k << (self.c * w) for w, k in enumerate(logs)) % R_SCALAR

        am, b1m, lm, hm = (msm(row) for row in self.g1_logs)
        alpha, beta, delta = self.keys
        beta2, delta2 = self.keys2
        a = G1.add(G1.add(G1.mul(g1, am), alpha), G1.mul(delta, r))
        b1 = G1.add(G1.add(G1.mul(g1, b1m), beta), G1.mul(delta, s))
        b2 = G2.add(G2.add(G2.mul(g2, msm(self.g2_logs)), beta2), G2.mul(delta2, s))
        c = G1.add(G1.mul(g1, (lm + hm) % R_SCALAR), G1.add(G1.mul(a, s), G1.mul(b1, r)))
        return a, b2, G1.add(c, G1.mul(delta, -r * s % R_SCALAR))


    def jax_assemble(self, g1, g2, r: int, s: int):
        """(A, B2, C) from the JAX package's assemble_proof (groth16_jax) on
        the window sums g1 (4, W, 3, 8), g2 (W, 3, 2, 8), handed over in its
        layout: (X, Y, Z), each (4, W, 16) or (W, 2, 16) 16-bit limbs."""
        from circom_compat_tpu.models import groth16_jax

        def limbs(t, axis):
            words = np.ascontiguousarray(np.asarray(t), dtype="<i4")
            arr = words.view("<u2").astype(np.uint32).reshape(words.shape[:-1] + (16,))
            return tuple(np.take(arr, i, axis=axis) for i in range(3))

        p = groth16_jax.assemble_proof(types.SimpleNamespace(pk=self.pk), r, s, limbs(g1, 2),
                                       limbs(g2, 1), self.c)
        return p.a, p.b, p.c


def decode_fold(words: torch.Tensor):
    a, b, c = ck.proof_points(words.cpu())
    return cv.decode_g1_proj(a)[0], cv.decode_g2_proj(b)[0], cv.decode_g1_proj(c)[0]


@pytest.mark.parametrize("r, s", [(0, 7)])
def test_proof_fold_plain_vs_refmath(r, s):
    """W = 2 windows of 2 bits, 3-bit s and r = 0, an identity window in L:
    the plain version's A, B2 and C are the JAX package's assemble_proof's
    on the same sums, and its refmath's."""
    case = FoldCase(2, 2, random.Random(r * 8 + s))
    case.g1_logs[2][1] = 0
    g1, g2 = case.sums()
    got = decode_fold(ck.proof_fold(g1, g2, *case.fixed(), r, s, 2))
    assert got == case.jax_assemble(g1, g2, r, s) == case.expected(r, s)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_point_double_plain_vs_refmath(g2):
    """The doubling (RCB algorithm 9), on points with random Z and on the
    identity."""
    rng = random.Random(11)
    grp, gen = (rc.G2, rc.g2_generator()) if g2 else (rc.G1, rc.g1_generator())
    pts = [grp.mul(gen, rng.randrange(1, R_SCALAR)) for _ in range(3)] + [None]
    got = ck.point_double_plain(proj_words(pts, g2, rng))
    assert (cv.decode_g2_proj(got) if g2 else cv.decode_g1_proj(got)) == [grp.double(p)
                                                                           for p in pts]


@pytest.mark.parametrize("form", ["cpu_tensor"])
def test_assemble_proof_host_route(monkeypatch, form):
    """Sums that are CPU tensors take the host route (no proof_fold, no
    launch), and its proof is the JAX package's assemble_proof's on the
    same sums, and its refmath's."""
    from circom_compat_tpu_torch.models import groth16_device as gd

    def no_kernel(*args, **kwargs):
        raise AssertionError("the host route called proof_fold")

    monkeypatch.setattr(ck, "proof_fold", no_kernel)
    case = FoldCase(3, 5, random.Random(3))
    case.g1_logs[1][0] = 0
    g1, g2 = case.sums()
    r, s = random.Random(4).randrange(R_SCALAR), random.Random(5).randrange(R_SCALAR)
    launches = ck.LAUNCHES["proof_fold"]
    proof = gd.assemble_proof(case.pk, r, s, g1, g2, 5)
    assert (proof.a, proof.b, proof.c) == case.jax_assemble(g1, g2, r, s) == case.expected(r, s)
    assert ck.LAUNCHES["proof_fold"] == launches


def test_staged_key_points_decode():
    """DeviceProvingKey's fixed_g1 / fixed_g2 decode back to the key's
    alpha1, beta1, delta1 and beta2, delta2."""
    import pathlib

    from circom_compat_tpu_torch.circom.zkey import read_zkey
    from circom_compat_tpu_torch.models import groth16_device as gd

    pk, m = read_zkey(pathlib.Path(__file__).parent / "golden" / "chain254.zkey")
    dpk = gd.DeviceProvingKey.build(pk, m, m.num_constraints, device="cpu")
    assert cv.decode_g1_proj(dpk.fixed_g1) == [pk.vk.alpha_g1, pk.beta_g1, pk.delta_g1]
    assert cv.decode_g2_proj(dpk.fixed_g2) == [pk.vk.beta_g2, pk.vk.delta_g2]
    one = cv.proj_identity_const(False)[1]
    assert torch.equal(dpk.fixed_g1[:, 2], one.expand(3, 8))  # Z = one: staged affine
