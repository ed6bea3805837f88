"""circom_compat_tpu_torch's standalone transforms (ops/ntt.fft, ifft,
coset_shift) against the JAX package's ntt.fft_impl, ifft_impl and
coset_shift_impl at n = 2^9 and 2^14 (the four-step row kernels' plain
versions) and 2^12 (the flat chain's): the same field elements in natural
order, ifft(fft(x)) = x, fft against Horner evaluation at sampled powers of
the root, and the refusal of a wrong shape. The port's outputs are lazy
[0, 2r) Montgomery words, so they are compared mod r. Inputs come from a
numpy seed. Tolerance: exact equality mod r.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_compat_tpu.ops import ntt as jntt
from circom_compat_tpu_torch.constants import R_SCALAR as R
from circom_compat_tpu_torch.constants import fr_root_of_unity
from circom_compat_tpu_torch.ops import limbs as tl
from circom_compat_tpu_torch.ops import ntt

torch.set_num_threads(1)
RNG = np.random.default_rng(0x7F7)
RINV = pow(1 << 256, -1, R)


def _mont_words(vals):
    return torch.from_numpy(tl.ints_to_words([(v << 256) % R for v in vals]))


def _plain(words) -> list:
    """Montgomery words (lazy accepted) -> canonical ints."""
    arr = np.asarray(words.numpy() if isinstance(words, torch.Tensor) else words)
    if arr.shape[-1] == 16:  # the JAX package's (n, 16) uint32 limbs
        arr = tl.words_view(arr.astype("<u2"))
    return [v * RINV % R for v in tl.words_to_ints(arr)]


@pytest.mark.parametrize("log_n", [9, 12, 14])
def test_transforms_match_jax(log_n):
    n = 1 << log_n
    plan = ntt.NTTPlan(n)
    assert plan.chain == ("flat" if log_n == 12 else "four_step")
    vals = [int.from_bytes(RNG.bytes(32), "little") % R for _ in range(n)]
    vals[0], vals[1] = 0, R - 1
    x = _mont_words(vals)
    jplan = jntt.get_plan(n)
    jx = jnp.asarray(x.numpy().view("<u2").reshape(n, 16).astype(np.uint32))
    evals = ntt.fft(plan, x)
    assert _plain(evals) == _plain(jntt.fft_impl(jplan, jx))
    assert _plain(ntt.ifft(plan, x)) == _plain(jntt.ifft_impl(jplan, jx))
    assert _plain(ntt.coset_shift(plan, x)) == _plain(jntt.coset_shift_impl(jplan, jx))
    assert _plain(ntt.ifft(plan, evals)) == vals
    w = fr_root_of_unity(n)
    got = _plain(evals)
    for k in RNG.integers(0, n, size=4).tolist():
        pt, acc = pow(w, k, R), 0
        for c in reversed(vals):
            acc = (acc * pt + c) % R
        assert got[k] == acc


def test_transforms_refuse_a_wrong_shape():
    plan = ntt.NTTPlan(16)
    for fn in (ntt.fft, ntt.ifft, ntt.coset_shift):
        with pytest.raises(ValueError, match="expected"):
            fn(plan, torch.zeros((8, 8), dtype=torch.int32))
