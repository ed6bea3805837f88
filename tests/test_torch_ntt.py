"""circom_compat_tpu_torch witness map (ops/ntt.py) against the JAX package.

The port runs the four-step chain of row kernels below 1024 and from 2^14
up, and the flat chain in between (tests/test_torch_flat_ntt.py); the JAX
package's witness_map_impl on the CPU runs its XLA radix-2 path, and
circom/qap.py is the host oracle of both. Held equal here:
  - the four-step NTTPlan tables (row roots, t3, coset4) against the JAX
    plan's, on a square and a non-square split;
  - witness_map on squaring-chain circuits at n = 256 (four-step) and 1024
    (flat) against ntt.witness_map_impl and the JAX package's circom/qap.py;
  - witness_map_four_step, called by name, on seeded vectors at n = 2048
    against the JAX package, and witness_map at n = 4 .. 64 against the
    port's own host oracle.
Inputs come from a numpy seed. Tolerance: exact equality of canonical Fr
values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_compat_tpu.circom import qap as jqap
from circom_compat_tpu.constants import R_SCALAR
from circom_compat_tpu.ops import ntt as jntt
from circom_compat_tpu_torch.circom import qap as tqap
from circom_compat_tpu_torch.ops import field_kernels as fk
from circom_compat_tpu_torch.ops import limbs as tl
from circom_compat_tpu_torch.ops import ntt as tntt
from circom_compat_tpu_torch.utils.chain import chain_circuit

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
RNG = np.random.default_rng(0x4E77)
MONT = 1 << 256


def _mont_words(vals):
    return torch.from_numpy(tl.ints_to_words([v % R_SCALAR * MONT % R_SCALAR for v in vals]))


def _canon_plain(words):
    """Lazy Montgomery words -> canonical plain ints."""
    rinv = pow(MONT, -1, R_SCALAR)
    return [v * rinv % R_SCALAR for v in tl.words_to_ints(np.asarray(words).reshape(-1, 8))]


def _to_jax(words):
    return jnp.asarray(np.ascontiguousarray(np.asarray(words)).view("<u2").astype(np.uint32))


def _jax_words(limbs):
    return np.ascontiguousarray(np.asarray(limbs).astype("<u2")).view("<i4")


@pytest.mark.parametrize("n", [1024, 2048])
def test_plan_tables_match_jax(n):
    tb = tntt.get_plan(n).tables("cpu", "four_step")
    jp = jntt.get_plan(n)
    assert (tntt.get_plan(n).n1, tntt.get_plan(n).n2) == (jp.n1, jp.n2)
    for name in ("tw1_inv", "tw1_fwd", "tw2_inv", "tw2_fwd", "t3_inv", "t3_fwd", "coset4"):
        want = _jax_words(np.asarray(getattr(jp, f"{name}_lm")).T)
        assert np.array_equal(tb[name].reshape(-1, 8).numpy(), want), name


def _coo(rows_list):
    rows, cols, vals = [], [], []
    for r, entries in enumerate(rows_list):
        for v, sig in entries:
            rows.append(r)
            cols.append(sig)
            vals.append(v)
    return np.array(rows), np.array(cols), vals


@pytest.mark.parametrize("log_n", [8, 10])
def test_witness_map_vs_jax_and_qap(log_n):
    n = 1 << log_n
    c = chain_circuit(k=n - 2, a=int(RNG.integers(2, 1 << 30)))
    asg = c.full_assignment()
    ma, mb, _ = c.to_matrices()
    n_cons, n_in = len(c.r1cs.constraints), c.r1cs.num_inputs
    (ar, ac, av), (br, bc, bv) = _coo(ma), _coo(mb)
    plan = tntt.get_plan(n)
    got = tntt.witness_map(plan, torch.from_numpy(ar), torch.from_numpy(ac), _mont_words(av),
                           torch.from_numpy(br), torch.from_numpy(bc), _mont_words(bv),
                           _mont_words(asg), n_cons, n_in)
    got = _canon_plain(got)
    want_jax = jntt.witness_map_impl(
        jntt.get_plan(n), jnp.asarray(ar.astype(np.int32)), jnp.asarray(ac.astype(np.int32)),
        _to_jax(_mont_words(av)), jnp.asarray(br.astype(np.int32)),
        jnp.asarray(bc.astype(np.int32)), _to_jax(_mont_words(bv)), _to_jax(_mont_words(asg)),
        n_cons, n_in)
    assert got == _canon_plain(_jax_words(want_jax))
    assert got == jqap.witness_map_from_matrices(ma, mb, n_in, n_cons, asg)


def test_witness_map_from_ab_vs_jax_non_square():
    """n = 2048: n1 = 32 rows against n2 = 64 rows. The four-step chain is
    called by name: witness_map_from_ab takes the flat chain at this size."""
    n = 2048
    a, b = ([int.from_bytes(RNG.bytes(32), "little") % R_SCALAR for _ in range(n)] for _ in range(2))
    got = tntt.witness_map_four_step(tntt.get_plan(n), _mont_words(a), _mont_words(b))
    want = jntt.witness_map_from_ab(jntt.get_plan(n), _to_jax(_mont_words(a)), _to_jax(_mont_words(b)))
    assert _canon_plain(got) == _canon_plain(_jax_words(want))


@pytest.mark.parametrize("log_n", [2, 3, 4, 5, 6])
def test_witness_map_small_domains_vs_qap(log_n):
    """The four-step chain at every small size (n1 = 2^floor(log n / 2))."""
    n = 1 << log_n
    c = chain_circuit(k=n - 2, a=3 + log_n)
    asg = c.full_assignment()
    ma, mb, _ = c.to_matrices()
    n_cons, n_in = len(c.r1cs.constraints), c.r1cs.num_inputs
    (ar, ac, av), (br, bc, bv) = _coo(ma), _coo(mb)
    got = tntt.witness_map(tntt.get_plan(n), torch.from_numpy(ar), torch.from_numpy(ac),
                           _mont_words(av), torch.from_numpy(br), torch.from_numpy(bc),
                           _mont_words(bv), _mont_words(asg), n_cons, n_in)
    want = tqap.witness_map_from_matrices(ma, mb, n_in, n_cons, asg)
    assert _canon_plain(got) == want
    assert tqap.domain_size_for(n_cons, n_in) == n


def test_witness_map_plain_ops_match_kernel_set():
    """ops=PLAIN (what chip_smoke.py holds the card's witness map against)
    is the same function as the default kernel set on CPU tensors."""
    n = 64
    a, b = (_mont_words([int(v) for v in RNG.integers(0, 1 << 62, size=n)]) for _ in range(2))
    plan = tntt.get_plan(n)
    assert torch.equal(tntt.witness_map_from_ab(plan, a, b),
                       tntt.witness_map_from_ab(plan, a, b, ops=fk.PLAIN))
