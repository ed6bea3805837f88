"""circom_compat_tpu_torch's flat NTT chain (K5a/K5b, ops/ntt.py) against
the JAX package.

  - fr_butterfly_plain against the Pallas butterflies it replaces, run in
    interpret mode as tests/test_field_pallas.py runs them:
    fp.fr_butterfly_lm (K5a, DIT and DIF) and fp.fr_butterfly (K5b), on
    lazy [0, 2p) inputs;
  - fr_butterfly_stage at every stage of a 1024-point transform against
    the JAX package's _stage_slices -> fr_butterfly_lm -> _stage_merge;
  - fr_butterfly_stages (the flat chain's high stages in one call) against
    the same JAX stage loop (mod r) and against the stage-by-stage
    composition (word for word), and the flat chain making one such call
    a transform;
  - the flat tables against NTTPlan.tw_fwd_lm / tw_inv_lm /
    coset_inv_bitrev_lm, and the 512-point row table against the
    per-lane twiddles of _low_tw_stack;
  - the flat witness map against jntt._witness_map_transforms_lm at
    n = 1024, and against the port's four-step chain and circom/qap.py at
    2048 and 8192;
  - which chain each domain size takes.
Inputs come from a numpy seed. Tolerance: exact equality; the butterflies
and tables word for word, the witness maps as canonical Fr values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_compat_tpu.constants import R_SCALAR
from circom_compat_tpu.ops import field_pallas as fp
from circom_compat_tpu.ops import ntt as jntt
from circom_compat_tpu_torch.circom import qap as tqap
from circom_compat_tpu_torch.ops import field_kernels as fk
from circom_compat_tpu_torch.ops import limbs as tl
from circom_compat_tpu_torch.ops import ntt as tntt

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
RNG = np.random.default_rng(0xF1A7)
MONT = 1 << 256


def _lazy(n):
    """n Fr values in [0, 2r), led by 0, 1, r-1 and 2r-1."""
    return [0, 1, R_SCALAR - 1, 2 * R_SCALAR - 1] + [
        int.from_bytes(RNG.bytes(32), "little") % (2 * R_SCALAR) for _ in range(n - 4)]


def _words(vals):
    return torch.from_numpy(tl.ints_to_words(vals))


def _mont_words(vals):
    return _words([v % R_SCALAR * MONT % R_SCALAR for v in vals])


def _limbs(words):
    """(n, 8) port words -> (n, 16) uint32 limbs of the JAX package."""
    return np.ascontiguousarray(np.asarray(words)).view("<u2").astype(np.uint32)


def _from_limbs(limbs):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(limbs).astype("<u2")).view("<i4"))


def _canon_plain(words):
    rinv = pow(MONT, -1, R_SCALAR)
    return [v * rinv % R_SCALAR for v in tl.words_to_ints(np.asarray(words).reshape(-1, 8))]


@pytest.mark.parametrize("dif", [False, True], ids=["dit", "dif"])
def test_butterfly_plain_vs_pallas_lm(dif):
    """K5a: (16, M) limb-major halves, M = 512 (one Pallas block)."""
    u, v, tw = (_words(_lazy(512)) for _ in range(3))
    o1, o2 = fp.fr_butterfly_lm(*(jnp.asarray(_limbs(x).T) for x in (u, v, tw)), dif=dif)
    p1, p2 = fk.fr_butterfly_plain(u, v, tw, dif)
    assert torch.equal(p1, _from_limbs(np.asarray(o1).T))
    assert torch.equal(p2, _from_limbs(np.asarray(o2).T))
    assert all(x < 2 * R_SCALAR for x in tl.words_to_ints(torch.cat((p1, p2)).numpy()))


def test_butterfly_plain_vs_pallas_row_major():
    """K5b: the row-major DIT butterfly at block=128 (48 rows, padded)."""
    u, v, tw = (_words(_lazy(48)) for _ in range(3))
    o1, o2 = fp.fr_butterfly(*(jnp.asarray(_limbs(x)) for x in (u, v, tw)), block=128)
    p1, p2 = fk.fr_butterfly_plain(u, v, tw, dif=False)
    assert torch.equal(p1, _from_limbs(o1))
    assert torch.equal(p2, _from_limbs(o2))


@pytest.mark.parametrize("dif", [False, True], ids=["dit", "dif"])
def test_stage_vs_jax_slices_and_merge(dif):
    """Every stage of a 1024-point transform: the port's whole-vector stage
    against the JAX package's slice -> butterfly -> merge sequence with its
    broadcast stage twiddles (circom_compat_tpu/ops/ntt.py:237-258)."""
    n = 1024
    jp = jntt.get_plan(n)
    table_lm = jnp.asarray(jp.tw_inv_lm if dif else jp.tw_fwd_lm)
    table = _from_limbs(np.asarray(table_lm).T)
    x = _words(_lazy(n))
    x_lm = jnp.asarray(_limbs(x).T)
    half = 1
    while half < n:
        u, v = jntt._stage_slices(x_lm, n, half)
        o1, o2 = fp.fr_butterfly_lm(u, v, jntt._stage_tw(table_lm, n, half), dif=dif)
        want = _from_limbs(np.asarray(jntt._stage_merge(o1, o2, n, half)).T)
        assert torch.equal(fk.fr_butterfly_stage(x, table, half, dif), want), half
        half *= 2


def _mod_r(words):
    return [v % R_SCALAR for v in tl.words_to_ints(np.asarray(words).reshape(-1, 8))]


# (n, half_lo, half_hi): the flat chain's high stages at every flat size,
# and an R = 4 sub-range in the middle of the 8192-point one
STAGE_RANGES = [(n, tntt.LOW_BLOCK, n // 2) for n in (1024, 2048, 4096, 8192)] + [(8192, 1024, 2048)]


@pytest.mark.parametrize("dif", [False, True], ids=["dit", "dif"])
@pytest.mark.parametrize("n,half_lo,half_hi", STAGE_RANGES,
                         ids=[f"n{n}_{lo}-{hi}" for n, lo, hi in STAGE_RANGES])
def test_stages_vs_jax_stage_loop(n, half_lo, half_hi, dif):
    """fr_butterfly_stages (its plain version here) against the JAX
    package's stage loop over the same halves in the transform's order
    (DIF descending, DIT ascending; _stage_slices -> fr_butterfly_lm in
    interpret mode -> _stage_merge), mod r since Pallas words are lazy, and
    word for word against the composition of fr_butterfly_stage_plain."""
    jp = jntt.get_plan(n)
    table_lm = jnp.asarray(jp.tw_inv_lm if dif else jp.tw_fwd_lm)
    table = _from_limbs(np.asarray(table_lm).T)
    x = _words(_lazy(n))
    halves = [1 << k for k in range(n.bit_length()) if half_lo <= 1 << k <= half_hi]
    x_lm, composed = jnp.asarray(_limbs(x).T), x
    for half in halves[::-1] if dif else halves:
        u, v = jntt._stage_slices(x_lm, n, half)
        o1, o2 = fp.fr_butterfly_lm(u, v, jntt._stage_tw(table_lm, n, half), dif=dif)
        x_lm = jntt._stage_merge(o1, o2, n, half)
        composed = fk.fr_butterfly_stage_plain(composed, table, half, dif)
    got = fk.fr_butterfly_stages(x, table, half_lo, half_hi, dif)
    assert torch.equal(got, composed)
    assert torch.equal(fk.fr_butterfly_stages_plain(x, table, half_lo, half_hi, dif), composed)
    assert _mod_r(got) == _mod_r(_from_limbs(np.asarray(x_lm).T))
    assert all(v < 2 * R_SCALAR for v in tl.words_to_ints(got.numpy()))


@pytest.mark.parametrize("half_lo,half_hi", [(64, 2048), (1024, 512), (3, 12), (512, 8192)])
def test_stages_refuses_ranges_the_kernel_does_not_take(half_lo, half_hi):
    """More than 16 rows a column (R = 2 half_hi / half_lo), an empty range,
    halves that are not powers of two or beyond n/2 raise on the CPU as on
    the card."""
    n = 8192
    table = tntt.get_plan(n).tables("cpu", "flat")["tw_fwd"]
    with pytest.raises(ValueError):
        fk.fr_butterfly_stages(_words(_lazy(n)), table, half_lo, half_hi, True)


@pytest.mark.parametrize("n", [1024, 2048])
def test_flat_chain_runs_one_stages_call_a_transform(n):
    """The witness map's six transforms make six fr_butterfly_stages calls,
    each over half LOW_BLOCK .. n/2."""
    calls = []

    def stages(x, table, half_lo, half_hi, dif):
        calls.append((half_lo, half_hi, dif))
        return fk.fr_butterfly_stages_plain(x, table, half_lo, half_hi, dif)

    a, b = (_mont_words([int.from_bytes(RNG.bytes(32), "little") for _ in range(n)]) for _ in range(2))
    plan = tntt.get_plan(n)
    want = tntt.witness_map_flat(plan, a, b, fk.PLAIN)
    got = tntt.witness_map_flat(plan, a, b, fk.PLAIN._replace(fr_butterfly_stages=stages))
    assert torch.equal(got, want)
    assert calls == [(tntt.LOW_BLOCK, n // 2, dif) for dif in (True, False) * 3]


@pytest.mark.parametrize("n", [1024, 8192])
def test_flat_tables_match_jax(n):
    tb = tntt.get_plan(n).tables("cpu", "flat")
    jp = jntt.get_plan(n)
    for name, jname in (("tw_inv", "tw_inv_lm"), ("tw_fwd", "tw_fwd_lm"),
                        ("coset_inv_bitrev", "coset_inv_bitrev_lm")):
        assert torch.equal(tb[name], _from_limbs(np.asarray(getattr(jp, jname)).T)), name


@pytest.mark.parametrize("inverse", [True, False], ids=["inv", "fwd"])
def test_low_rows_match_low_tw_stack(inverse):
    """The row kernel's stage-s twiddle of lane l, low[(l % 2^s) * (256 >>
    s)] from the 512-th root table, is the JAX package's per-lane stack
    entry table[(l % 2^s) * (n >> (s + 1))] of the n-th root table."""
    n = 2048
    jp = jntt.get_plan(n)
    table_lm = jnp.asarray(jp.tw_inv_lm if inverse else jp.tw_fwd_lm)
    stack = np.asarray(jntt._low_tw_stack(table_lm, n, 9, 512))  # (9, 16, 512)
    low = tntt.get_plan(n).tables("cpu", "flat")["low_inv" if inverse else "low_fwd"]
    lanes = torch.arange(512)
    for s in range(9):
        got = low[(lanes % (1 << s)) * (256 >> s)]
        assert torch.equal(got, _from_limbs(stack[s].T)), s


def test_flat_witness_map_vs_jax_lm_1024():
    """The JAX package's limb-major Pallas pipeline takes its flat DIF/DIT
    chain at n = 1024 (interpret mode)."""
    n = 1024
    a, b = (_mont_words([int.from_bytes(RNG.bytes(32), "little") for _ in range(n)])
            for _ in range(2))
    got = tntt.witness_map_flat(tntt.get_plan(n), a, b)
    want = jntt._witness_map_transforms_lm(jntt.get_plan(n), jnp.asarray(_limbs(a)),
                                           jnp.asarray(_limbs(b)))
    assert _canon_plain(got) == _canon_plain(_from_limbs(want))


@pytest.mark.parametrize("n", [2048, 8192])
def test_flat_witness_map_vs_four_step_and_qap(n):
    """k = n - 2 constraints, one public input: circom/qap.py evaluates row
    i = [(a_i, 1)] on the assignment [5, 1] and puts 5 into A's tail."""
    k = n - 2
    a = [int(v) for v in RNG.integers(0, 1 << 62, size=k)] + [5, 0]
    b = [int(v) for v in RNG.integers(0, 1 << 62, size=k)] + [0, 0]
    plan = tntt.get_plan(n)
    flat = _canon_plain(tntt.witness_map_flat(plan, _mont_words(a), _mont_words(b)))
    assert flat == _canon_plain(tntt.witness_map_four_step(plan, _mont_words(a), _mont_words(b)))
    rows_a = [[(a[i], 1)] for i in range(k)]
    rows_b = [[(b[i], 1)] for i in range(k)]
    assert flat == tqap.witness_map_from_matrices(rows_a, rows_b, 1, k, [5, 1])


@pytest.mark.parametrize("n,chain", [(256, "four_step"), (512, "four_step"), (1024, "flat"),
                                     (4096, "flat"), (8192, "flat"), (1 << 14, "four_step")])
def test_dispatch(n, chain, monkeypatch):
    """1024 <= n < 2^14 takes the flat chain, as the JAX package's Pallas
    path does; 2^14 and up the four-step chain; below 1024 the four-step
    chain stays (the JAX package runs plain XLA there)."""
    calls = []
    monkeypatch.setattr(tntt, "witness_map_flat", lambda *a: calls.append("flat"))
    monkeypatch.setattr(tntt, "witness_map_four_step", lambda *a: calls.append("four_step"))
    plan = tntt.NTTPlan(n)
    assert plan.chain == tntt.chain_for(n) == chain
    tntt.witness_map_from_ab(plan, None, None)
    assert calls == [chain]
