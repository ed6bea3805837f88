"""circom_compat_tpu_torch field arithmetic against the JAX package.

The port's plain versions (what its kernel wrappers run for CPU tensors)
are held against exact Python-int arithmetic, against field_jax (XLA), and
against the Pallas kernels they replace, run in interpret mode as
tests/test_field_pallas.py runs them: K1 (fr_mul/fr_mul_canon/fr_add/
fr_sub/fr_to_mont/fr_from_mont), K2 (fr_tile_scan) and K3/K4
(ntt_low_stages_lm / ntt_mid_stages_lm). Inputs come from a numpy seed and
are fed to both packages. Tolerance: exact equality of canonical values;
all arithmetic is integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_compat_tpu.constants import R_SCALAR
from circom_compat_tpu.ops import field_jax as fj
from circom_compat_tpu.ops import field_pallas as fp
from circom_compat_tpu.ops import ntt as jntt
from circom_compat_tpu_torch.ops import field as fl
from circom_compat_tpu_torch.ops import field_kernels as fk
from circom_compat_tpu_torch.ops import limbs as tl
from circom_compat_tpu_torch.ops import ntt as tntt

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
RNG = np.random.default_rng(0xF1E1D)
MONT = 1 << 256


def _rand(n, bound):
    return [int.from_bytes(RNG.bytes(32), "little") % bound for _ in range(n)]


def _lazy(n, p):
    """n values in [0, 2p), led by the edge values 0, 1, p-1 and 2p-1."""
    return [0, 1, p - 1, 2 * p - 1] + _rand(n - 4, 2 * p)


def _words(vals):
    return torch.from_numpy(tl.ints_to_words(vals))


def _ints(words):
    return tl.words_to_ints(np.asarray(words))


def _to_jax(words):
    """(..., 8) port words -> (..., 16) uint32 limbs of the JAX package."""
    return jnp.asarray(np.ascontiguousarray(np.asarray(words)).view("<u2").astype(np.uint32))


def _from_jax(limbs):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(limbs).astype("<u2")).view("<i4"))


def _canon(vals, p):
    return [v % p for v in vals]


@pytest.mark.parametrize("spec,jspec", [(fl.FR, fj.FR), (fl.FQ, fj.FQ)], ids=["fr", "fq"])
def test_plain_ops_vs_ints_and_field_jax(spec, jspec):
    p = spec.modulus
    a, b = _lazy(64, p), _lazy(64, p)[::-1]
    A, B = fl.words_to_limbs(_words(a)), fl.words_to_limbs(_words(b))
    rinv = pow(MONT, -1, p)
    lazy_mul = _ints(fl.limbs_to_words(fl.mont_mul_lazy(spec, A, B)))
    canon_mul = _ints(fl.limbs_to_words(fl.mont_mul(spec, A, B)))
    add = _ints(fl.limbs_to_words(fl.add_lazy(spec, A, B)))
    sub = _ints(fl.limbs_to_words(fl.sub_lazy(spec, A, B)))
    assert all(v < 2 * p for v in lazy_mul + add + sub)
    assert canon_mul == [x * y * rinv % p for x, y in zip(a, b)]
    assert _canon(lazy_mul, p) == canon_mul
    assert _canon(add, p) == [(x + y) % p for x, y in zip(a, b)]
    assert _canon(sub, p) == [(x - y) % p for x, y in zip(a, b)]
    # field_jax takes canonical operands: reduce the lazy inputs first
    ca, cb = _canon(a, p), _canon(b, p)
    ja, jb = _to_jax(tl.ints_to_words(ca)), _to_jax(tl.ints_to_words(cb))
    Ca, Cb = fl.words_to_limbs(_words(ca)), fl.words_to_limbs(_words(cb))
    for jfn, tfn in ((fj.mont_mul, fl.mont_mul), (fj.add, fl.add_lazy), (fj.sub, fl.sub_lazy)):
        want = _canon(_ints(_from_jax(jfn(jspec, ja, jb))), p)
        assert _canon(_ints(fl.limbs_to_words(tfn(spec, Ca, Cb))), p) == want


@pytest.mark.parametrize("op,pallas", [("mul", fp.fr_mul), ("mul_canon", fp.fr_mul_canon),
                                       ("add", fp.fr_add), ("sub", fp.fr_sub)])
def test_fr_binary_vs_pallas(op, pallas):
    """K1 plain version vs _bin_blocked in interpret mode, lazy inputs."""
    r = R_SCALAR
    a, b = _words(_lazy(96, r)), _words(_lazy(96, r)[::-1])
    got = fk.fr_binary(op, a, b)
    want = _from_jax(pallas(_to_jax(a), _to_jax(b)))
    g, w = _ints(got), _ints(want)
    assert _canon(g, r) == _canon(w, r)
    assert all(v < (r if op == "mul_canon" else 2 * r) for v in g)
    # one operand broadcast: the to_mont / from_mont form
    elem = b[7]
    got_b = fk.fr_binary(op, a, elem)
    want_b = _from_jax(pallas(_to_jax(a), _to_jax(elem.expand_as(a).contiguous())))
    assert _canon(_ints(got_b), r) == _canon(_ints(want_b), r)


def test_fr_to_from_mont_vs_pallas():
    r = R_SCALAR
    plain = _words(_rand(40, r) + [0, 1, r - 1])
    mont = fk.fr_to_mont(plain)
    assert _canon(_ints(mont), r) == _canon(_ints(_from_jax(fp.fr_to_mont(_to_jax(plain)))), r)
    lazy = _words(_lazy(48, r))
    back = _ints(fk.fr_from_mont(lazy))
    assert back == _ints(_from_jax(fp.fr_from_mont(_to_jax(lazy))))  # both canonical
    assert back == [v * pow(MONT, -1, r) % r for v in _ints(lazy)]


def test_const_words_are_staged_once_a_device():
    """fr_to_mont / fr_from_mont and the curve's one read their constants
    through const_words: one tensor a (field, value, device), equal to
    words()."""
    one = fl.FR.const_words(1, "cpu")
    assert fl.FR.const_words(1, torch.device("cpu")) is one
    assert fl.FR.const_words(1) is one
    assert torch.equal(one, fl.FR.words(1))
    assert not torch.equal(fl.FQ.const_words(fl.FQ.one_mont), fl.FR.const_words(fl.FR.one_mont))


def test_fr_tile_scan_vs_pallas():
    """K2 plain version vs fr_tile_scan (block 128) in interpret mode."""
    T, K = 24, 16
    vt = _words(_lazy(T * K, R_SCALAR)).reshape(T, K, 8)
    ft = torch.from_numpy(RNG.random((T, K)) < 0.3)
    out, carry = fk.fr_tile_scan(vt, ft)
    j_out, j_carry = fp.fr_tile_scan(_to_jax(vt), jnp.asarray(ft.numpy()), block=128)
    assert _canon(_ints(out.reshape(-1, 8)), R_SCALAR) == \
        _canon(_ints(_from_jax(j_out).reshape(-1, 8)), R_SCALAR)
    assert _canon(_ints(carry), R_SCALAR) == _canon(_ints(_from_jax(j_carry)), R_SCALAR)


@pytest.mark.parametrize("L", [16, 128])
def test_row_tables_match_jax_plan(L):
    tb = tntt.get_plan(L * L).tables("cpu", "four_step")
    jplan = jntt.get_plan(L * L)
    for name in ("tw1_inv", "tw1_fwd", "tw2_inv", "tw2_fwd"):
        want = np.asarray(getattr(jplan, f"{name}_lm")).T
        assert torch.equal(tb[name], _from_jax(want)), name


def _row_case(L, mode, rows=3):
    """(port result, JAX Pallas result) of one row-kernel mode on rows of L."""
    log = L.bit_length() - 1
    tb = tntt.get_plan(L * L).tables("cpu", "four_step")
    jplan = jntt.get_plan(L * L)

    def stack(tbl):
        return jntt._low_tw_stack(jnp.asarray(tbl), L, log, L)

    x, pre, mid, post = (_words(_lazy(rows * L, R_SCALAR)).reshape(rows, L, 8) for _ in range(4))
    lm = {k: _to_jax(v.reshape(-1, 8)).T for k, v in dict(x=x, pre=pre, mid=mid, post=post).items()}
    if mode == "dif_pre_post_mul":
        got = fk.ntt_rows(x, tw_dif=tb["tw1_inv"], pre=pre, post=post)
        want = fp.ntt_low_stages_lm(lm["x"], stack(jplan.tw1_inv_lm), log, True, L,
                                    pre_lm=lm["pre"], post_lm=lm["post"])
    elif mode == "dit_pre_post_sub":
        got = fk.ntt_rows(x, tw_dit=tb["tw1_fwd"], pre=pre, post=post, post_op="sub")
        want = fp.ntt_low_stages_lm(lm["x"], stack(jplan.tw1_fwd_lm), log, False, L,
                                    pre_lm=lm["pre"], post_lm=lm["post"], post_op="sub")
    else:
        got = fk.ntt_rows(x, tw_dif=tb["tw2_inv"], mid=mid, tw_dit=tb["tw2_fwd"])
        want = fp.ntt_mid_stages_lm(lm["x"], stack(jplan.tw2_inv_lm), stack(jplan.tw2_fwd_lm),
                                    lm["mid"], log, log, L)
    return _ints(got.reshape(-1, 8)), _ints(_from_jax(np.asarray(want).T))


@pytest.mark.parametrize("L,mode", [
    (16, "dif_pre_post_mul"), (16, "dit_pre_post_sub"), (128, "mid")])
def test_ntt_rows_vs_pallas(L, mode):
    """K3 (low stages, fused pre/post) and K4 (mid mode) plain versions vs
    ntt_low_stages_lm / ntt_mid_stages_lm in interpret mode."""
    got, want = _row_case(L, mode)
    assert _canon(got, R_SCALAR) == _canon(want, R_SCALAR)
    assert all(v < 2 * R_SCALAR for v in got)


def test_ntt_rows_is_a_transform():
    """One DIF row transform then the DIT inverse (with the 1/L scale as
    post-multiply) gives back the input: the row kernel's own semantics."""
    L, rows = 32, 2
    tb = tntt.get_plan(L * L).tables("cpu", "four_step")
    x = _words(_rand(rows * L, R_SCALAR)).reshape(rows, L, 8)
    inv_l = _words([pow(L, -1, R_SCALAR) * MONT % R_SCALAR] * (rows * L)).reshape(rows, L, 8)
    fwd_then_back = fk.ntt_rows(fk.ntt_rows(x, tw_dif=tb["tw1_fwd"]), tw_dit=tb["tw1_inv"],
                                post=inv_l)
    assert _canon(_ints(fwd_then_back.reshape(-1, 8)), R_SCALAR) == _ints(x.reshape(-1, 8))


# Every mode of the row kernel: (DIF table, DIT table, pre, mid, post, post_op)
_ROW_MODES = {
    "dif": (True, False, False, False, False, "mul"),
    "dit": (False, True, False, False, False, "mul"),
    "dif_pre_post_mul": (True, False, True, False, True, "mul"),
    "dit_pre_post_sub": (False, True, True, False, True, "sub"),
    "mid": (True, True, False, True, False, "mul"),
    "mid_pre_post_sub": (True, True, True, True, True, "sub"),
}


def _dft(a, w):
    """X_k = sum_i a_i w^(i k) mod r, by even/odd recursion (Python ints)."""
    n = len(a)
    if n == 1:
        return list(a)
    w2 = w * w % R_SCALAR
    even, odd = _dft(a[0::2], w2), _dft(a[1::2], w2)
    out, t = [0] * n, 1
    for k in range(n // 2):
        v = t * odd[k] % R_SCALAR
        out[k], out[k + n // 2] = (even[k] + v) % R_SCALAR, (even[k] - v) % R_SCALAR
        t = t * w % R_SCALAR
    return out


def _rev_list(a):
    bits = len(a).bit_length() - 1
    return [a[int(format(i, f"0{bits}b")[::-1], 2) if bits else 0] for i in range(len(a))]


def _row_reference(x, pre, mid, post, post_op, w_dif, w_dit):
    """One row through the kernel's semantics in field values (word / R mod
    r): x * pre, DIF (natural -> bit-reversed DFT by w_dif), * mid, DIT
    (bit-reversed -> natural DFT by w_dit), then post * x or post - x."""
    val = [v * pow(MONT, -1, R_SCALAR) % R_SCALAR for v in x]
    if pre is not None:
        val = [a * b % R_SCALAR for a, b in zip(val, pre)]
    if w_dif is not None:
        val = _rev_list(_dft(val, w_dif))
    if mid is not None:
        val = [a * b % R_SCALAR for a, b in zip(val, mid)]
    if w_dit is not None:
        val = _dft(_rev_list(val), w_dit)
    if post is not None:
        val = [(q * a if post_op == "mul" else q - a) % R_SCALAR for q, a in zip(post, val)]
    return val


@pytest.mark.parametrize("mode", sorted(_ROW_MODES))
@pytest.mark.parametrize("L", [1, 2, 4, 512, 1024])
def test_ntt_rows_modes(L, mode):
    """Every ntt_rows mode over a few rows of L: against the JAX package's
    ntt_low_stages_lm / ntt_mid_stages_lm in interpret mode (L = 2, 4: the
    modes those kernels take), and at every L against the transform
    property in field values (_row_reference); every output word < 2r."""
    has_dif, has_dit, has_pre, has_mid, has_post, post_op = _ROW_MODES[mode]
    rows, log = (3 if L <= 4 else 2), L.bit_length() - 1
    root = tntt.fr_root_of_unity(L) if L > 1 else 1
    w_inv = pow(root, -1, R_SCALAR)
    tw_inv = torch.from_numpy(tntt._power_table(w_inv, max(L // 2, 1)))
    tw_fwd = torch.from_numpy(tntt._power_table(root, max(L // 2, 1)))
    x, pre, mid, post = (_words(_lazy(max(rows * L, 4), R_SCALAR)[: rows * L]).reshape(rows, L, 8)
                         for _ in range(4))
    kw = dict(tw_dif=tw_inv if has_dif else None, tw_dit=tw_fwd if has_dit else None,
              pre=pre if has_pre else None, mid=mid if has_mid else None,
              post=post if has_post else None, post_op=post_op)
    got = fk.ntt_rows(x, **kw)
    got_ints = _ints(got.reshape(-1, 8))
    assert all(v < 2 * R_SCALAR for v in got_ints)
    rinv = pow(MONT, -1, R_SCALAR)
    got_vals = [v * rinv % R_SCALAR for v in got_ints]

    def vals(t):  # a (rows, L, 8) operand as field values per row
        return [[v * rinv % R_SCALAR for v in _ints(t[i])] for i in range(rows)]

    want = []
    for i in range(rows):
        want += _row_reference(_ints(x[i]), vals(pre)[i] if has_pre else None,
                               vals(mid)[i] if has_mid else None, vals(post)[i] if has_post else None,
                               post_op, w_inv if has_dif else None, root if has_dit else None)
    assert got_vals == want
    if L in (2, 4) and (not has_mid or mode == "mid"):
        def stack(tbl):
            return jntt._low_tw_stack(_to_jax(tbl).T, L, log, L)

        lm = {k: _to_jax(v.reshape(-1, 8)).T for k, v in dict(x=x, pre=pre, mid=mid, post=post).items()}
        if has_mid:
            jax_out = fp.ntt_mid_stages_lm(lm["x"], stack(tw_inv), stack(tw_fwd), lm["mid"], log, log, L)
        else:
            jax_out = fp.ntt_low_stages_lm(lm["x"], stack(tw_inv if has_dif else tw_fwd), log, has_dif, L,
                                           pre_lm=lm["pre"] if has_pre else None,
                                           post_lm=lm["post"] if has_post else None, post_op=post_op)
        assert _canon(got_ints, R_SCALAR) == _canon(_ints(_from_jax(np.asarray(jax_out).T)), R_SCALAR)
