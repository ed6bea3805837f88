"""Radix-2 NTT over Fr and the snarkjs (CircomReduction) witness map.

The witness map evaluates the A and B constraint rows on the assignment
(two sparse row sums), puts the public inputs into A's tail, and returns
HZ = [A(x)B(x) - C(x)] on the coset of the 2n-th root of unity, C = A o B:
six transforms (iFFT and FFT of a, b and c) with the coset shift and the
pointwise products between them. Two chains compute it, chosen by domain
size as the JAX package chooses (circom_compat_tpu/ops/ntt.py:409, :451):

Flat chain (FLAT_MIN <= n < FOUR_STEP_MIN, witness_map_flat): each
iFFT is decimation in frequency (natural in, bit-reversed out) and each FFT
decimation in time (bit-reversed in, natural out), so the bit reversals
cancel. A transform is its stages above LOW_BLOCK in one
fr_butterfly_stages launch (K5a; at most four of them, as n < 2^14), and
its last log2(LOW_BLOCK) stages as one ntt_rows launch over rows of
LOW_BLOCK (K3): those stages pair elements inside
aligned blocks of LOW_BLOCK and take twiddles that are powers of the
LOW_BLOCK-th root, so each block is an independent LOW_BLOCK-point
transform. The coset table, bit-reversed and with 1/n folded in, rides the
FFT's first row launch as its pre-multiply; c = a o b, ab = a o b and
ab - c are fr_binary passes.

Four-step chain (every other size, witness_map_four_step): n = n1 * n2
with n1 = 2^floor(log2(n) / 2), each transform being row kernels (ntt_rows)
around two transposes, every pointwise pass fused into an adjacent row
kernel:
  - c = a o b rides the first iNTT kernel of the c chain (pre-multiply),
  - the twiddle t3_inv (1/n folded in) rides the n1 iNTT kernel (post),
  - the n2 iNTT stages, the coset multiply and the n2 NTT stages share one
    kernel (K4's mid mode: they sit in the same layout),
  - t3_fwd rides the final n1 NTT kernel (pre-multiply),
  - ab = a o b rides the b chain's final kernel (post-multiply), and
    ab - c the c chain's final kernel (post-subtract).
Below FLAT_MIN the JAX package runs plain XLA; the port keeps its kernels
there. Transposes are torch ops. Output is lazy [0, 2p); consumers
canonicalize.

The standalone transforms fft, ifft and coset_shift take and return
natural order, as the JAX package's (its ntt_core_batched with the plan's
bit reversal). They run on the same chains with one-directional tables
(NTTPlan.host_tables("fft" / "ifft" / "coset")): the flat chain's DIF
(one fr_butterfly_stages launch and one row launch) or the four-step
chain's two DIF row launches (the middle twiddle, with 1/n for the
inverse, as the first one's post-multiply), then one gather that puts the
bit-reversed output back in natural order, since no DIT follows to undo
it. The flat chain's 1/n and every coset multiply are fr_binary passes.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch

from ..constants import R_SCALAR, fr_root_of_unity
from . import field_kernels as fk
from . import segments

MONT_R = 1 << 256
LOW_BLOCK = 512  # row length of the flat chain's fused low stages
# The JAX package's dispatch (its four-step bound is a Mosaic lane rule),
# kept so that both packages run the same chain at each size; below
# FLAT_MIN the JAX package leaves the kernels and the port does not.
FLAT_MIN = 1024
FOUR_STEP_MIN = 1 << 14


def chain_for(n: int) -> str:
    """The chain the witness map runs at domain size n."""
    return "flat" if FLAT_MIN <= n < FOUR_STEP_MIN else "four_step"


def _power_table(w: int, n: int, scale: int = 1) -> np.ndarray:
    """[scale * w^i for i < n] in Montgomery form as (n, 8) int32 words."""
    acc = scale * MONT_R % R_SCALAR
    w %= R_SCALAR
    buf = bytearray()
    for _ in range(n):
        buf += acc.to_bytes(32, "little")
        acc = acc * w % R_SCALAR
    return np.frombuffer(bytes(buf), dtype="<i4").reshape(n, 8).copy()


def _rev(m: int) -> np.ndarray:
    log_m = m.bit_length() - 1
    idx = np.arange(m, dtype=np.int64)
    out = np.zeros(m, dtype=np.int64)
    for b in range(log_m):
        out |= ((idx >> b) & 1) << (log_m - 1 - b)
    return out


class NTTPlan:
    """Host tables of the witness map for one domain size, staged to a
    device once per device and chain (`tables`)."""

    def __init__(self, n: int):
        if n < 2 or n & (n - 1):
            raise ValueError("domain size must be a power of two >= 2")
        self.n = n
        self.log_n = n.bit_length() - 1
        self.n1 = 1 << (self.log_n // 2)
        self.n2 = n // self.n1
        self.chain = chain_for(n)
        self._staged: Dict[tuple, Dict[str, torch.Tensor]] = {}

    def _t3(self, inverse: bool) -> np.ndarray:
        """(n2, n1) twiddle of the middle step, entry (j2, k1) =
        w^(j2 * rev1(k1)); the inverse carries the 1/n scale."""
        root = fr_root_of_unity(self.n)
        w = pow(root, -1, R_SCALAR) if inverse else root
        scale = pow(self.n, -1, R_SCALAR) if inverse else 1
        tbl = _power_table(w, self.n, scale)
        idx = (np.arange(self.n2)[:, None] * _rev(self.n1)[None, :]) % self.n
        return tbl[idx.reshape(-1)].reshape(self.n2, self.n1, 8)

    def _coset4(self) -> np.ndarray:
        """Coset powers g^i (g the 2n-th root of unity) permuted to the
        (n1, n2) layout: entry (a, b) holds g^(rev1(a) + n1 * rev2(b))."""
        coset = _power_table(fr_root_of_unity(2 * self.n), self.n)
        idx = _rev(self.n1)[:, None] + self.n1 * _rev(self.n2)[None, :]
        return coset[idx.reshape(-1)].reshape(self.n1, self.n2, 8)

    def _row_table(self, m: int, inverse: bool) -> np.ndarray:
        w = pow(fr_root_of_unity(self.n), self.n // m, R_SCALAR)
        if inverse:
            w = pow(w, -1, R_SCALAR)
        return _power_table(w, max(m // 2, 1))

    def _coset_inv_bitrev(self) -> np.ndarray:
        """Coset powers g^i with 1/n folded in, bit-reversed: position p
        of a DIF output holds coefficient rev(p), which takes g^rev(p) / n."""
        tbl = _power_table(fr_root_of_unity(2 * self.n), self.n, pow(self.n, -1, R_SCALAR))
        return tbl[_rev(self.n)]

    def _transform_tables(self, inverse: bool) -> Dict[str, np.ndarray]:
        """One direction's tables of a standalone transform on this size's
        chain, with `perm`, the gather that takes the DIF's output to
        natural order."""
        if self.chain == "flat":
            out = {"tw": self._row_table(self.n, inverse),
                   "low": self._row_table(LOW_BLOCK, inverse), "perm": _rev(self.n)}
            if inverse:
                out["n_inv"] = _power_table(1, 1, pow(self.n, -1, R_SCALAR))[0]
            return out
        k = np.arange(self.n)
        # k = k1 + n1 k2 sits at row rev1(k1), column rev2(k2) of the (n1, n2) output
        perm = _rev(self.n1)[k % self.n1] * self.n2 + _rev(self.n2)[k // self.n1]
        return {"tw1": self._row_table(self.n1, inverse), "tw2": self._row_table(self.n2, inverse),
                "t3": self._t3(inverse), "perm": perm}

    def host_tables(self, chain: str) -> Dict[str, np.ndarray]:
        """The tables of the witness map's chain ("flat" or "four_step"),
        or of a standalone transform ("fft", "ifft") or coset shift
        ("coset")."""
        if chain in ("fft", "ifft"):
            return self._transform_tables(chain == "ifft")
        if chain == "coset":
            return {"coset": _power_table(fr_root_of_unity(2 * self.n), self.n)}
        if chain == "flat":
            if self.n < 2 * LOW_BLOCK:
                raise ValueError(f"the flat chain needs n >= {2 * LOW_BLOCK}")
            return {
                "tw_inv": self._row_table(self.n, True),
                "tw_fwd": self._row_table(self.n, False),
                "low_inv": self._row_table(LOW_BLOCK, True),
                "low_fwd": self._row_table(LOW_BLOCK, False),
                "coset_inv_bitrev": self._coset_inv_bitrev(),
            }
        return {
            "tw1_inv": self._row_table(self.n1, True),
            "tw1_fwd": self._row_table(self.n1, False),
            "tw2_inv": self._row_table(self.n2, True),
            "tw2_fwd": self._row_table(self.n2, False),
            "t3_inv": self._t3(True),
            "t3_fwd": self._t3(False),
            "coset4": self._coset4(),
        }

    def tables(self, device, chain: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """The tables of `chain` (host_tables; default the chain this size
        takes) on `device`, staged on first use."""
        chain = chain or self.chain
        key = (str(torch.device(device)), chain)
        if key not in self._staged:
            self._staged[key] = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                                 for k, v in self.host_tables(chain).items()}
        return self._staged[key]

    def release(self) -> None:
        """Drop the tables staged on devices; `tables` stages them again."""
        self._staged.clear()


@lru_cache(maxsize=4)
def get_plan(n: int) -> NTTPlan:
    return NTTPlan(n)


def sparse_eval(rows, cols, vals, assignment_mont, num_rows: int, ops=fk.KERNELS):
    """Row sums sum_j vals[j] * w[cols[j]] over rows sorted ascending:
    one Fr multiply, then a segmented reduce by row."""
    prods = ops.fr_binary("mul", vals, assignment_mont[cols])
    zero = torch.zeros(8, dtype=torch.int32, device=vals.device)
    return segments.reduce_by_sorted_key(
        lambda a, b: ops.fr_binary("add", a, b), prods, rows, num_rows, zero,
        ops.fr_tile_scan, ops.fr_tile_scan)


def witness_map(plan: NTTPlan, a_rows, a_cols, a_vals, b_rows, b_cols, b_vals,
                assignment_mont, num_constraints: int, num_inputs: int, ops=fk.KERNELS):
    """HZ evaluations (Montgomery, lazy) of the CircomReduction witness map.
    `ops` is the kernel set (field_kernels.KERNELS, or PLAIN to run the
    plain versions on the same device)."""
    a = sparse_eval(a_rows, a_cols, a_vals, assignment_mont, plan.n, ops)
    b = sparse_eval(b_rows, b_cols, b_vals, assignment_mont, plan.n, ops)
    a[num_constraints : num_constraints + num_inputs] = assignment_mont[:num_inputs]
    return witness_map_from_ab(plan, a, b, ops)


def witness_map_from_ab(plan: NTTPlan, a: torch.Tensor, b: torch.Tensor, ops=fk.KERNELS):
    """The six transforms and pointwise products, given A and B evaluated
    on the domain ((n, 8) Montgomery words), through the chain this size
    takes (chain_for)."""
    if plan.chain == "flat":
        return witness_map_flat(plan, a, b, ops)
    return witness_map_four_step(plan, a, b, ops)


def ntt_flat_dif(x: torch.Tensor, tw: torch.Tensor, low: torch.Tensor,
                 ops=fk.KERNELS) -> torch.Tensor:
    """(n, 8) natural order -> bit-reversed DIF transform with the table
    tw (n/2 powers of the root): the stages with half from n/2 down to
    LOW_BLOCK in one stage launch, then the low stages in one row launch
    (table `low`, the LOW_BLOCK-th root's powers). The counterpart of the
    JAX package's ntt_lm_dif (circom_compat_tpu/ops/ntt.py:307)."""
    n = x.shape[0]
    x = ops.fr_butterfly_stages(x, tw, LOW_BLOCK, n // 2, True)
    rows = x.reshape(n // LOW_BLOCK, LOW_BLOCK, 8)
    return ops.ntt_rows(rows, tw_dif=low).reshape(n, 8)


def ntt_flat_dit(x: torch.Tensor, tw: torch.Tensor, low: torch.Tensor, ops=fk.KERNELS,
                 pre=None) -> torch.Tensor:
    """Bit-reversed (n, 8) -> natural DIT transform, the mirror of
    ntt_flat_dif: the low stages first, in one row launch that also runs
    the optional (n, 8) pre-multiply, then the stages with half from
    LOW_BLOCK up to n/2 in one stage launch. The counterpart of ntt_lm_dit
    (circom_compat_tpu/ops/ntt.py:281)."""
    n = x.shape[0]
    shape = (n // LOW_BLOCK, LOW_BLOCK, 8)
    x = ops.ntt_rows(x.reshape(shape), tw_dit=low,
                     pre=None if pre is None else pre.reshape(shape)).reshape(n, 8)
    return ops.fr_butterfly_stages(x, tw, LOW_BLOCK, n // 2, False)


def witness_map_flat(plan: NTTPlan, a: torch.Tensor, b: torch.Tensor, ops=fk.KERNELS):
    """The witness map's transforms through the flat chain: three iFFT ->
    coset -> FFT chains (the coset table with 1/n rides each FFT's first
    row launch) and three fr_binary passes, the sequence of the JAX
    package's _witness_map_transforms_lm below FOUR_STEP_MIN
    (circom_compat_tpu/ops/ntt.py:493-509). Needs n >= 2 * LOW_BLOCK."""
    tb = plan.tables(a.device, "flat")

    def ifft_coset_fft(x):
        x = ntt_flat_dif(x, tb["tw_inv"], tb["low_inv"], ops)
        return ntt_flat_dit(x, tb["tw_fwd"], tb["low_fwd"], ops, pre=tb["coset_inv_bitrev"])

    c = ops.fr_binary("mul", a, b)
    a = ifft_coset_fft(a)
    b = ifft_coset_fft(b)
    ab = ops.fr_binary("mul", a, b)
    c = ifft_coset_fft(c)
    return ops.fr_binary("sub", ab, c)


def witness_map_four_step(plan: NTTPlan, a: torch.Tensor, b: torch.Tensor, ops=fk.KERNELS):
    """The witness map's transforms through the four-step chain (any size
    n >= 4)."""
    n, n1, n2 = plan.n, plan.n1, plan.n2
    tb = plan.tables(a.device, "four_step")
    rows = ops.ntt_rows

    def t_n1major(x):  # (n1, n2) element order -> rows of n1
        return x.reshape(n1, n2, 8).transpose(0, 1).contiguous()

    def t_n2major(x):  # rows of n1 -> rows of n2
        return x.reshape(n2, n1, 8).transpose(0, 1).contiguous()

    def half_chain(xT, pre=None):
        x = rows(xT, tw_dif=tb["tw1_inv"], pre=pre, post=tb["t3_inv"])
        x = rows(t_n2major(x), tw_dif=tb["tw2_inv"], mid=tb["coset4"], tw_dit=tb["tw2_fwd"])
        return t_n1major(x)

    aT, bT = t_n1major(a), t_n1major(b)
    a5 = half_chain(aT)
    b5 = half_chain(bT)
    c5 = half_chain(bT, pre=aT)  # transpose(c) = transpose(a) o transpose(b)
    a6 = rows(a5, tw_dit=tb["tw1_fwd"], pre=tb["t3_fwd"])
    ab6 = rows(b5, tw_dit=tb["tw1_fwd"], pre=tb["t3_fwd"], post=a6)
    res = rows(c5, tw_dit=tb["tw1_fwd"], pre=tb["t3_fwd"], post=ab6, post_op="sub")
    return t_n2major(res).reshape(n, 8)


def _transform(plan: NTTPlan, x: torch.Tensor, inverse: bool, ops) -> torch.Tensor:
    n = plan.n
    if tuple(x.shape) != (n, 8):
        raise ValueError(f"expected ({n}, 8) words, got {tuple(x.shape)}")
    tb = plan.tables(x.device, "ifft" if inverse else "fft")
    x = x.contiguous()
    if plan.chain == "flat":
        y = ntt_flat_dif(x, tb["tw"], tb["low"], ops)
    else:
        n1, n2 = plan.n1, plan.n2
        y = ops.ntt_rows(x.reshape(n1, n2, 8).transpose(0, 1).contiguous(), tw_dif=tb["tw1"],
                         post=tb["t3"])
        y = ops.ntt_rows(y.transpose(0, 1).contiguous(), tw_dif=tb["tw2"])
    y = y.reshape(n, 8)[tb["perm"]]
    if inverse and plan.chain == "flat":
        y = ops.fr_binary("mul", y, tb["n_inv"])
    return y


def fft(plan: NTTPlan, coeffs: torch.Tensor, ops=fk.KERNELS) -> torch.Tensor:
    """Coefficients -> evaluations [p(w^0), p(w^1), ...], (n, 8) Montgomery
    words in natural order in and out (lazy out)."""
    return _transform(plan, coeffs, False, ops)


def ifft(plan: NTTPlan, evals: torch.Tensor, ops=fk.KERNELS) -> torch.Tensor:
    """Evaluations -> coefficients, the inverse of fft (1/n included)."""
    return _transform(plan, evals, True, ops)


def coset_shift(plan: NTTPlan, coeffs: torch.Tensor, ops=fk.KERNELS) -> torch.Tensor:
    """coeffs[i] *= g^i with g the 2n-th root of unity: arkworks'
    distribute_powers (reference: src/circom/qap.rs:69-70); one fr_binary
    pass."""
    if tuple(coeffs.shape) != (plan.n, 8):
        raise ValueError(f"expected ({plan.n}, 8) words, got {tuple(coeffs.shape)}")
    return ops.fr_binary("mul", coeffs.contiguous(), plan.tables(coeffs.device, "coset")["coset"])
