"""Distributed radix-2 NTT over Fr: the four-step decomposition with
all_to_all transposes over the mesh (the JAX package's
parallel/ntt_sharded.py).

n = n1 * n2 (k = k1 + n1 k2, j = j1 n2 + j2, w the n-th root):
  X[k1 + n1 k2] = FFT_n2( w^(j2 k1) * FFT_n1(x[j1 n2 + j2] over j1) over j2 )

Layouts, both row-sharded over the mesh (device d holds rows
[d * rows / D, (d + 1) * rows / D)):
  NAT: M[j1, j2] = x[j1 * n2 + j2]   (coefficients, natural order)
  TD:  M[k1, k2] = X[k1 + n1 * k2]   (evaluations, transposed digits)
td_perm[j] is the TD flat position of natural index j.

The JAX package's local sub-FFTs are its plain XLA ntt_core_batched; the
port runs them through the K3/K4 row kernel (ops/field_kernels.ntt_rows,
rows of n1 or n2 <= 4096, so domains up to 2^24). A row kernel runs DIF
stages (natural in, bit-reversed out) and DIT stages (bit-reversed in,
natural out):

  fft_local_body / ifft_local_body (make_dist_ntt): NAT <-> TD in natural
    order, as the JAX bodies; after each DIF row launch a local gather puts
    the row back in natural order, the inter-step twiddle is a K1 multiply
    in the FFT and the row kernel's pre-multiply in the iFFT, 1/n a K1
    multiply by one element.
  The witness map's iFFT -> coset -> FFT (chain_transform) keeps the bit
    reversals instead, so that they cancel, and fuses every pointwise pass
    into a row launch, as the single-card four-step chain does
    (ops/ntt.py): three row launches and two all_to_alls a transform,
      1. DIF over k2 on (n1/D, n2) TD rows (K3; c = a o b as its pre),
      2. transpose: rows p2 (holding j2 = rev2(p2)), columns k1,
      3. pre w^-(rev2(p2) k1), DIF over k1, mid g^(rev1(q1) n2 + rev2(p2)) / n
         (the coset and 1/n), DIT over the columns, post w^(rev2(p2) k1)
         (K4, one launch),
      4. transpose: rows k1, columns p2,
      5. DIT over p2 (K3; ab = a o b or ab - c as its post),
    so its output is in the TD order of the JAX package, mod r (the
    kernels' values are lazy in [0, 2p) and skip multiplies by one).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..constants import R_SCALAR, fr_root_of_unity
from ..ops import field_kernels as fk
from ..ops import ntt as ntt_ops
from .mesh import Mesh, copy_to, gather_rows, scatter_rows, transpose_a2a

MONT_R = 1 << 256


def _words(value: int) -> np.ndarray:
    return np.frombuffer((value * MONT_R % R_SCALAR).to_bytes(32, "little"), "<i4").copy()


@dataclass(frozen=True, eq=False)
class DistNTTPlan:
    """Static data for one (domain size, mesh size) pair, as Montgomery
    (..., 8) int32 words: the sub-FFT row tables (m / 2 powers of the m-th
    root), the inter-step twiddles in the (n2, n1) layout the JAX package
    runs them in, 1/n and td_perm; the witness map's coset table with 1/n
    folded in is made on staging (chain_tables). Device copies are staged
    per mesh on first use."""

    n: int
    n1: int
    n2: int
    n_devices: int
    tw1_fwd: np.ndarray
    tw1_inv: np.ndarray
    tw2_fwd: np.ndarray
    tw2_inv: np.ndarray
    twiddle_fwd: np.ndarray  # (n2, n1, 8): w^(j2 k1)
    twiddle_inv: np.ndarray  # (n2, n1, 8): w^-(j2 k1)
    n_inv: np.ndarray  # (8,)
    td_perm: np.ndarray  # (n,): natural index j -> TD flat position
    _staged: Dict[tuple, List[Dict[str, torch.Tensor]]] = field(default_factory=dict, repr=False)

    def chain_tables(self) -> Dict[str, np.ndarray]:
        """The witness-map chain's (n2, n1, 8) operands, rows in bit-reversed
        j2 order (module docstring, step 3)."""
        rev1, rev2 = ntt_ops._rev(self.n1), ntt_ops._rev(self.n2)
        scaled = ntt_ops._power_table(fr_root_of_unity(2 * self.n), self.n,
                                      pow(self.n, -1, R_SCALAR))
        idx = rev1[None, :] * self.n2 + rev2[:, None]
        return {"twi": self.twiddle_inv[rev2], "twf": self.twiddle_fwd[rev2],
                "coset": scaled[idx.reshape(-1)].reshape(self.n2, self.n1, 8)}

    def shard_tables(self, devices: Sequence[torch.device], chain: bool = False
                     ) -> List[Dict[str, torch.Tensor]]:
        """Per shard, on its device: the row tables, the bit-reversal
        indices, 1/n and the shard's rows of the (n2, n1) tables (the
        natural twiddles, or with chain=True the witness-map chain's)."""
        devices = [torch.device(d) for d in devices]
        if len(devices) != self.n_devices:
            raise ValueError(f"the plan is for {self.n_devices} shards, not {len(devices)}")
        key = (tuple(str(d) for d in devices), chain)
        if key not in self._staged:
            rows = self.chain_tables() if chain else {"twiddle_fwd": self.twiddle_fwd,
                                                      "twiddle_inv": self.twiddle_inv}
            common = {"tw1_fwd": self.tw1_fwd, "tw1_inv": self.tw1_inv, "tw2_fwd": self.tw2_fwd,
                      "tw2_inv": self.tw2_inv, "n_inv": self.n_inv,
                      "rev1": ntt_ops._rev(self.n1), "rev2": ntt_ops._rev(self.n2)}
            per = self.n2 // self.n_devices
            staged = []
            for i, d in enumerate(devices):
                t = {k: copy_to(torch.from_numpy(np.ascontiguousarray(v)), d)
                     for k, v in common.items()}
                t.update({k: copy_to(torch.from_numpy(np.ascontiguousarray(v[i * per:(i + 1) * per])), d)
                          for k, v in rows.items()})
                staged.append(t)
            self._staged[key] = staged
        return self._staged[key]

    def release(self) -> None:
        """Drop the device copies; shard_tables stages them again."""
        self._staged.clear()


@lru_cache(maxsize=4)
def get_dist_plan(n: int, n_devices: int) -> DistNTTPlan:
    """The plan of an n-point transform over n_devices shards: n1 =
    2^max(log2 D, floor(log2 n / 2)), n2 = n / n1, both multiples of D (the
    all_to_all tiling), as the JAX package splits them."""
    if n < 1 or n & (n - 1):
        raise ValueError("domain size must be a power of two")
    log_n = n.bit_length() - 1
    log_d = n_devices.bit_length() - 1
    if n_devices < 1 or (1 << log_d) != n_devices:
        raise ValueError("n_devices must be a power of two")
    log_n1 = max(log_d, log_n // 2)
    log_n2 = log_n - log_n1
    if log_n2 < log_d:
        raise ValueError(f"domain 2^{log_n} too small to shard over {n_devices} devices")
    n1, n2 = 1 << log_n1, 1 << log_n2

    w = fr_root_of_unity(n)
    powers = ntt_ops._power_table(w, n)  # w^e for e < n
    e = np.arange(n2, dtype=np.int64)[:, None] * np.arange(n1, dtype=np.int64)[None, :] % n
    j = np.arange(n, dtype=np.int64)

    def row_table(m: int, inverse: bool) -> np.ndarray:
        root = pow(w, n // m, R_SCALAR)
        return ntt_ops._power_table(pow(root, -1, R_SCALAR) if inverse else root, max(m // 2, 1))

    return DistNTTPlan(
        n=n, n1=n1, n2=n2, n_devices=n_devices,
        tw1_fwd=row_table(n1, False), tw1_inv=row_table(n1, True),
        tw2_fwd=row_table(n2, False), tw2_inv=row_table(n2, True),
        twiddle_fwd=powers[e], twiddle_inv=powers[(n - e) % n],
        n_inv=_words(pow(n, -1, R_SCALAR)),
        td_perm=((j % n1) * n2 + j // n1).astype(np.int32),
    )


# ---------------------------------------------------------------------------
# per-shard bodies: lists of row blocks, one a mesh entry
# ---------------------------------------------------------------------------


def fft_local_body(plan: DistNTTPlan, x_blocks, tables, ops=fk.KERNELS) -> List[torch.Tensor]:
    """NAT row shards (n1/D, n2, 8) -> TD row shards, natural order in and
    out; `tables` from plan.shard_tables(devices)."""
    xt = transpose_a2a(x_blocks)  # (n2/D, n1): rows j2
    a = [ops.ntt_rows(x, tw_dif=t["tw1_fwd"])[:, t["rev1"]] for x, t in zip(xt, tables)]
    b = [ops.fr_binary("mul", x, t["twiddle_fwd"]) for x, t in zip(a, tables)]  # w^(j2 k1)
    bt = transpose_a2a(b)  # (n1/D, n2): rows k1
    return [ops.ntt_rows(x, tw_dif=t["tw2_fwd"])[:, t["rev2"]] for x, t in zip(bt, tables)]


def ifft_local_body(plan: DistNTTPlan, y_blocks, tables, ops=fk.KERNELS) -> List[torch.Tensor]:
    """TD row shards (n1/D, n2, 8) -> NAT row shards, natural order in and
    out, scaled by 1/n."""
    a = [ops.ntt_rows(y, tw_dif=t["tw2_inv"])[:, t["rev2"]] for y, t in zip(y_blocks, tables)]
    at = transpose_a2a(a)  # (n2/D, n1): rows j2, columns k1
    c = [ops.ntt_rows(x, pre=t["twiddle_inv"], tw_dif=t["tw1_inv"])[:, t["rev1"]]
         for x, t in zip(at, tables)]
    ct = transpose_a2a(c)  # (n1/D, n2): NAT
    return [ops.fr_binary("mul", x, t["n_inv"]) for x, t in zip(ct, tables)]


def make_dist_ntt(plan: DistNTTPlan, mesh: Mesh, ops=fk.KERNELS):
    """(fft_dist, ifft_dist) over global (n1, n2, 8) tensors: each scatters
    its input in row shards over the mesh, runs the body and gathers the
    result onto the mesh's lead device. fft_dist: NAT -> TD; ifft_dist:
    TD -> NAT."""
    tables = plan.shard_tables(mesh.devices)

    def fft_dist(x_nat: torch.Tensor) -> torch.Tensor:
        return gather_rows(fft_local_body(plan, scatter_rows(x_nat, mesh), tables, ops), mesh.lead)

    def ifft_dist(y_td: torch.Tensor) -> torch.Tensor:
        return gather_rows(ifft_local_body(plan, scatter_rows(y_td, mesh), tables, ops), mesh.lead)

    return fft_dist, ifft_dist


def chain_transform(tables, blocks, ops=fk.KERNELS, pre=None, post=None, post_op: str = "mul"):
    """iFFT -> coset shift -> FFT of TD row shards (n1/D, n2, 8), output in
    TD order: three row launches and two all_to_alls (module docstring).
    pre (per shard) multiplies the input, post multiplies (post_op "mul")
    or is subtracted from (post - x, "sub") the output."""
    a = [ops.ntt_rows(x, tw_dif=t["tw2_inv"], pre=None if pre is None else pre[i])
         for i, (x, t) in enumerate(zip(blocks, tables))]
    b = [ops.ntt_rows(x, pre=t["twi"], tw_dif=t["tw1_inv"], mid=t["coset"], tw_dit=t["tw1_fwd"],
                      post=t["twf"]) for x, t in zip(transpose_a2a(a), tables)]
    return [ops.ntt_rows(x, tw_dit=t["tw2_fwd"], post=None if post is None else post[i],
                         post_op=post_op)
            for i, (x, t) in enumerate(zip(transpose_a2a(b), tables))]


def transforms_from_ab(tables, a_blocks, b_blocks, ops=fk.KERNELS) -> List[torch.Tensor]:
    """HZ = A'B' - C' (C = A o B) on TD row shards: the c = a o b product
    rides the c chain's first launch, ab = a' o b' the b chain's last and
    ab - c' the c chain's last."""
    a5 = chain_transform(tables, a_blocks, ops)
    ab = chain_transform(tables, b_blocks, ops, post=a5)
    return chain_transform(tables, b_blocks, ops, pre=a_blocks, post=ab, post_op="sub")


def witness_map_dist(plan: DistNTTPlan, mesh: Mesh, a_rows_td, a_cols, a_vals, b_rows_td,
                     b_cols, b_vals, assignment_mont, num_constraints: int, num_inputs: int,
                     pub_positions_td, ops=fk.KERNELS) -> torch.Tensor:
    """The CircomReduction witness map with distributed transforms; the
    sparse evaluation runs once on the assignment's device. Matrix rows are
    TD flat positions, sorted (host-side, once a key), so the evaluation
    lands in the TD layout. Output: HZ (lazy Montgomery) in TD flat order on
    the assignment's device (pair it with the TD-permuted H points)."""
    n, dev = plan.n, assignment_mont.device
    a = ntt_ops.sparse_eval(a_rows_td, a_cols, a_vals, assignment_mont, n, ops)
    b = ntt_ops.sparse_eval(b_rows_td, b_cols, b_vals, assignment_mont, n, ops)
    a[pub_positions_td] = assignment_mont[:num_inputs]
    a_blocks = scatter_rows(a.reshape(plan.n1, plan.n2, 8), mesh)
    b_blocks = scatter_rows(b.reshape(plan.n1, plan.n2, 8), mesh)
    out = transforms_from_ab(plan.shard_tables(mesh.devices, chain=True), a_blocks, b_blocks, ops)
    return gather_rows(out, dev).reshape(n, 8)


# ---------------------------------------------------------------------------
# the fully sharded witness map: per-shard sparse evaluation and transforms
# ---------------------------------------------------------------------------


def partition_coo_td(plan: DistNTTPlan, rows_td, cols, vals, n_devices: int):
    """Sorted TD COO -> per-shard blocks with LOCAL row indices: shard d owns
    TD flat rows [d n / D, (d + 1) n / D), contiguous as the TD matrix is
    row-sharded on k1. Each shard's entries are padded to the longest with
    zero values at its top row, which keeps its rows sorted and adds
    nothing. Returns (D, nnz_max) int64 rows and cols and (D, nnz_max, 8)
    int32 value words (numpy)."""
    n = plan.n
    rows_per_dev = n // n_devices
    rows_td, cols, vals = np.asarray(rows_td), np.asarray(cols), np.asarray(vals)
    bounds = np.searchsorted(rows_td, np.arange(n_devices + 1) * rows_per_dev)
    nnz_max = max(int(np.diff(bounds).max()), 1)
    r_out = np.full((n_devices, nnz_max), rows_per_dev - 1, np.int64)
    c_out = np.zeros((n_devices, nnz_max), np.int64)
    v_out = np.zeros((n_devices, nnz_max, 8), np.int32)
    for d in range(n_devices):
        lo, hi = bounds[d], bounds[d + 1]
        r_out[d, : hi - lo] = rows_td[lo:hi] - d * rows_per_dev
        c_out[d, : hi - lo] = cols[lo:hi]
        v_out[d, : hi - lo] = vals[lo:hi]
    return r_out, c_out, v_out


def make_sharded_witness_map(plan: DistNTTPlan, mesh: Mesh, a_coo, b_coo, ops=fk.KERNELS):
    """witness_map(assignment_mont) -> HZ (lazy Montgomery) as TD row shards
    ((n / D, 8) on each mesh entry; their concatenation is the TD flat
    order). assignment_mont: one (n_vars, 8) tensor, copied to every shard,
    or a list of per-shard copies. a_coo / b_coo: partition_coo_td outputs;
    the public-input rows must have been folded into a_coo as (row =
    td(nc + i), col = i, value = one) entries: those rows hold no matrix
    coefficients, so adding equals setting."""
    if mesh.size != plan.n_devices:
        raise ValueError(f"the plan is for {plan.n_devices} shards, the mesh has {mesh.size}")
    n, n1, n2, D = plan.n, plan.n1, plan.n2, mesh.size
    tables = plan.shard_tables(mesh.devices, chain=True)

    def stage(coo):
        return [tuple(copy_to(torch.from_numpy(np.ascontiguousarray(arr[d])), dev) for arr in coo)
                for d, dev in enumerate(mesh.devices)]

    a_sh, b_sh = stage(a_coo), stage(b_coo)

    def witness_map(assignment_mont) -> List[torch.Tensor]:
        if isinstance(assignment_mont, torch.Tensor):
            assignment_mont = [copy_to(assignment_mont, d) for d in mesh.devices]
        a = [ntt_ops.sparse_eval(r, c, v, asg, n // D, ops).reshape(n1 // D, n2, 8)
             for (r, c, v), asg in zip(a_sh, assignment_mont)]
        b = [ntt_ops.sparse_eval(r, c, v, asg, n // D, ops).reshape(n1 // D, n2, 8)
             for (r, c, v), asg in zip(b_sh, assignment_mont)]
        return [x.reshape(n // D, 8) for x in transforms_from_ab(tables, a, b, ops)]

    return witness_map
