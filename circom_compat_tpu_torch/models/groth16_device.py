"""Groth16 prover on the card: witness map plus the five MSMs.

prove_prepared runs, for a staged DeviceProvingKey:
  1. the assignment into Montgomery form (fr_to_mont),
  2. the CircomReduction witness map (ops/ntt.py),
  3. h out of Montgomery form, canonical (fr_from_mont),
  4. one per-window digit sort per scalar vector: the assignment (shared
     by A, B1 and B2), its aux part (L) and h (H),
  5. the five MSMs' window sums: A, B1, L and H in G1 through one batched
     bucket reduce, B2 in G2 through another (ops/msm.py),
  6. on the host: the window sums decoded, Horner-folded, and the r/s
     randomizer algebra (assemble_proof).

Every entry point runs on the card unless the caller passes device="cpu",
where the kernel wrappers run their plain versions.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..circom.zkey import ConstraintMatrices, ProvingKey
from ..constants import R_SCALAR
from ..ops import curve as cv
from ..ops import field as fl
from ..ops import field_kernels as fk
from ..ops import limbs as limb_codec
from ..ops import msm as msm_ops
from ..ops import ntt
from ..refmath import curve as rc
from .groth16 import Proof


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to prove on the CPU "
                "with the kernels' plain versions")
        return torch.device("cuda")
    return torch.device(device)


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _sorted_coo(rows, cols, vals_mont_u16, device):
    order = np.argsort(np.asarray(rows), kind="stable")
    return (
        _to_device(np.asarray(rows, np.int64)[order], device),
        _to_device(np.asarray(cols, np.int64)[order], device),
        _to_device(limb_codec.words_view(np.asarray(vals_mont_u16)[order]), device),
    )


@dataclass
class DeviceProvingKey:
    """The proving key's query sections and sorted A/B matrices, staged on
    one device as Montgomery words: G1 sections (n, 2, 8), B2 (n, 2, 2, 8),
    matrix values (nnz, 8). The host ProvingKey keeps the vk and the few
    single points the r/s algebra needs."""

    pk: ProvingKey
    num_inputs: int
    num_constraints: int
    domain_size: int
    n_vars: int
    aux_len: int
    device: torch.device
    a_rows: torch.Tensor
    a_cols: torch.Tensor
    a_vals: torch.Tensor
    b_rows: torch.Tensor
    b_cols: torch.Tensor
    b_vals: torch.Tensor
    queries: Dict[str, torch.Tensor] = field(default_factory=dict)

    @staticmethod
    def build(pk: ProvingKey, matrices, num_constraints: int,
              num_inputs: Optional[int] = None, device=None) -> "DeviceProvingKey":
        dev = resolve_device(device)
        if num_inputs is None:
            num_inputs = matrices.num_instance_variables
        n = pk.n_vars
        if not (len(pk.a_query) == len(pk.b_g1_query) == len(pk.b_g2_query) == n):
            raise ValueError("A, B1 and B2 query sections must each hold n_vars points")
        queries = {
            name: _to_device(limb_codec.words_view(sec.limbs), dev)
            for name, sec in (("a", pk.a_query), ("b1", pk.b_g1_query),
                              ("l", pk.l_query), ("h", pk.h_query))
        }
        queries["b2"] = _to_device(
            limb_codec.words_view(pk.b_g2_query.limbs).reshape(n, 2, 2, 8), dev)
        ar, ac, av = _sorted_coo(matrices.a_rows, matrices.a_cols, matrices.a_values_mont, dev)
        br, bc, bv = _sorted_coo(matrices.b_rows, matrices.b_cols, matrices.b_values_mont, dev)
        return DeviceProvingKey(
            pk=pk, num_inputs=num_inputs, num_constraints=num_constraints,
            domain_size=pk.domain_size, n_vars=n, aux_len=len(pk.l_query), device=dev,
            a_rows=ar, a_cols=ac, a_vals=av, b_rows=br, b_cols=bc, b_vals=bv,
            queries=queries,
        )

    @staticmethod
    def from_matrix_rows(pk: ProvingKey, rows_a, rows_b, num_inputs: int,
                         num_constraints: int, device=None) -> "DeviceProvingKey":
        """Build from [(value, signal)] row lists (circuit-derived matrices)."""

        def coo(rows_list):
            rows, cols, vals = [], [], []
            for ri, entries in enumerate(rows_list):
                for v, sig in entries:
                    rows.append(ri)
                    cols.append(sig)
                    vals.append((v << 256) % R_SCALAR)
            return (np.array(rows, np.int64), np.array(cols, np.int64),
                    limb_codec.ints_to_limbs(vals, dtype=np.uint16).reshape(-1, 16))

        ar, ac, av = coo(rows_a)
        br, bc, bv = coo(rows_b)
        matrices = ConstraintMatrices(
            num_instance_variables=num_inputs,
            num_witness_variables=pk.n_vars - num_inputs + 1,
            num_constraints=num_constraints,
            a_rows=ar, a_cols=ac, a_values_mont=av,
            b_rows=br, b_cols=bc, b_values_mont=bv,
        )
        return DeviceProvingKey.build(pk, matrices, num_constraints, num_inputs, device)

    def nbytes(self) -> int:
        """Device bytes of the staged key (queries, matrices, NTT tables)."""
        tensors = [self.a_rows, self.a_cols, self.a_vals, self.b_rows, self.b_cols,
                   self.b_vals, *self.queries.values()]
        tables = ntt.get_plan(self.domain_size).tables(self.device).values()
        return sum(t.numel() * t.element_size() for t in [*tensors, *tables])


def default_window_bits(dpk: DeviceProvingKey) -> int:
    return msm_ops.pick_window_bits(max(dpk.n_vars, dpk.domain_size))


class _Stages:
    """Optional per-stage wall times: each stage ends in a device sync."""

    def __init__(self, times: Optional[dict], device: torch.device):
        self.times = times
        self.device = device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def __call__(self, name: str):
        if self.times is None:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0


def witness_map(dpk: DeviceProvingKey, asg_mont: torch.Tensor, ops=fk.KERNELS) -> torch.Tensor:
    """HZ (lazy Montgomery) for an assignment in Montgomery form."""
    return ntt.witness_map(
        ntt.get_plan(dpk.domain_size), dpk.a_rows, dpk.a_cols, dpk.a_vals,
        dpk.b_rows, dpk.b_cols, dpk.b_vals, asg_mont, dpk.num_constraints,
        dpk.num_inputs, ops)


def prove_core(dpk: DeviceProvingKey, asg_plain: torch.Tensor, window_bits: int,
               stage=None):
    """(n_vars, 8) canonical assignment words on the key's device ->
    (G1 window sums (4, W, 3, 8) for [A, B1, L, H], G2 sums (W, 3, 2, 8), h)."""
    stage = stage or _Stages(None, dpk.device)
    with stage("witness_map"):
        h = fk.fr_from_mont(witness_map(dpk, fk.fr_to_mont(asg_plain)))
    with stage("sorts"):
        q = dpk.queries
        sort_a = msm_ops.window_orders(asg_plain, window_bits)
        sort_l = msm_ops.window_orders(
            asg_plain[dpk.num_inputs : dpk.num_inputs + dpk.aux_len], window_bits)
        sort_h = msm_ops.window_orders(h[: len(q["h"])], window_bits)
    with stage("msm_g1"):
        g1 = msm_ops.window_sums([q["a"], q["b1"], q["l"], q["h"]],
                                 [sort_a, sort_a, sort_l, sort_h], window_bits)
    with stage("msm_g2"):
        g2 = msm_ops.window_sums([q["b2"]], [sort_a], window_bits)[0]
    return g1, g2, h


def assemble_proof(dpk: DeviceProvingKey, r: int, s: int, g1_sums, g2_sums,
                   window_bits: int) -> Proof:
    """Host: decode the window sums, Horner-fold, apply the r/s algebra."""
    g1o, g2o = rc.G1, rc.G2
    g_a_msm, g_b1_msm, g_l, g_h = (
        msm_ops.fold_windows_host(cv.decode_g1_proj(g1_sums[i]), g1o, window_bits)
        for i in range(4)
    )
    g_b2_msm = msm_ops.fold_windows_host(cv.decode_g2_proj(g2_sums), g2o, window_bits)
    pk = dpk.pk
    g_a = g1o.add(g1o.add(g_a_msm, pk.vk.alpha_g1), g1o.mul(pk.delta_g1, r))
    g_b1 = g1o.add(g1o.add(g_b1_msm, pk.beta_g1), g1o.mul(pk.delta_g1, s))
    g_b2 = g2o.add(g2o.add(g_b2_msm, pk.vk.beta_g2), g2o.mul(pk.vk.delta_g2, s))
    g_c = g1o.add(g_l, g_h)
    g_c = g1o.add(g_c, g1o.mul(g_a, s))
    g_c = g1o.add(g_c, g1o.mul(g_b1, r))
    g_c = g1o.add(g_c, g1o.mul(pk.delta_g1, (-r * s) % R_SCALAR))
    return Proof(a=g_a, b=g_b2, c=g_c)


def encode_assignment(full_assignment) -> np.ndarray:
    """Assignment -> (N, 8) int32 canonical words; an (N, 8) integer array
    is taken as words already."""
    if isinstance(full_assignment, np.ndarray) and full_assignment.ndim == 2:
        return np.ascontiguousarray(full_assignment).astype(np.int32)
    return fl.encode_plain(full_assignment)


def prove_prepared(dpk: DeviceProvingKey, r: int, s: int, full_assignment: Sequence[int],
                   window_bits: Optional[int] = None,
                   stage_times: Optional[dict] = None) -> Proof:
    """Prove with a staged key. stage_times, when a dict, receives the wall
    seconds of each stage (encode, witness_map, sorts, msm_g1, msm_g2,
    readback, assemble), each ended by a device sync."""
    if window_bits is None:
        window_bits = default_window_bits(dpk)
    stage = _Stages(stage_times, dpk.device)
    with stage("encode"):
        asg = _to_device(encode_assignment(full_assignment), dpk.device)
    g1, g2, _ = prove_core(dpk, asg, window_bits, stage)
    with stage("readback"):
        g1, g2 = g1.cpu().numpy(), g2.cpu().numpy()
    with stage("assemble"):
        return assemble_proof(dpk, r, s, g1, g2, window_bits)


def prove(pk: ProvingKey, r: int, s: int, matrices, num_inputs: int, num_constraints: int,
          full_assignment: Sequence[int], window_bits: Optional[int] = None,
          device=None) -> Proof:
    """Stage the key and prove once. `matrices` is a ConstraintMatrices or
    any object with `.a` / `.b` row lists [(value, signal)]."""
    if isinstance(matrices, ConstraintMatrices):
        dpk = DeviceProvingKey.build(pk, matrices, num_constraints, num_inputs, device)
    else:
        dpk = DeviceProvingKey.from_matrix_rows(pk, matrices.a, matrices.b, num_inputs,
                                                num_constraints, device)
    return prove_prepared(dpk, r, s, full_assignment, window_bits)
