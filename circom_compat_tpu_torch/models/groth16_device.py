"""Groth16 prover on the card: witness map plus the five MSMs.

prove_prepared runs, for a staged DeviceProvingKey:
  1. the assignment into Montgomery form (fr_to_mont),
  2. the CircomReduction witness map (ops/ntt.py),
  3. h out of Montgomery form, canonical (fr_from_mont),
  4. one per-window digit sort per scalar vector: the assignment (shared
     by A, B1 and B2), its aux part (L) and h (H),
  5. the five MSMs' window sums: A, B1, L and H in G1 through one batched
     bucket reduce, B2 in G2 through another (ops/msm.py),
  6. the proof's points (assemble_proof): on a card K10 Horner-folds the
     window sums and applies the r/s randomizer algebra there, and three
     points come back; sums on the CPU come back and the host folds.

Every prover takes its assignment upload (assignment_on), step 4 with
the digit-0 counts (msm_sorts) and step 6 (assemble_proof) from here.

Every entry point runs on the card unless the caller passes device="cpu",
where the kernel wrappers run their plain versions.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..circom.zkey import ConstraintMatrices, ProvingKey
from ..constants import R_SCALAR
from ..device import resolve_device  # noqa: F401  (re-exported: the port's device rule)
from ..ops import curve as cv
from ..ops import curve_kernels as ck
from ..ops import field as fl
from ..ops import field_kernels as fk
from ..ops import limbs as limb_codec
from ..ops import msm as msm_ops
from ..ops import ntt
from ..refmath import curve as rc
from ..utils import trace
from .groth16 import Proof


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _sorted_coo(rows, cols, vals_mont_u16, device):
    order = np.argsort(np.asarray(rows), kind="stable")
    return (
        _to_device(np.asarray(rows, np.int64)[order], device),
        _to_device(np.asarray(cols, np.int64)[order], device),
        _to_device(limb_codec.words_view(np.asarray(vals_mont_u16)[order]), device),
    )


def _stage_points(xy: np.ndarray, g2: bool, device) -> torch.Tensor:
    """Affine words (zero rows for infinity) -> projective words on device."""
    return cv.affine_to_proj(torch.from_numpy(xy), g2).to(device)


@dataclass
class DeviceMatrices:
    """What the witness map reads, on one device: the A/B matrices as COO
    sorted by row, values as Montgomery words (nnz, 8), with the NTT plan's
    tables for `domain_size` staged beside them."""

    num_inputs: int
    num_constraints: int
    domain_size: int
    device: torch.device
    a_rows: torch.Tensor
    a_cols: torch.Tensor
    a_vals: torch.Tensor
    b_rows: torch.Tensor
    b_cols: torch.Tensor
    b_vals: torch.Tensor

    @staticmethod
    def stage(matrices: ConstraintMatrices, num_constraints: int, num_inputs: int,
              domain_size: int, device: torch.device) -> "DeviceMatrices":
        ar, ac, av = _sorted_coo(matrices.a_rows, matrices.a_cols, matrices.a_values_mont, device)
        br, bc, bv = _sorted_coo(matrices.b_rows, matrices.b_cols, matrices.b_values_mont, device)
        ntt.get_plan(domain_size).tables(device)
        return DeviceMatrices(num_inputs, num_constraints, domain_size, device,
                              ar, ac, av, br, bc, bv)

    def witness_map(self, asg_mont: torch.Tensor, ops=fk.KERNELS) -> torch.Tensor:
        """HZ (lazy Montgomery) for an assignment in Montgomery form."""
        return ntt.witness_map(
            ntt.get_plan(self.domain_size), self.a_rows, self.a_cols, self.a_vals,
            self.b_rows, self.b_cols, self.b_vals, asg_mont, self.num_constraints,
            self.num_inputs, ops)

    def nbytes(self) -> int:
        """Device bytes of the matrices and the NTT tables."""
        tensors = [self.a_rows, self.a_cols, self.a_vals, self.b_rows, self.b_cols, self.b_vals,
                   *ntt.get_plan(self.domain_size).tables(self.device).values()]
        return sum(t.numel() * t.element_size() for t in tensors)


@dataclass
class DeviceProvingKey:
    """The proving key's query sections and the witness map's matrices,
    staged on one device as Montgomery words: G1 sections (n, 2, 8), B2
    (n, 2, 2, 8). The r/s algebra's key points are staged beside them
    (fixed_g1: alpha1, beta1, delta1 (3, 3, 8); fixed_g2: beta2, delta2
    (2, 3, 2, 8); projective, for K10); the host ProvingKey keeps the vk."""

    pk: ProvingKey
    n_vars: int
    aux_len: int
    device: torch.device
    matrices: DeviceMatrices
    fixed_g1: torch.Tensor
    fixed_g2: torch.Tensor
    queries: Dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def num_inputs(self) -> int:
        return self.matrices.num_inputs

    @property
    def domain_size(self) -> int:
        return self.matrices.domain_size

    @staticmethod
    def build(pk: ProvingKey, matrices, num_constraints: int,
              num_inputs: Optional[int] = None, device=None) -> "DeviceProvingKey":
        dev = resolve_device(device)
        with trace.span("key.stage", dev):
            return DeviceProvingKey._build(pk, matrices, num_constraints, num_inputs, dev)

    @staticmethod
    def _build(pk, matrices, num_constraints, num_inputs, dev) -> "DeviceProvingKey":
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
        fixed_g1, fixed_g2 = stage_fixed(pk, dev)
        return DeviceProvingKey(
            pk=pk, n_vars=n, aux_len=len(pk.l_query), device=dev,
            matrices=DeviceMatrices.stage(matrices, num_constraints, num_inputs,
                                          pk.domain_size, dev),
            queries=queries, fixed_g1=fixed_g1, fixed_g2=fixed_g2,
        )

    @staticmethod
    def from_matrix_rows(pk: ProvingKey, rows_a, rows_b, num_inputs: int,
                         num_constraints: int, device=None) -> "DeviceProvingKey":
        """Build from [(value, signal)] row lists (circuit-derived matrices)."""
        matrices = matrices_from_rows(rows_a, rows_b, num_inputs, num_constraints, pk.n_vars)
        return DeviceProvingKey.build(pk, matrices, num_constraints, num_inputs, device)

    def nbytes(self) -> int:
        """Device bytes of the staged key (queries, key points, matrices, NTT
        tables)."""
        return self.matrices.nbytes() + sum(t.numel() * t.element_size() for t in
                                            [*self.queries.values(), self.fixed_g1, self.fixed_g2])


def matrices_from_rows(rows_a, rows_b, num_inputs: int, num_constraints: int,
                       n_vars: int) -> ConstraintMatrices:
    """[(value, signal)] row lists -> ConstraintMatrices (COO, Montgomery
    value limbs), as a zkey would hold them."""

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
    return ConstraintMatrices(
        num_instance_variables=num_inputs,
        num_witness_variables=n_vars - num_inputs + 1,
        num_constraints=num_constraints,
        a_rows=ar, a_cols=ac, a_values_mont=av,
        b_rows=br, b_cols=bc, b_values_mont=bv,
    )


def default_window_bits(dpk: DeviceProvingKey) -> int:
    return msm_ops.pick_window_bits(max(dpk.n_vars, dpk.domain_size))


@contextmanager
def timed_stages(times: Optional[dict], keys: Dict[str, str]):
    """Collect the block's trace stages; when `times` is a dict, add the
    wall seconds of each stage whose leaf name `keys` maps to a key into
    times[key]. A collected stage on a CUDA device is ended by a device
    sync (utils/trace.py), so each time is its stage's own work."""
    if times is None:
        yield
        return
    with trace.collect() as tr:
        yield
    for path, seconds in tr.stages:
        key = keys.get(path.rsplit("/", 1)[-1])
        if key is not None:
            times[key] = times.get(key, 0.0) + seconds


# prove_prepared's stage_times keys, by trace leaf name
_PROVE_KEYS = {"prove.encode": "encode", "prove.witness_map": "witness_map", "sorts": "sorts",
               "msm_g1": "msm_g1", "msm_g2": "msm_g2", "readback": "readback",
               "fold": "assemble"}


def msm_sorts(scalars: Sequence[tuple], window_bits: int) -> List[tuple]:
    """Each entry of `scalars`, one device's (assignment, aux rows, h[, B2's
    own rows or None]) -> ((G1 sorts [A, B1, L, H], their digit-0 counts
    (4, W)), (G2 sorts [B2], counts (1, W))). B2 shares A's sort unless it
    has rows of its own. Every entry's sorts (window_orders) are queued
    first; then each entry's counts come back in one read for both groups
    (digit_zero_counts)."""
    sorts = [[msm_ops.window_orders(x, window_bits) for x in entry if x is not None]
             for entry in scalars]
    out = []
    for sa, sl, sh, *b2 in sorts:
        zeros = msm_ops.digit_zero_counts([sa, sa, sl, sh] + b2)
        out.append((([sa, sa, sl, sh], zeros[:4]), (b2, zeros[4:]) if b2 else ([sa], zeros[:1])))
    return out


def prove_core(dpk: DeviceProvingKey, asg_plain: torch.Tensor, window_bits: int):
    """(n_vars, 8) canonical assignment words on the key's device ->
    (G1 window sums (4, W, 3, 8) for [A, B1, L, H], G2 sums (W, 3, 2, 8), h)."""
    dev = dpk.device
    with trace.span("prove.witness_map", dev):
        h = fk.fr_from_mont(dpk.matrices.witness_map(fk.fr_to_mont(asg_plain)))
    with trace.span("prove.msm", dev):
        q = dpk.queries
        with trace.span("sorts", dev):
            (s1, z1), (s2, z2) = msm_sorts(
                [(asg_plain, asg_plain[dpk.num_inputs : dpk.num_inputs + dpk.aux_len],
                  h[: len(q["h"])])], window_bits)[0]
        with trace.span("msm_g1", dev):
            g1 = msm_ops.window_sums([q["a"], q["b1"], q["l"], q["h"]], s1, window_bits, zeros=z1)
        with trace.span("msm_g2", dev):
            g2 = msm_ops.window_sums([q["b2"]], s2, window_bits, zeros=z2)[0]
    return g1, g2, h


def stage_fixed(pk: ProvingKey, device):
    """The r/s algebra's key points as projective words on `device`:
    (alpha1, beta1, delta1) (3, 3, 8) and (beta2, delta2) (2, 3, 2, 8)."""
    return (_stage_points(cv.encode_g1_affine([pk.vk.alpha_g1, pk.beta_g1, pk.delta_g1]),
                          False, device),
            _stage_points(cv.encode_g2_affine([pk.vk.beta_g2, pk.vk.delta_g2]), True, device))


def _assemble_host(pk: ProvingKey, r: int, s: int, g1_sums, g2_sums, window_bits: int) -> Proof:
    """Host: decode the window sums, Horner-fold, apply the r/s algebra."""
    g1o, g2o = rc.G1, rc.G2
    g_a_msm, g_b1_msm, g_l, g_h = (
        msm_ops.fold_windows_host(cv.decode_g1_proj(g1_sums[i]), g1o, window_bits)
        for i in range(4)
    )
    g_b2_msm = msm_ops.fold_windows_host(cv.decode_g2_proj(g2_sums), g2o, window_bits)
    g_a = g1o.add(g1o.add(g_a_msm, pk.vk.alpha_g1), g1o.mul(pk.delta_g1, r))
    g_b1 = g1o.add(g1o.add(g_b1_msm, pk.beta_g1), g1o.mul(pk.delta_g1, s))
    g_b2 = g2o.add(g2o.add(g_b2_msm, pk.vk.beta_g2), g2o.mul(pk.vk.delta_g2, s))
    g_c = g1o.add(g_l, g_h)
    g_c = g1o.add(g_c, g1o.mul(g_a, s))
    g_c = g1o.add(g_c, g1o.mul(g_b1, r))
    g_c = g1o.add(g_c, g1o.mul(pk.delta_g1, (-r * s) % R_SCALAR))
    return Proof(a=g_a, b=g_b2, c=g_c)


def assemble_proof(pk: ProvingKey, r: int, s: int, g1_sums: torch.Tensor,
                   g2_sums: torch.Tensor, window_bits: int, fixed=None) -> Proof:
    """The proof from the five MSMs' window sums, G1 (4, W, 3, 8) [A, B1,
    L, H] and G2 (W, 3, 2, 8), in span prove.assemble; where they lie picks
    the route. On a card: K10 folds them and applies the r/s algebra there
    (span fold), with `fixed` the key's points (stage_fixed) where they lie
    on the sums' card and staged here otherwise, and three points come back
    and are decoded (span readback). On the CPU: read back (span readback),
    then the host decodes the sums, Horner-folds them and applies the r/s
    algebra (span fold)."""
    dev = g1_sums.device
    with trace.span("prove.assemble", dev):
        if g1_sums.is_cuda:
            if fixed is None or fixed[0].device != dev:
                fixed = stage_fixed(pk, dev)
            with trace.span("fold", dev):
                words = ck.proof_fold(g1_sums, g2_sums, *fixed, r, s, window_bits)
            with trace.span("readback", dev):
                a, b, c = ck.proof_points(words.cpu())
                return Proof(a=cv.decode_g1_proj(a)[0], b=cv.decode_g2_proj(b)[0],
                             c=cv.decode_g1_proj(c)[0])
        with trace.span("readback", dev):
            g1_sums, g2_sums = g1_sums.numpy(), g2_sums.numpy()
        with trace.span("fold", dev):
            return _assemble_host(pk, r, s, g1_sums, g2_sums, window_bits)


def encode_assignment(full_assignment) -> np.ndarray:
    """Assignment -> (N, 8) int32 canonical words. Takes Python ints, a
    prepared (N, 16) array of 16-bit limbs (the JAX package's layout, from
    read_wtns_limbs or calculate_witness_limbs) or (N, 8) int32 words."""
    if isinstance(full_assignment, np.ndarray) and full_assignment.ndim == 2:
        arr = full_assignment
        if arr.shape[1] == limb_codec.NUM_LIMBS:
            if arr.size and (arr.min() < 0 or arr.max() > limb_codec.LIMB_MASK):
                raise ValueError("a prepared assignment's (N, 16) limbs must each be < 2^16")
            return limb_codec.words_view(arr)
        if arr.shape[1] == limb_codec.WORDS:
            return np.ascontiguousarray(arr).astype(np.int32)
        raise ValueError(f"a prepared assignment is (N, 16) 16-bit limbs or (N, 8) int32 words, "
                         f"not shape {arr.shape}")
    return fl.encode_plain(full_assignment)


def assignment_on(full_assignment, device) -> torch.Tensor:
    """The assignment (encode_assignment's forms) as (N, 8) canonical words
    on `device`."""
    return _to_device(encode_assignment(full_assignment), device)


def prove_prepared(dpk: DeviceProvingKey, r: int, s: int, full_assignment: Sequence[int],
                   window_bits: Optional[int] = None,
                   stage_times: Optional[dict] = None) -> Proof:
    """Prove with a staged key. Its stages go to the active trace
    collectors (prove.encode, prove.witness_map, prove.msm with sorts,
    msm_g1 and msm_g2 nested, prove.assemble with readback and fold: fold
    then readback on a card).
    stage_times, when a dict, receives the wall seconds of each stage
    (encode, witness_map, sorts, msm_g1, msm_g2, readback, assemble), each
    ended by a device sync."""
    if window_bits is None:
        window_bits = default_window_bits(dpk)
    dev = dpk.device
    with timed_stages(stage_times, _PROVE_KEYS):
        with trace.span("prove.encode", dev):
            asg = assignment_on(full_assignment, dev)
        g1, g2, _ = prove_core(dpk, asg, window_bits)
        return assemble_proof(dpk.pk, r, s, g1, g2, window_bits, (dpk.fixed_g1, dpk.fixed_g2))


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
