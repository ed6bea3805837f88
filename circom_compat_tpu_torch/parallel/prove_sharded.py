"""The Groth16 prove over a device mesh (the JAX package's
parallel/prove_sharded.py).

build_sharded_prover stages, per shard, its rows of the padded query
stack: G1 (4, n_pad / D, 2, 8) for [A, B1, L, H] and G2 (g2_pad / D, 2,
2, 8) for B2, zero rows (infinity) past each section's end. prove_sharded
then runs, one mesh-level stage at a time (each syncs every card of the
mesh while it records):

  prove.encode       the assignment's canonical words, one copy a shard;
  prove.witness_map  h. With dist_ntt (the default where get_dist_plan
                     splits the domain over the mesh) the sharded witness
                     map (ntt_sharded.make_sharded_witness_map): each shard
                     evaluates its TD rows of A and B and the transforms
                     run distributed, so h comes out in TD order and the H
                     points were permuted to match when the key was staged.
                     Without it the single-card witness map runs once, on
                     the mesh's lead device;
  prove.msm          sorts: every shard's digit sorts, then one read a shard
                     of their digit-0 counts (groth16_device.msm_sorts);
                     msm_g1 / msm_g2: each shard's window sums through the
                     batched bucket reduce (ops/msm.py); gather: the shards'
                     sums all-gathered onto the lead device and tree-folded
                     with K6/K7 adds;
  prove.assemble     K10 on a card, the host fold for CPU sums
                     (groth16_device.assemble_proof).

The msm_g1 and msm_g2 loops queue kernels on each shard's device with no
host read, so distinct cards run side by side. On a mesh that repeats one
card the shards run one after another on it: the sharded code path, not a
speed-up.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..constants import MONT_R_R
from ..models import groth16_device as gd
from ..models.groth16 import Proof
from ..models.streamed import stage_rows
from ..ops import field_kernels as fk
from ..ops import limbs as limb_codec
from ..ops import msm as msm_ops
from ..utils import trace
from . import ntt_sharded
from .mesh import Mesh, copy_to, rows_of
from .msm_sharded import fold_shard_sums


@dataclass
class ShardedProver:
    """A key staged over a mesh. shard_ids are the global indices of the
    shards this process holds (all of them in one process; a slice of them
    in each process of a multi-process prover), total the global count."""

    dpk: gd.DeviceProvingKey
    mesh: Mesh
    window_bits: int
    dist_ntt: bool
    n_pad: int
    g2_pad: int
    total: int
    shard_ids: List[int]
    g1: List[torch.Tensor]  # per shard (4, n_pad / total, 2, 8)
    g2: List[torch.Tensor]  # per shard (g2_pad / total, 2, 2, 8)
    h_scalars: Callable  # per-shard canonical assignments -> h row blocks


def _host_sections(pk, td_order: Optional[np.ndarray]):
    """Word views of the key's G1 sections [A, B1, L, H] and of B2; with
    td_order the H rows are permuted into TD flat order."""
    g1 = [limb_codec.words_view(sec.limbs) for sec in
          (pk.a_query, pk.b_g1_query, pk.l_query, pk.h_query)]
    if td_order is not None:
        h = np.empty((len(td_order), 2, 8), np.int32)
        stage_rows(g1[3], 0, h)
        g1[3] = h[td_order]
    return g1, limb_codec.words_view(pk.b_g2_query.limbs).reshape(-1, 2, 2, 8)


def _stage_shard(sections, lo: int, rows: int, device) -> torch.Tensor:
    buf = np.empty((len(sections), rows) + sections[0].shape[1:], np.int32)
    for m, sec in enumerate(sections):
        stage_rows(sec, lo, buf[m])
    return torch.from_numpy(buf).to(device)


def _matrices_on(m: gd.DeviceMatrices, device: torch.device) -> gd.DeviceMatrices:
    """The witness map's matrices on `device` (the key's own where it lies
    there already)."""
    if m.device == device:
        return m
    t = {f: copy_to(getattr(m, f), device)
         for f in ("a_rows", "a_cols", "a_vals", "b_rows", "b_cols", "b_vals")}
    return gd.DeviceMatrices(m.num_inputs, m.num_constraints, m.domain_size, device, **t)


def _td_coo(dpk: gd.DeviceProvingKey, plan, D: int):
    """The A and B matrices with rows mapped to TD flat positions, sorted,
    the public-input rows folded into A as (td(nc + i), i, one) entries,
    partitioned over D shards (ntt_sharded.partition_coo_td)."""
    m, td = dpk.matrices, plan.td_perm
    nc, ni = m.num_constraints, m.num_inputs

    def td_sorted(rows, cols, vals):
        r = td[rows].astype(np.int64)
        order = np.argsort(r, kind="stable")
        return r[order], cols[order], vals[order]

    one = limb_codec.ints_to_words([MONT_R_R])
    a = (np.concatenate([m.a_rows.cpu().numpy(), np.arange(nc, nc + ni)]),
         np.concatenate([m.a_cols.cpu().numpy(), np.arange(ni)]),
         np.concatenate([m.a_vals.cpu().numpy(), np.repeat(one, ni, axis=0)]))
    b = (m.b_rows.cpu().numpy(), m.b_cols.cpu().numpy(), m.b_vals.cpu().numpy())
    return (ntt_sharded.partition_coo_td(plan, *td_sorted(*a), D),
            ntt_sharded.partition_coo_td(plan, *td_sorted(*b), D))


def _build(dpk: gd.DeviceProvingKey, mesh: Mesh, total: int, shard_ids: Sequence[int],
           window_bits: Optional[int], dist_ntt: bool) -> ShardedProver:
    n_max = max(dpk.n_vars, dpk.domain_size)
    n_pad = -(-n_max // total) * total
    g2_pad = -(-dpk.n_vars // total) * total
    rows, rows2 = n_pad // total, g2_pad // total
    if window_bits is None:
        window_bits = msm_ops.pick_window_bits(rows)
    devices = mesh.devices
    if dist_ntt:
        plan = ntt_sharded.get_dist_plan(dpk.domain_size, total)
        wm = ntt_sharded.make_sharded_witness_map(plan, mesh, *_td_coo(dpk, plan, total))

        def h_scalars(asg: List[torch.Tensor]) -> List[torch.Tensor]:
            return [fk.fr_from_mont(h) for h in wm([fk.fr_to_mont(a) for a in asg])]

        td_order = np.argsort(plan.td_perm)
    else:
        matrices = _matrices_on(dpk.matrices, mesh.lead)

        def h_scalars(asg: List[torch.Tensor]) -> List[torch.Tensor]:
            return [fk.fr_from_mont(matrices.witness_map(fk.fr_to_mont(asg[0])))]

        td_order = None
    g1_host, g2_host = _host_sections(dpk.pk, td_order)
    return ShardedProver(
        dpk=dpk, mesh=mesh, window_bits=window_bits, dist_ntt=dist_ntt, n_pad=n_pad,
        g2_pad=g2_pad, total=total, shard_ids=list(shard_ids),
        g1=[_stage_shard(g1_host, g * rows, rows, d) for g, d in zip(shard_ids, devices)],
        g2=[_stage_shard([g2_host], g * rows2, rows2, d)[0] for g, d in zip(shard_ids, devices)],
        h_scalars=h_scalars)


def build_sharded_prover(dpk: gd.DeviceProvingKey, mesh: Mesh, window_bits: Optional[int] = None,
                         dist_ntt: Optional[bool] = None) -> ShardedProver:
    """Stage dpk's query sections over `mesh` (from the host key, so dpk
    may lie on any device). dist_ntt: run the witness map through the
    distributed four-step NTT; by default on when get_dist_plan splits the
    domain over the mesh. window_bits defaults to pick_window_bits of a
    shard's rows."""
    D = mesh.size
    if dist_ntt is None:
        try:
            ntt_sharded.get_dist_plan(dpk.domain_size, D)
            dist_ntt = True
        except ValueError:  # the domain does not split over D shards: replicate the map
            dist_ntt = False
    with trace.span("key.stage", mesh):
        return _build(dpk, mesh, D, range(D), window_bits, dist_ntt)


def sharded_proof(prover: ShardedProver, r: int, s: int, full_assignment,
                  gather: Callable) -> Proof:
    """The stages prove.encode, prove.witness_map and prove.msm: each
    shard's window sums, then gather(g1_sums, g2_sums) (lists of per-shard
    G1 (4, W, 3, 8) and G2 (W, 3, 2, 8) sums) in prove.msm/gather, whose
    (G1, G2) sums on one device assemble_proof turns into the proof."""
    mesh, w = prover.mesh, prover.window_bits
    dpk = prover.dpk
    rows, rows2 = prover.n_pad // prover.total, prover.g2_pad // prover.total
    ni, aux = dpk.num_inputs, dpk.aux_len
    with trace.span("prove.encode", mesh):
        words = gd.assignment_on(full_assignment, "cpu")
        asg = [copy_to(words, d) for d in mesh.devices]
    with trace.span("prove.witness_map", mesh):
        h = prover.h_scalars(asg)
    with trace.span("prove.msm", mesh):
        with trace.span("sorts", mesh):
            sorts = gd.msm_sorts([
                [rows_of(x, g * rows, (g + 1) * rows, d) for x in ([a], [a[ni : ni + aux]], h)]
                + [None if rows2 == rows else rows_of([a], g * rows2, (g + 1) * rows2, d)]
                for g, a, d in zip(prover.shard_ids, asg, mesh.devices)], w)
        with trace.span("msm_g1", mesh):
            g1 = [msm_ops.window_sums(list(q), s1, w, zeros=z1)
                  for q, ((s1, z1), _) in zip(prover.g1, sorts)]
        with trace.span("msm_g2", mesh):
            g2 = [msm_ops.window_sums([q], s2, w, zeros=z2)[0]
                  for q, (_, (s2, z2)) in zip(prover.g2, sorts)]
        del sorts
        with trace.span("gather", mesh):
            g1, g2 = gather(g1, g2)
    return gd.assemble_proof(dpk.pk, r, s, g1, g2, w, (dpk.fixed_g1, dpk.fixed_g2))


# prove_sharded's stage_times keys, by trace leaf name
_SHARDED_KEYS = {**gd._PROVE_KEYS, "gather": "gather"}


def prove_sharded(dpk: gd.DeviceProvingKey, prover: ShardedProver, r: int, s: int,
                  full_assignment, stage_times: Optional[dict] = None) -> Proof:
    """Prove over the prover's mesh: the per-shard window sums, gathered and
    folded on the lead device, then the proof there. The proof equals
    prove_prepared's for the same key, assignment, r and s.
    stage_times, when a dict, receives the wall seconds of each stage, as
    prove_prepared's (and "gather")."""
    if prover.dpk is not dpk:
        raise ValueError("the prover was built for another key")
    mesh = prover.mesh
    with gd.timed_stages(stage_times, _SHARDED_KEYS):
        return sharded_proof(prover, r, s, full_assignment, lambda g1, g2: (
            fold_shard_sums(g1, mesh.lead), fold_shard_sums(g2, mesh.lead)))
