"""The streamed prove over a device mesh (the JAX package's
parallel/streamed_sharded.py): host-resident query sections chunked into
the mesh.

The resident sharded prover (prove_sharded.py) stages whole padded
sections on each shard; the streamed prover (models/streamed.py) bounds
device memory but has one device. This module composes them. Each host
chunk of `chunk` rows is split D ways: part i, rows [lo + i chunk / D,
lo + (i + 1) chunk / D), goes to shard i through that shard's own pinned
buffers, device buffers and copy stream (models/streamed.ChunkPipe), and
the shard adds the part's bucket sums into its own (4, W, B) G1 and
(1, W, B) G2 accumulators with K6/K7. The bucket suffix scans, the gather
of the D window sums onto the lead device and their K6/K7 tree fold run
once, at the end, then assemble_proof (K10 on a card). A shard's part of
a chunk reads back its digit-0 counts once (groth16_device.msm_sorts).
Bucket sums are additive over any partition of the points, so the proof
equals the resident and streamed provers' for any chunk and mesh.

    device memory a shard = its part of a chunk (two buffer pairs) + its
                            accumulators + its slices of the scalars

The witness map stays replicated, as in the JAX package: it runs once, on
the key's device, and each shard receives its rows of the scalars.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..models import groth16_device as gd
from ..models import streamed as sm
from ..models.groth16 import Proof
from ..ops import curve as cv
from ..ops import curve_kernels as ck
from ..ops import field_kernels as fk
from ..ops import msm as msm_ops
from ..utils import trace
from .mesh import Mesh, copy_to, resolve_mesh
from .msm_sharded import fold_shard_sums

# torch.cuda.max_memory_allocated of each CUDA device of the mesh over the
# last prove_streamed_sharded (peaks reset when it starts); {} until then.
LAST_PEAK_DEVICE_BYTES: Dict[str, int] = {}
# (copy ms, compute ms) of each chunk part, by shard, of the last
# prove_streamed_sharded on CUDA devices (CUDA events on each shard's copy
# and compute stream).
LAST_CHUNK_MS: Dict[int, List[Tuple[float, float]]] = {}


def chunk_rows(spk: sm.StreamedProvingKey, n_devices: int) -> int:
    """The chunk of one host pass: the key's chunk_points, at most the
    power of two that covers n_vars, at least one row a shard, a multiple
    of the mesh size (the JAX package's rule, streamed_sharded.py:176)."""
    chunk = min(spk.chunk_points, 1 << max(spk.n_vars - 1, 1).bit_length())
    chunk = max(chunk, n_devices)
    return -(-chunk // n_devices) * n_devices


def prove_streamed_sharded(spk: sm.StreamedProvingKey, mesh: Optional[Mesh], r: int, s: int,
                           full_assignment: Sequence[int],
                           window_bits: Optional[int] = None) -> Proof:
    """Prove with the query sections on the host, streamed chunk by chunk
    into `mesh` (default: every card). The proof equals prove_prepared's
    for the same key, assignment, r and s. window_bits defaults to
    pick_window_bits of a shard's part of a chunk. Stages: prove.encode,
    prove.witness_map, prove.msm_stream (with scans and gather),
    prove.assemble."""
    global LAST_PEAK_DEVICE_BYTES, LAST_CHUNK_MS
    mesh = resolve_mesh(mesh)
    sm._check_sections(spk)
    D, dev = mesh.size, spk.device
    chunk = chunk_rows(spk, D)
    part = chunk // D
    if window_bits is None:
        window_bits = msm_ops.pick_window_bits(part)
    n = max(spk.n_vars, spk.domain_size)
    loop = -(-n // chunk) * chunk
    cards = [d for d in mesh.physical() if torch.device(d).type == "cuda"]
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    with trace.span("prove.encode", dev):
        asg = gd.assignment_on(full_assignment, dev)
    with trace.span("prove.witness_map", mesh):
        h = fk.fr_from_mont(spk.matrices.witness_map(fk.fr_to_mont(asg)))
        # each shard's rows of the scalars of A/B1/B2, of L and of H: chunk j's
        # part i is row j of shard i's (chunks, part, 8) slice
        scalars = [sm._padded(x, loop).reshape(loop // chunk, D, part, 8)
                   for x in (asg, asg[spk.num_inputs:], h)]
        shard_sc = [[copy_to(x[:, i], d) for x in scalars] for i, d in enumerate(mesh.devices)]
        del asg, h, scalars
    W, B = msm_ops.num_windows(window_bits), 1 << window_bits
    acc = [[cv.proj_identity_const(False, d).expand((4, W, B, 3, 8)).contiguous(),
            cv.proj_identity_const(True, d).expand((1, W, B, 3, 2, 8)).contiguous()]
           for d in mesh.devices]
    pipes = [sm.ChunkPipe(d, part) for d in mesh.devices]
    with trace.span("prove.msm_stream", mesh):
        for j, lo in enumerate(range(0, n, chunk)):
            for i, pipe in enumerate(pipes):

                def compute(g1, g2, i=i, j=j):
                    (s1, z1), (s2, z2) = gd.msm_sorts(
                        [[x[j] for x in shard_sc[i]]], window_bits)[0]
                    acc[i][0] = ck.point_add(
                        acc[i][0], msm_ops.bucket_sums(list(g1), s1, window_bits, zeros=z1))
                    acc[i][1] = ck.point_add(
                        acc[i][1], msm_ops.bucket_sums([g2], s2, window_bits, zeros=z2))

                pipe.push(lambda g1, g2, lo_i=lo + i * part: sm._stage_pack(spk, lo_i, g1, g2),
                          compute)
        chunk_ms = {i: pipe.chunk_ms() for i, pipe in enumerate(pipes)}
        with trace.span("scans", mesh):
            sums = [(msm_ops.scan_buckets(a1), msm_ops.scan_buckets(a2)[0]) for a1, a2 in acc]
        with trace.span("gather", mesh):
            g1 = fold_shard_sums([x[0] for x in sums], mesh.lead)
            g2 = fold_shard_sums([x[1] for x in sums], mesh.lead)
    if cards:
        LAST_PEAK_DEVICE_BYTES = {d: torch.cuda.max_memory_allocated(d) for d in cards}
        LAST_CHUNK_MS = chunk_ms
    return gd.assemble_proof(spk.pk, r, s, g1, g2, window_bits)
