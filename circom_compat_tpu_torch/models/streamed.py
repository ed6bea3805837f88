"""Streamed Groth16 prover: proving keys larger than the card's memory.

The five query sections stay on the host, as (n, 2, 8) / (n, 2, 2, 8)
int32 word views of the zkey's memory-mapped limbs; the card sees chunks
of `chunk` rows. Pippenger bucket sums are additive across point subsets,
so each chunk's bucket sums (one batched bucket reduce per group,
ops/msm.bucket_sums: A, B1, L and H in G1, B2 in G2) are added into
running (4, W, B) G1 and (1, W, B) G2 accumulators with the K6/K7 point
add, and the bucket suffix scan (ops/msm.scan_buckets) runs once at the
end. The device working set is set by the chunk, not by the key:

    peak = one chunk's bucket reduce + two chunk buffers + accumulators
           + the witness map's tensors + the resident matrices and tables

The sorted A/B matrices and the NTT plan's tables stay on the device, as
in DeviceProvingKey; the witness map produces h there, and the assignment
and h stay there for the whole prove.

On a CUDA device the chunks reach the card through two pinned host buffers
and two device buffers, copied on a stream of their own:
  - the device buffers are allocated on the compute stream, so the caching
    allocator cannot hand their blocks out while the copy stream writes
    them; and the copy stream first waits for the compute stream, whose
    queued work (the witness map) may have freed those blocks;
  - the host refills pinned buffer i only after that buffer's previous
    copy has completed (its copy event);
  - the copy into device buffer i waits, on the copy stream, for the
    compute that last read it;
  - the compute stream waits for its chunk's copy event.
A chunk's one host read is its digit-0 counts (groth16_device.msm_sorts);
the rest is queued, so the host stages chunk j + 1 and queues its copy
while the card reduces chunk j.
On the CPU (device="cpu") the same loop runs on plain slices: no pinning,
no streams.

Every chunk has the full chunk's shape: rows past a section's end are
zero, which is infinity and neutral in any bucket, and the last chunk is
padded so. The caching allocator then reuses one set of blocks from chunk
to chunk.

Window bits come from the chunk, not the total: the sort and the bucket
reduce of each chunk have `chunk` points, and the accumulators grow with
2^w.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..circom.zkey import ProvingKey
from ..device import resolve_device
from ..ops import curve as cv
from ..ops import curve_kernels as ck
from ..ops import field_kernels as fk
from ..ops import limbs as limb_codec
from ..ops import msm as msm_ops
from ..utils import trace
from . import groth16_device as gd
from .groth16 import Proof

# torch.cuda.max_memory_allocated over the last prove_streamed on a CUDA
# device (its peak reset when the prove starts); 0 until then.
LAST_PEAK_DEVICE_BYTES = 0
# (copy ms, compute ms) of each chunk of the last prove_streamed on a CUDA
# device, from CUDA events on the copy and the compute stream.
LAST_CHUNK_MS: List[Tuple[float, float]] = []


@dataclass
class StreamedProvingKey:
    """The witness map's matrices and NTT tables on the device; the query
    sections on the host as word views of the key's limbs: A, B1, L, H
    (n, 2, 8) and B2 (n, 2, 2, 8)."""

    pk: ProvingKey
    n_vars: int
    device: torch.device
    matrices: gd.DeviceMatrices
    g1_sections: Tuple[np.ndarray, ...]
    g2_section: np.ndarray
    chunk_points: int = 1 << 20

    @property
    def num_inputs(self) -> int:
        return self.matrices.num_inputs

    @property
    def domain_size(self) -> int:
        return self.matrices.domain_size

    @staticmethod
    def build(pk: ProvingKey, matrices, num_constraints: int, num_inputs: Optional[int] = None,
              chunk_points: int = 1 << 20, device=None) -> "StreamedProvingKey":
        dev = resolve_device(device)
        with trace.span("key.stage", dev):
            if num_inputs is None:
                num_inputs = matrices.num_instance_variables
            return StreamedProvingKey(
                pk=pk, n_vars=pk.n_vars, device=dev,
                matrices=gd.DeviceMatrices.stage(matrices, num_constraints, num_inputs,
                                                 pk.domain_size, dev),
                g1_sections=tuple(limb_codec.words_view(sec.limbs) for sec in
                                  (pk.a_query, pk.b_g1_query, pk.l_query, pk.h_query)),
                g2_section=limb_codec.words_view(pk.b_g2_query.limbs).reshape(-1, 2, 2, 8),
                chunk_points=chunk_points,
            )


def _check_sections(spk: StreamedProvingKey) -> None:
    """A row past its scalar vector would meet a zero scalar and be dropped
    silently: refuse a section longer than the scalars that cover it."""
    limits = (("A", spk.n_vars), ("B1", spk.n_vars), ("L", spk.n_vars - spk.num_inputs),
              ("H", spk.domain_size))
    for (name, limit), sec in zip(limits, spk.g1_sections):
        if sec.shape[0] > limit:
            raise ValueError(f"streamed prove: section {name} has {sec.shape[0]} rows but only "
                             f"{limit} scalars cover them")
    if spk.g2_section.shape[0] > spk.n_vars:
        raise ValueError(f"streamed prove: section B2 has {spk.g2_section.shape[0]} rows but "
                         f"only {spk.n_vars} scalars cover them")


def stage_rows(section: np.ndarray, lo: int, out: np.ndarray) -> None:
    """Rows [lo, lo + len(out)) of a host section into `out`; rows past the
    section's end are zero (infinity)."""
    m = max(0, min(section.shape[0] - lo, out.shape[0]))
    if m:
        out[:m] = section[lo : lo + m]
    out[m:] = 0


def _host_pack(chunk: int, pin: bool):
    """One chunk's buffers: G1 (4, chunk, 2, 8) for A, B1, L, H and G2
    (chunk, 2, 2, 8) for B2."""
    return (torch.empty((4, chunk, 2, 8), dtype=torch.int32, pin_memory=pin),
            torch.empty((chunk, 2, 2, 8), dtype=torch.int32, pin_memory=pin))


def _stage_pack(spk: StreamedProvingKey, lo: int, g1: torch.Tensor, g2: torch.Tensor) -> None:
    for m, sec in enumerate(spk.g1_sections):
        stage_rows(sec, lo, g1[m].numpy())
    stage_rows(spk.g2_section, lo, g2.numpy())


class ChunkPipe:
    """One device's end of the chunk stream, under the rules of the module
    docstring: on a CUDA device two pinned host buffer pairs, two device
    buffer pairs and a copy stream; on the CPU one plain buffer pair. Each
    push fills a host pair, copies it to the device and runs the chunk's
    compute on the compute stream."""

    def __init__(self, device: torch.device, chunk: int):
        self.cuda = device.type == "cuda"
        self.events: List[list] = []
        if not self.cuda:
            self.host = [_host_pack(chunk, pin=False)]
            return
        self.compute_stream = torch.cuda.current_stream(device)
        self.copy_stream = torch.cuda.Stream(device)
        self.host = [_host_pack(chunk, pin=True) for _ in range(2)]
        self.card = [tuple(torch.empty_like(t, device=device) for t in self.host[0])
                     for _ in range(2)]
        self.copy_stream.wait_stream(self.compute_stream)  # queued compute may have freed these blocks
        self.copied: List[Optional[torch.cuda.Event]] = [None, None]
        self.consumed: List[Optional[torch.cuda.Event]] = [None, None]

    def push(self, stage, compute) -> None:
        """stage(g1, g2) fills a host buffer pair; compute(g1, g2) then runs
        on the device's copy of it."""
        if not self.cuda:
            stage(*self.host[0])
            compute(*self.host[0])
            return
        i = len(self.events) % 2
        if self.copied[i] is not None:
            self.copied[i].synchronize()  # pinned buffer i's last copy has run
        stage(*self.host[i])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with torch.cuda.stream(self.copy_stream):
            if self.consumed[i] is not None:
                self.copy_stream.wait_event(self.consumed[i])  # device buffer i is free
            ev[0].record(self.copy_stream)
            for dst, src in zip(self.card[i], self.host[i]):
                dst.copy_(src, non_blocking=True)
            ev[1].record(self.copy_stream)
        self.copied[i] = ev[1]
        self.compute_stream.wait_event(ev[1])
        ev[2].record(self.compute_stream)
        compute(*self.card[i])
        ev[3].record(self.compute_stream)
        self.consumed[i] = ev[3]
        self.events.append(ev)

    def chunk_ms(self) -> List[Tuple[float, float]]:
        """Each chunk's (copy ms, compute ms) on a CUDA device, once its last
        compute has run; [] on the CPU."""
        if not self.events:
            return []
        self.events[-1][3].synchronize()
        return [(a.elapsed_time(b), c.elapsed_time(d)) for a, b, c, d in self.events]


def _stream(spk: StreamedProvingKey, chunk: int, n: int, compute) -> List[Tuple[float, float]]:
    """compute(lo, g1, g2) for every chunk of rows [lo, lo + chunk) of the
    sections, g1 and g2 on the key's device. Returns each chunk's (copy ms,
    compute ms) on a CUDA device, [] on the CPU."""
    pipe = ChunkPipe(spk.device, chunk)
    for lo in range(0, n, chunk):
        pipe.push(lambda g1, g2: _stage_pack(spk, lo, g1, g2),
                  lambda g1, g2: compute(lo, g1, g2))
    return pipe.chunk_ms()


def _padded(x: torch.Tensor, length: int) -> torch.Tensor:
    out = torch.zeros((length,) + x.shape[1:], dtype=x.dtype, device=x.device)
    m = min(length, x.shape[0])
    out[:m] = x[:m]
    return out


def prove_streamed(spk: StreamedProvingKey, r: int, s: int,
                   full_assignment: Sequence[int]) -> Proof:
    """Prove with host-resident query sections, chunk by chunk. The proof
    equals prove_prepared's for the same key, assignment, r and s. Stages:
    prove.encode, prove.witness_map, prove.msm_stream, prove.assemble."""
    global LAST_PEAK_DEVICE_BYTES, LAST_CHUNK_MS
    _check_sections(spk)
    dev = spk.device
    n = max(spk.n_vars, spk.domain_size)
    chunk = min(spk.chunk_points, 1 << (n - 1).bit_length())
    window_bits = msm_ops.pick_window_bits(chunk)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with trace.span("prove.encode", dev):
        asg = gd.assignment_on(full_assignment, dev)
    with trace.span("prove.witness_map", dev):
        h = fk.fr_from_mont(spk.matrices.witness_map(fk.fr_to_mont(asg)))
        loop = -(-n // chunk) * chunk
        # the scalars of A/B1/B2, of L (from num_inputs on) and of H,
        # zero-padded to the loop's length
        scalars = (_padded(asg, loop), _padded(asg[spk.num_inputs:], loop), _padded(h, loop))
        del asg, h
    with trace.span("prove.msm_stream", dev):
        W, B = msm_ops.num_windows(window_bits), 1 << window_bits
        acc = {False: cv.proj_identity_const(False, dev).expand((4, W, B, 3, 8)).contiguous(),
               True: cv.proj_identity_const(True, dev).expand((1, W, B, 3, 2, 8)).contiguous()}

        def compute(lo, g1, g2):
            (s1, z1), (s2, z2) = gd.msm_sorts(
                [[sc[lo : lo + chunk] for sc in scalars]], window_bits)[0]
            acc[False] = ck.point_add(acc[False], msm_ops.bucket_sums(
                list(g1), s1, window_bits, zeros=z1))
            acc[True] = ck.point_add(acc[True], msm_ops.bucket_sums(
                [g2], s2, window_bits, zeros=z2))

        chunk_ms = _stream(spk, chunk, n, compute)
        g1_sums = msm_ops.scan_buckets(acc[False])
        g2_sums = msm_ops.scan_buckets(acc[True])[0]
    if cuda:
        LAST_PEAK_DEVICE_BYTES = torch.cuda.max_memory_allocated(dev)
        LAST_CHUNK_MS = chunk_ms
    return gd.assemble_proof(spk.pk, r, s, g1_sums, g2_sums, window_bits)
