"""The device mesh and the collectives the sharded provers use.

The JAX package runs its multi-chip prover as SPMD under shard_map over a
jax.sharding.Mesh (circom_compat_tpu/parallel/mesh.py). shard_map is
single-controller: one process drives every device of the mesh. The port
keeps that model. A Mesh is an ordered tuple of torch devices on the one
axis SHARD_AXIS; the per-shard work is a Python loop over its entries that
queues each shard's kernels on its device's current stream with no host
read in between, so distinct cards run their shards side by side.

A mesh may repeat a device (["cuda:0"] * 4, ["cpu"] * 2): the counterpart
of XLA's forced host device count. Every shard then keeps tensors of its
own, and every collective writes fresh tensors on each target device, so a
repeated device never aliases one shard's buffer into another's (note that
`t.to(d)` on t's own device returns t itself). Copies between two cards are
CUDA peer copies (`copy_`, ordered after both devices' current streams);
no NCCL runs inside one process.

  all_gather(shards)              jax.lax.all_gather: each target device
                                  gets a fresh (D, *shape) stack
  all_to_all(blocks, split, cat)  jax.lax.all_to_all, tiled
  transpose_a2a(blocks)           the four-step NTT's distributed transpose
  tree_fold(combine, values, n)   circom_compat_tpu/ops/segments.py:376
  scatter_rows / gather_rows      a global tensor to row shards and back
  rows_of(blocks, lo, hi, device) rows [lo, hi) of the concatenated blocks
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

SHARD_AXIS = "shards"


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices on the one axis SHARD_AXIS; entries may
    repeat a device."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {SHARD_AXIS: self.size}

    @property
    def lead(self) -> torch.device:
        """The first entry: where the sharded provers fold the gathered
        window sums and read them back."""
        return self.devices[0]

    def physical(self) -> List[str]:
        """The distinct devices of the mesh, in order of first entry."""
        return list(dict.fromkeys(str(d) for d in self.devices))

    def synchronize(self) -> None:
        """Wait for every CUDA device of the mesh."""
        for d in self.physical():
            if torch.device(d).type == "cuda":
                torch.cuda.synchronize(d)


def _cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu'] * n to make_mesh to run the "
            "mesh on the CPU with the kernels' plain versions")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over `devices` (default: every visible card; without one this
    raises), cut to the first n_devices and then to a power of two, as the
    JAX package's make_mesh does, so that tree folds stay balanced."""
    devs = _cuda_devices() if devices is None else [torch.device(d) for d in devices]
    for d in devs:
        if d.type == "cuda" and d.index is None:
            raise ValueError("name the card of each mesh entry: 'cuda:0', not 'cuda'")
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if n & (n - 1):
        devs = devs[: 1 << (n.bit_length() - 1)]
    return Mesh(tuple(devs))


def resolve_mesh(mesh: Optional[Mesh]) -> Mesh:
    """The mesh an entry point runs on: the caller's, else every card."""
    return make_mesh() if mesh is None else mesh


def copy_to(t: torch.Tensor, device) -> torch.Tensor:
    """A fresh copy of t on `device`, even where t already lies there."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def all_gather(shards: Sequence[torch.Tensor], devices: Optional[Sequence] = None
               ) -> List[torch.Tensor]:
    """shards[i] (equal shapes) -> for each target device a fresh (D, *shape)
    stack of every shard. The targets default to the shards' own devices,
    as jax.lax.all_gather leaves a copy on every device of the axis."""
    targets = [s.device for s in shards] if devices is None else [torch.device(d) for d in devices]
    shape = tuple(shards[0].shape)
    out = []
    for d in targets:
        stack = torch.empty((len(shards),) + shape, dtype=shards[0].dtype, device=d)
        for i, s in enumerate(shards):
            if tuple(s.shape) != shape:
                raise ValueError(f"all_gather: shard {i} is {tuple(s.shape)}, not {shape}")
            stack[i].copy_(s)
        out.append(stack)
    return out


def all_to_all(blocks: Sequence[torch.Tensor], split_dim: int, concat_dim: int
               ) -> List[torch.Tensor]:
    """jax.lax.all_to_all in its tiled form: block i (on device i) is split
    along split_dim into D equal pieces; device j receives piece j of every
    block, concatenated along concat_dim in block order, as a fresh tensor."""
    D = len(blocks)
    shape = list(blocks[0].shape)
    if split_dim == concat_dim:
        raise ValueError("all_to_all: split_dim and concat_dim must differ")
    if shape[split_dim] % D:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(shape)} does not split {D} ways")
    piece, step = shape[split_dim] // D, shape[concat_dim]
    out_shape = list(shape)
    out_shape[split_dim], out_shape[concat_dim] = piece, step * D
    out = []
    for j, dst in enumerate(blocks):
        o = torch.empty(out_shape, dtype=dst.dtype, device=dst.device)
        for i, src in enumerate(blocks):
            if list(src.shape) != shape:
                raise ValueError(f"all_to_all: block {i} is {tuple(src.shape)}, not {tuple(shape)}")
            o.narrow(concat_dim, i * step, step).copy_(src.narrow(split_dim, j * piece, piece))
        out.append(o)
    return out


def transpose_a2a(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Row shards (R/D, C, ...) of a matrix -> row shards (C/D, R, ...) of
    its transpose: all_to_all(split 1, concat 0) then a local transpose
    (the JAX package's _transpose_a2a, ntt_sharded.py:170)."""
    return [b.transpose(0, 1).contiguous() for b in all_to_all(blocks, 1, 0)]


def tree_fold(combine: Callable, values, length: int):
    """Reduce `values` (leading dim == length, a power of two) by halving
    rounds, combine(values[:half], values[half:]), as the JAX package's
    segments.tree_fold: log2(length) combines, for the device-count folds."""
    if length <= 0 or length & (length - 1):
        raise ValueError(f"tree_fold: length {length} is not a power of two")
    while length > 1:
        half = length // 2
        values = combine(values[:half], values[half:length])
        length = half
    return values[0]


def scatter_rows(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """A global tensor -> D fresh row shards, shard i on mesh entry i."""
    D = mesh.size
    if x.shape[0] % D:
        raise ValueError(f"{x.shape[0]} rows do not split {D} ways")
    return [copy_to(part, d) for part, d in zip(x.chunk(D), mesh.devices)]


def gather_rows(blocks: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Row shards -> one fresh global tensor on `device`."""
    return rows_of(blocks, 0, sum(b.shape[0] for b in blocks), device)


def rows_of(blocks: Sequence[torch.Tensor], lo: int, hi: int, device) -> torch.Tensor:
    """Rows [lo, hi) of the blocks' concatenation as a fresh tensor on
    `device`; rows past its end are zero."""
    out = torch.zeros((hi - lo,) + tuple(blocks[0].shape[1:]), dtype=blocks[0].dtype,
                      device=device)
    start = 0
    for b in blocks:
        a, z = max(lo, start), min(hi, start + b.shape[0])
        if a < z:
            out[a - lo : z - lo].copy_(b[a - start : z - start])
        start += b.shape[0]
    return out
