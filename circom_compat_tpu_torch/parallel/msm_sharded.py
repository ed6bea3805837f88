"""Mesh-sharded Pippenger MSM (the JAX package's parallel/msm_sharded.py).

Sum_i s_i P_i splits into one MSM per shard over its rows. Each shard's
window sums come from the port's batched bucket reduce on the shard's
device (ops/msm.window_sums: the level-0 scan is K8 with mixed adds, the
levels above and the bucket suffix scan K8 and K6/K7). The D per-window
partial sums, a few hundred points rather than the N bases, are gathered
onto the mesh's lead device and tree-folded with K6/K7 projective adds;
the Horner fold over the windows runs on the host.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..ops import curve as cv
from ..ops import curve_kernels as ck
from ..ops import field as fl
from ..ops import msm as msm_ops
from ..refmath import curve as rc
from .mesh import Mesh, all_gather, resolve_mesh, scatter_rows, tree_fold


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[: x.shape[0]] = x
    return out


def pad_shard_inputs(xy: torch.Tensor, scalars: torch.Tensor, n_devices: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad points and scalars to a multiple of n_devices rows: all-zero
    affine rows (infinity, the zkey convention) with zero scalars, which
    add nothing to any bucket."""
    target = -(-xy.shape[0] // n_devices) * n_devices
    return _pad_rows(xy, target), _pad_rows(scalars, target)


def fold_shard_sums(sums: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Per-shard window sums (equal shapes, one a mesh entry) -> their sum
    on `device`: all_gather onto it, then a tree fold of K6/K7 adds."""
    return tree_fold(ck.point_add, all_gather(sums, [device])[0], len(sums))


def sharded_window_sums(mesh: Mesh, xy: torch.Tensor, scalars: torch.Tensor,
                        window_bits: int = 8) -> torch.Tensor:
    """(W, *point) window sums on the mesh's lead device, computed with the
    points ((N, 2, 8) G1 or (N, 2, 2, 8) G2 affine words) and the (N, 8)
    canonical scalars split in row shards over the mesh; N % D == 0."""
    sums = [msm_ops.window_sums([x], [msm_ops.window_orders(sc, window_bits)], window_bits)[0]
            for x, sc in zip(scatter_rows(xy, mesh), scatter_rows(scalars, mesh))]
    return fold_shard_sums(sums, mesh.lead)


def msm_g1_sharded(points_xy, scalars, mesh: Optional[Mesh] = None, window_bits: int = 8):
    """Sharded G1 MSM: (N, 2, 8) affine Montgomery words (a tensor or an
    array, zero rows for infinity) and N scalars (ints, or (N, 8) canonical
    words) -> the affine sum, or None. Runs on `mesh` (default: every
    card), the Horner fold on the host."""
    mesh = resolve_mesh(mesh)
    xy = torch.as_tensor(points_xy)
    if tuple(xy.shape[1:]) != (2, 8):
        raise ValueError(f"points must be (N, 2, 8) affine words, not {tuple(xy.shape)}")
    n = xy.shape[0]
    if n == 0 or len(scalars) == 0:
        return None
    if len(scalars) < n:
        raise ValueError(f"{len(scalars)} scalars for {n} points")
    if isinstance(scalars, torch.Tensor):
        sc = scalars[:n].to(torch.int32)
    else:
        sc = torch.from_numpy(fl.encode_plain([int(s) for s in list(scalars)[:n]]))
    xy, sc = pad_shard_inputs(xy.to(torch.int32), sc, mesh.size)
    sums = sharded_window_sums(mesh, xy, sc, window_bits)
    return msm_ops.fold_windows_host(cv.decode_g1_proj(sums), rc.G1, window_bits)

