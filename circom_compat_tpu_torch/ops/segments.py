"""Segmented scans and reductions by sorted key, over one tensor of elements.

The bucket accumulation of Pippenger and the row sums of the sparse
constraint evaluation are both "reduce values by key". With the keys
sorted, that is a segmented inclusive scan and a pick of each segment's
last position. The scan is two-level:

  Phase A  a within-tile scan of K = 16 steps per tile (one kernel:
           field_kernels.fr_tile_scan or curve_kernels.point_tile_scan),
  Phase B  the same scan over the tiles' carries, recursively, down to a
           Hillis-Steele base case of at most 2K elements,
  Phase C  each tile's incoming carry combined into the positions before
           its first segment start.

Blocks of a CUDA grid carry no state between them, so Phase B stays this
recursion (one tile-scan launch per level) rather than a carry chain.

`combine(a, b)` adds two equally shaped element tensors (n, *elem);
`tile_scan(vt, ft)` is a Phase A executor; `identity` is one element.
"""

from __future__ import annotations

from typing import Callable

import torch

TILE = 16


def segment_flags(sorted_keys: torch.Tensor) -> torch.Tensor:
    """True where a new segment starts (keys sorted)."""
    prev = torch.cat((sorted_keys[:1] - 1, sorted_keys[:-1]))
    return sorted_keys != prev


def _expand(identity: torch.Tensor, n: int) -> torch.Tensor:
    return identity.expand((n,) + identity.shape).contiguous()


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def hillis_steele(combine: Callable, values: torch.Tensor, flags: torch.Tensor,
                  identity: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented scan in ceil(log2 n) combine steps (short axes)."""
    n = flags.shape[0]
    v, f = values, flags
    off = 1
    while off < n:
        pv = torch.cat((_expand(identity, off), v[: n - off]))
        pf = torch.cat((torch.zeros(off, dtype=torch.bool, device=f.device), f[: n - off]))
        v = torch.where(_bcast(f, v), v, combine(pv, v.contiguous()))
        f = f | pf
        off <<= 1
    return v


def _two_level_parts(combine, values, flags, identity, tile_scan, tile_scan_general):
    """Phases A and B. Returns the within-tile scan (T, K, *elem), each
    tile's incoming carry (T, *elem), the (T, K) mask of positions before
    the tile's first flag, and T."""
    n = flags.shape[0]
    K = TILE
    T = -(-n // K)
    pad = T * K - n
    v = torch.cat((values, _expand(identity, pad))) if pad else values
    f = torch.cat((flags, torch.ones(pad, dtype=torch.bool, device=flags.device))) if pad else flags
    vt = v.reshape((T, K) + values.shape[1:])
    ft = f.reshape(T, K)
    out, tile_carry = tile_scan(vt, ft)
    carries = segmented_scan(combine, tile_carry, ft.any(dim=1), identity,
                             tile_scan_general, tile_scan_general)
    carry_in = torch.cat((identity[None], carries[:-1]))
    no_flag_yet = torch.cumsum(ft.to(torch.int32), dim=1) == 0
    return out, carry_in, no_flag_yet, T


def segmented_scan(combine: Callable, values: torch.Tensor, flags: torch.Tensor,
                   identity: torch.Tensor, tile_scan: Callable,
                   tile_scan_general: Callable) -> torch.Tensor:
    """Inclusive scan of `values` restarting at every True flag.
    tile_scan runs Phase A at this level; tile_scan_general every deeper
    level (it must accept non-leaf operands)."""
    n = flags.shape[0]
    if n <= 2 * TILE:
        return hillis_steele(combine, values, flags, identity)
    out, carry_in, no_flag_yet, T = _two_level_parts(
        combine, values, flags, identity, tile_scan, tile_scan_general)
    flat = out.reshape((T * TILE,) + out.shape[2:])
    carry_b = carry_in[:, None].expand(out.shape).reshape(flat.shape)
    merged = combine(carry_b, flat)
    mask = no_flag_yet.reshape(-1)
    return torch.where(_bcast(mask, flat), merged, flat)[:n]


def _first_only(n: int, device) -> torch.Tensor:
    flags = torch.zeros(n, dtype=torch.bool, device=device)
    flags[:1] = True
    return flags


def inclusive_scan(combine: Callable, values: torch.Tensor, identity: torch.Tensor,
                   tile_scan: Callable) -> torch.Tensor:
    """Unsegmented inclusive scan: one segment that starts at position 0."""
    return segmented_scan(combine, values, _first_only(values.shape[0], values.device),
                          identity, tile_scan, tile_scan)


def fold(combine: Callable, values: torch.Tensor, identity: torch.Tensor,
         tile_scan: Callable) -> torch.Tensor:
    """The sum of all elements. Each level keeps only the tiles' totals
    (Phase A with no restarts) and recurses on them: about 1.07n combines
    and no Phase C."""
    n = values.shape[0]
    if n == 0:
        return identity.clone()
    if n <= 2 * TILE:
        return hillis_steele(combine, values, _first_only(n, values.device), identity)[-1]
    T = -(-n // TILE)
    pad = T * TILE - n
    v = torch.cat((values, _expand(identity, pad))) if pad else values
    no_flags = torch.zeros((T, TILE), dtype=torch.bool, device=values.device)
    _, carry = tile_scan(v.reshape((T, TILE) + values.shape[1:]), no_flags)
    return fold(combine, carry, identity, tile_scan)


def reduce_by_sorted_key(combine: Callable, values: torch.Tensor, sorted_keys: torch.Tensor,
                         num_segments: int, identity: torch.Tensor, tile_scan: Callable,
                         tile_scan_general: Callable) -> torch.Tensor:
    """Per-key sums for sorted int keys in [0, num_segments): (num_segments,
    *elem), the identity where a key has no element (every key, with no
    elements: no combine runs). Only each segment's last position is read,
    so Phase C runs at those positions only."""
    n = sorted_keys.shape[0]
    if n == 0:
        return _expand(identity, num_segments)
    flags = segment_flags(sorted_keys)
    seg_ids = torch.arange(num_segments, dtype=sorted_keys.dtype, device=sorted_keys.device)
    right = torch.searchsorted(sorted_keys, seg_ids, right=True)
    left = torch.searchsorted(sorted_keys, seg_ids)
    nonempty = right > left
    last_idx = torch.clamp(right - 1, 0, max(n - 1, 0))
    if n <= 2 * TILE:
        picked = hillis_steele(combine, values, flags, identity)[last_idx]
    else:
        out, carry_in, no_flag_yet, T = _two_level_parts(
            combine, values, flags, identity, tile_scan, tile_scan_general)
        picked = out.reshape((T * TILE,) + out.shape[2:])[last_idx]
        merged = combine(carry_in[last_idx // TILE].contiguous(), picked)
        need = no_flag_yet.reshape(-1)[last_idx]
        picked = torch.where(_bcast(need, picked), merged, picked)
    return torch.where(_bcast(nonempty, picked), picked, identity)
