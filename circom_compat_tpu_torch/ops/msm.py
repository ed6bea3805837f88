"""Pippenger multi-scalar multiplication with sorted buckets.

Per window w of `window_bits` bits, the points are sorted by their digit
(one stable sort per scalar vector serves every MSM over it), the bucket
sums come from a segmented reduce by sorted key, and the window sum
sum_j j * S_j is a reversed suffix scan of the buckets summed. All W
windows of all the MSMs over one group go through ONE reduce: the sorted
digits of MSM m's window w are offset by (m * W + w) * 2^window_bits, which
keeps the concatenated keys sorted. The suffix scans of all windows are
likewise one segmented scan, and their sums one reduce keyed by window.
Bucket 0 is multiplied by 0 in every window sum, so the reduce takes only
the rows whose digit is nonzero: the stable sort puts a window's digit-0
rows first, each window's count of them is read back (digit_zero_counts:
one small read a bucket_sums call, or one for both groups in the provers,
models/groth16_device.msm_sorts), and
bucket_sums gathers the suffixes that follow and returns the identity in
bucket 0 of every window, as in any empty bucket. A witness of bits, whose
digits are 0 in every window but the lowest, gathers at most one row a
scalar where a dense one gathers about W. Batching keeps the plain
versions' Python op count independent of W and M, and gives each kernel
launch the work of all windows. Every prover folds its W window sums on
the card (K10, ops/curve_kernels.proof_fold); the standalone MSMs and CPU
sums fold on the host on exact ints (fold_windows_host).

msm_g1 / msm_g2 are the standalone MSMs: one vector of points and scalars,
the window sums on the card unless the caller names another device, the
fold on the host.

signed=True (off by default, as in the JAX package, where unsigned digits
won on its accelerator) recodes each window but the top one to a digit d in
[-2^(w-1), 2^(w-1)] (window_digits_signed) and keys the buckets by |d|: a
negative digit negates y on the gathered affine row (an Fq subtract from
zero, K1) before the projective encode, all-zero (infinity) rows stay as
they are, and the key stride covers both |d| <= 2^(w-1) and the unsigned
top window's digit plus its carry (bucket_count). The prove's shared
assignment sort (window_orders) stays unsigned.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..refmath import curve as rc
from . import curve as cv
from . import curve_kernels as ck
from . import field as fl
from . import field_kernels as fk
from . import segments

SCALAR_BITS = 254  # BN254 Fr
# Host-side counters of bucket_sums, by group ("g1", "g2"): the rows it
# gathers into its level-0 reduce (those with a nonzero digit), the digit-0
# rows it leaves out (the two sum to W * N_m over its MSMs) and its calls.
# Counted from the digit-0 counts it reads back; reset_counters() clears them.
BUCKET_ROWS = {"g1": 0, "g2": 0}
BUCKET_SKIPPED = {"g1": 0, "g2": 0}
BUCKET_CALLS = {"g1": 0, "g2": 0}


def reset_counters() -> None:
    for counts in (BUCKET_ROWS, BUCKET_SKIPPED, BUCKET_CALLS):
        for k in counts:
            counts[k] = 0


def num_windows(window_bits: int) -> int:
    return -(-SCALAR_BITS // window_bits)


def pick_window_bits(n: int) -> int:
    """argmin over w in [8, 17] of W(w) * (n + 12 * 2^w), W = ceil(254/w).
    PLACEHOLDER: the bucket coefficient 12 was fitted to the JAX package's
    timings on another accelerator and has not been refitted on the H100."""
    return min(range(8, 18), key=lambda w: -(-SCALAR_BITS // w) * (n + (12 << w)))


def window_digits(scalars: torch.Tensor, window_bits: int) -> torch.Tensor:
    """(N, 8) canonical plain words -> (W, N) int64 digits."""
    u = scalars.to(torch.int64) & 0xFFFFFFFF
    u = torch.cat((u, torch.zeros_like(u[:, :1])), dim=1)  # guard word
    mask = (1 << window_bits) - 1
    rows = []
    for w in range(num_windows(window_bits)):
        bit = w * window_bits
        word, off = divmod(bit, 32)
        d = u[:, word] >> off
        if 32 - off < window_bits:  # the window straddles two words
            d = d | (u[:, word + 1] << (32 - off))
        rows.append(d & mask)
    return torch.stack(rows)


def window_digits_signed(scalars: torch.Tensor, window_bits: int) -> torch.Tensor:
    """(N, 8) canonical plain words -> (W, N) int64 signed digits: below the
    top window a digit >= 2^(w-1) becomes d - 2^w and carries 1 into the
    next window; the top window stays unsigned and takes the last carry
    (BN254 scalars are < 2^254, so it fits)."""
    d = window_digits(scalars, window_bits)
    half, full = 1 << (window_bits - 1), 1 << window_bits
    carry = torch.zeros_like(d[0])
    rows = []
    for row in d[:-1]:
        row = row + carry
        neg = row >= half
        rows.append(torch.where(neg, row - full, row))
        carry = neg.to(row.dtype)
    rows.append(d[-1] + carry)
    return torch.stack(rows)


def bucket_count(window_bits: int, signed: bool = False) -> int:
    """Buckets a window (the key stride B): 2^w unsigned; signed, |d| in
    [0, 2^(w-1)] and the unsigned top window's digit plus carry, up to
    2^(top bits)."""
    if not signed:
        return 1 << window_bits
    top_bits = SCALAR_BITS - (num_windows(window_bits) - 1) * window_bits
    return max(1 << (window_bits - 1), 1 << top_bits) + 1


def window_orders_signed(scalars: torch.Tensor, window_bits: int):
    """(orders, keys, negs), each (W, N): keys[w] the sorted |digits| of
    window w, orders[w] the stable argsort that sorts them and negs[w]
    where the sorted digit is negative."""
    d = window_digits_signed(scalars, window_bits)
    keys, orders = torch.sort(d.abs(), dim=1, stable=True)
    return orders, keys, torch.gather(d, 1, orders) < 0


def window_orders(scalars: torch.Tensor, window_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(orders, keys), both (W, N) int64: keys[w] the sorted digits of
    window w and orders[w] the stable argsort that sorts them."""
    keys, orders = torch.sort(window_digits(scalars, window_bits), dim=1, stable=True)
    return orders, keys


def _leaf_scan(vt, ft):
    """Level-0 Phase A of a bucket reduce: operands are affine-encoded."""
    return ck.point_tile_scan(vt, ft, mixed=True)


def _general_scan(vt, ft):
    return ck.point_tile_scan(vt, ft, mixed=False)


def _negate_rows(rows: torch.Tensor, negs: torch.Tensor) -> torch.Tensor:
    """Gathered affine rows with y negated where negs holds (an Fq subtract
    from zero, lazy); all-zero rows (infinity) stay zero."""
    y = rows.select(1, 1)
    neg_y = fk.fr_binary("sub", torch.zeros_like(y), y.contiguous(), fl.FQ)
    inf = (rows == 0).flatten(1).all(-1)
    keep = (~negs | inf).reshape((-1,) + (1,) * (y.dim() - 1))
    return torch.stack((rows.select(1, 0), torch.where(keep, y, neg_y)), dim=1)


def digit_zero_counts(sorts: Sequence[tuple]) -> torch.Tensor:
    """(M, W) int64 on the host: each window's count of digit-0 rows in M
    sorts (from window_orders or window_orders_signed), read back in one
    copy that waits for the sorts."""
    keys = sorts[0][1]
    one = torch.ones((keys.shape[0], 1), dtype=keys.dtype, device=keys.device)
    return torch.cat([torch.searchsorted(s[1], one) for s in sorts], 1).cpu().t()


def _index_tables(sizes: Sequence[int], zeros: torch.Tensor, B: int) -> torch.Tensor:
    """(M, 3, W) int64 on the host, for MSM m of N_m = sizes[m] rows a
    window: where the rows of nonzero digit end, window after window, in
    the gathered order (ends); what position p of window w adds to read its
    flat row w * N_m + zeros[m, w] + (p - start of w) in the sorts (shift);
    and window w's key base (m * W + w) * B."""
    M, W = zeros.shape
    n = torch.tensor(sizes, dtype=torch.int64)[:, None]
    w = torch.arange(W, dtype=torch.int64)
    ends = torch.cumsum(n - zeros, 1)
    return torch.stack((ends, (w + 1) * n - ends, (torch.arange(M)[:, None] * W + w) * B), 1)


def bucket_sums(xys: Sequence[torch.Tensor], sorts: Sequence[tuple], window_bits: int,
                signed: bool = False, zeros: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, W, B, *point) bucket sums of M MSMs over one group, all in ONE
    segmented reduce: MSM m's window w takes keys (m * W + w) * B + digit,
    B = bucket_count(window_bits, signed). xys[m]: affine points, (N_m, 2,
    8) G1 or (N_m, 2, 2, 8) G2 Montgomery words with zero rows for
    infinity; sorts[m]: its (orders, keys) from window_orders, or with
    signed=True its (orders, keys, negs) from window_orders_signed.

    Bucket 0 of every window is the identity: the reduce takes only the
    rows whose digit is nonzero, as many as digit_zero_counts(sorts) leaves
    (`zeros`, read here when the caller has not read it with other sorts).
    Identity rows keyed 0 before them fill the rows to whole tiles, so the
    reduce pads nothing."""
    g2 = xys[0].dim() == 4
    if any(len(s) != (3 if signed else 2) for s in sorts):
        raise ValueError("signed bucket sums take (orders, keys, negs) sorts, unsigned "
                         "(orders, keys)")
    W = sorts[0][0].shape[0]
    B = bucket_count(window_bits, signed)
    M = len(xys)
    dev = xys[0].device
    sizes = [s[0].shape[1] for s in sorts]
    host = _index_tables(sizes, digit_zero_counts(sorts) if zeros is None else zeros, B)
    kept = host[:, 0, -1].tolist()
    rows_in = sum(kept)
    group = "g2" if g2 else "g1"
    BUCKET_ROWS[group] += rows_in
    BUCKET_SKIPPED[group] += W * sum(sizes) - rows_in
    BUCKET_CALLS[group] += 1
    tables = host.to(dev, non_blocking=True)  # no wait: the host copy is staged at once
    ident = cv.proj_identity_const(g2, dev)
    lead = -rows_in % segments.TILE
    pts = torch.empty((lead + rows_in,) + ident.shape, dtype=torch.int32, device=dev)
    gkeys = torch.empty(lead + rows_in, dtype=torch.int64, device=dev)
    pts[:lead], gkeys[:lead] = ident, 0
    off = lead
    for m, (xy, sort, n) in enumerate(zip(xys, sorts, kept)):
        if n == 0:
            continue
        orders, keys = sort[0], sort[1]
        ends, shift, base = tables[m]
        # the flat positions src of the rows kept, and the window win of each
        src = torch.arange(n, device=dev)
        win = torch.searchsorted(ends, src, right=True)
        src.add_(shift[win])
        rows = xy[orders.reshape(-1)[src]]
        if signed:
            rows = _negate_rows(rows, sort[2].reshape(-1)[src])
        pts[off : off + n] = cv.affine_to_proj(rows, g2)
        del rows  # the gathered rows: not held through the reduce below
        torch.add(keys.reshape(-1)[src], base[win], out=gkeys[off : off + n])
        del src, win
        off += n
    sums = segments.reduce_by_sorted_key(ck.point_add, pts, gkeys, M * W * B, ident,
                                         _leaf_scan, _general_scan)
    return sums.reshape((M, W, B) + sums.shape[1:])


def scan_buckets(buckets: torch.Tensor) -> torch.Tensor:
    """(..., B, *point) -> (..., *point): sum_{j>=1} j * S_j per window, as
    the sum of the inclusive suffix scan of buckets B-1 .. 1; all windows
    in one segmented scan and one reduce keyed by window."""
    g2 = buckets.shape[-3:] == (3, 2, 8)
    pdims = 3 if g2 else 2
    lead = buckets.shape[: buckets.dim() - pdims - 1]
    B = buckets.shape[len(lead)]
    flat = buckets.reshape((-1, B) + buckets.shape[len(lead) + 1 :])
    nw = flat.shape[0]
    rev = flat[:, 1:].flip(1).reshape((nw * (B - 1),) + flat.shape[2:])
    idx = torch.arange(nw * (B - 1), device=buckets.device)
    ident = cv.proj_identity_const(g2, buckets.device)
    suffix = segments.segmented_scan(ck.point_add, rev, idx % (B - 1) == 0, ident,
                                     _general_scan, _general_scan)
    sums = segments.reduce_by_sorted_key(ck.point_add, suffix, idx // (B - 1), nw, ident,
                                         _general_scan, _general_scan)
    return sums.reshape(lead + sums.shape[1:])


def window_sums(xys, sorts, window_bits: int, signed: bool = False,
                zeros: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, W, *point) Pippenger window sums of M MSMs over one group."""
    return scan_buckets(bucket_sums(xys, sorts, window_bits, signed, zeros))


def fold_windows_host(window_pts: List, curve_ops, window_bits: int):
    """Horner over decoded window sums, most significant window first."""
    acc = None
    for w in reversed(range(len(window_pts))):
        if acc is not None:
            for _ in range(window_bits):
                acc = curve_ops.double(acc)
        acc = curve_ops.add(acc, window_pts[w])
    return acc


def _msm(xy: torch.Tensor, scalars, g2: bool, window_bits: Optional[int], device,
         signed: bool = False):
    """sum_i s_i P_i over affine Montgomery words (zero rows for infinity):
    the window sums of one bucket reduce on `device`, the Horner fold on the
    host. scalars: N ints, or (N, 8) int32 canonical words (< r)."""
    shape = (2, 2, 8) if g2 else (2, 8)
    if tuple(xy.shape[1:]) != shape:
        raise ValueError(f"points must be (N, {', '.join(map(str, shape))}) affine words, "
                         f"not {tuple(xy.shape)}")
    n = xy.shape[0]
    if n == 0 or len(scalars) == 0:
        return None
    if len(scalars) < n:
        raise ValueError(f"{len(scalars)} scalars for {n} points")
    dev = resolve_device(device)
    if isinstance(scalars, torch.Tensor):
        sc = scalars[:n].to(dev, torch.int32)
    else:
        sc = torch.from_numpy(fl.encode_plain(list(scalars)[:n])).to(dev)
    if window_bits is None:
        window_bits = pick_window_bits(n)
    orders = window_orders_signed if signed else window_orders
    sums = window_sums([xy.to(dev, torch.int32)], [orders(sc, window_bits)], window_bits,
                       signed)[0]
    decoded = cv.decode_g2_proj(sums) if g2 else cv.decode_g1_proj(sums)
    return fold_windows_host(decoded, rc.G2 if g2 else rc.G1, window_bits)


def msm_g1(points_xy: torch.Tensor, scalars, window_bits: Optional[int] = None, device=None,
           signed: bool = False):
    """G1 MSM: (N, 2, 8) affine Montgomery words and N scalars -> the affine
    sum (x, y), or None for infinity or empty input. signed=True takes
    signed window digits."""
    return _msm(points_xy, scalars, False, window_bits, device, signed)


def msm_g2(points_xy: torch.Tensor, scalars, window_bits: Optional[int] = None, device=None,
           signed: bool = False):
    """G2 MSM: (N, 2, 2, 8) affine Montgomery words and N scalars -> the
    affine sum ((x0, x1), (y0, y1)), or None."""
    return _msm(points_xy, scalars, True, window_bits, device, signed)
