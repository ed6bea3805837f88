"""The MSM's share of its roofline, in %.

Numerator: the least time of the work the five MSMs of a proof require at
the configuration's fixed window c (window_bits), priced against the
card's peaks (peaks.json): one mixed addition per nonzero c-bit digit of
the A, B1, L and H scalars in G1 and of the B2 scalars in G2, plus each
window's bucket reduce (2 (b - 1) additions over b buckets, running sums);
the points (64 B in G1, 128 B in G2) and the scalars (the assignment and
h, 32 B) read once. The digits are counted on the scalars the reference
recomputed for each profiled request's pool entry; L's scalars are the
assignment past its num_inputs public wires.

Multiplies of an addition: the complete formulas for a = 0 (Renes,
Costello, Batina, "Complete addition formulas for prime order elliptic
curves", EUROCRYPT 2016, eprint 2015/1060), Algorithm 8 (mixed) 11 M +
2 m_3b and Algorithm 7 (projective) 12 M + 2 m_3b. In G1, 3b = 9 costs
additions only; in G2 every Fq2 multiply, m_3b included, is 3 Fq
multiplies (Karatsuba). Rows at infinity are counted as points.

Denominator: the device seconds of every operation launched inside the
program's `prove.msm` stage (sorts, msm_g1, msm_g2), from the profiled
stretch. No device time recorded: no value.
"""

SCALAR_BITS = 254
G1_MIXED, G1_ADD = 11, 12
G2_MIXED, G2_ADD = 3 * 13, 3 * 14
SECTIONS = ("a", "b1", "l", "h", "b2")


def windows(c: int):
    """Bits of each window of a SCALAR_BITS-bit scalar."""
    w = -(-SCALAR_BITS // c)
    return [c] * (w - 1) + [SCALAR_BITS - (w - 1) * c]


def nonzero_digits(limbs, c: int) -> int:
    """Nonzero c-bit window digits of (16, N) int64 16-bit limbs."""
    import torch

    x = torch.cat((limbs, torch.zeros_like(limbs[:2])))
    total = 0
    for i in range(len(windows(c))):
        j, off = divmod(i * c, 16)
        v = ((x[j] | (x[j + 1] << 16) | (x[j + 2] << 32)) >> off) & ((1 << c) - 1)
        total += int((v != 0).sum().item())
    return total


def work(digits: dict, sizes: dict, c: int):
    """(Fq multiplies, bytes) of the five MSMs: digits and sizes by section."""
    reduce_adds = sum(2 * ((1 << b) - 2) for b in windows(c))
    g1 = sum(digits[s] for s in ("a", "b1", "l", "h")) * G1_MIXED + 4 * reduce_adds * G1_ADD
    g2 = digits["b2"] * G2_MIXED + reduce_adds * G2_ADD
    points = 64 * sum(sizes[s] for s in ("a", "b1", "l", "h")) + 128 * sizes["b2"]
    return g1 + g2, points + 32 * (sizes["a"] + sizes["h"])


def bound_s(digits: dict, sizes: dict, c: int, peaks: dict) -> float:
    mults, nbytes = work(digits, sizes, c)
    return max(mults * peaks["mont_mul_mads"] / peaks["int32_mad_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def read(rec):
    prof = rec["profile"]
    device_s = prof["stage_device_s"].get("prove.msm") if prof else None
    if not device_s or not rec["profiled"]:
        return None
    c = rec["config"]["window_bits"]
    total = 0.0
    for ans in rec["profiled"]:
        sc = rec["scalars"].get(ans["pool"])
        if sc is None:
            return None
        z, ni = sc["z"], sc["num_inputs"]
        vec = {"a": z, "b1": z, "b2": z, "l": z[:, ni:], "h": sc["h"]}
        digits = {s: nonzero_digits(v, c) for s, v in vec.items()}
        sizes = {s: v.shape[1] for s, v in vec.items()}
        total += bound_s(digits, sizes, c, rec["peaks"])
    return 100.0 * total / device_s
