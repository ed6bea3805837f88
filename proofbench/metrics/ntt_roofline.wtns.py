"""The witness map's share of its roofline, in %.

Numerator: the least time of the work the CircomReduction witness map
requires at the configuration's domain size n, priced against the card's
peaks (peaks.json): six size-n radix-2 transforms (three iFFTs, three
coset FFTs), counting only the butterflies whose twiddle is not one,
(n/2) log2 n - (n - 1) Montgomery multiplies each, plus the pointwise
multiplies c = a o b, a b, and the coset shift of a, b and c (n - 1 each:
g^0 = 1; the iFFT's 1/n rides the coset table), at peaks' multiply-adds a
multiply; the bytes are 32 an element read once and written once a
transform. The larger of the two times is the bound.

Denominator: the device seconds of every operation launched inside the
program's `prove.witness_map` stage, kernels and PyTorch built-ins alike,
from the profiled stretch. No device time recorded: no value.
"""


def work(n: int):
    """(Montgomery multiplies, bytes) the witness map needs at domain n."""
    log_n = n.bit_length() - 1
    per_transform = (n // 2) * log_n - (n - 1)
    mults = 6 * per_transform + 2 * n + 3 * (n - 1)
    return mults, 6 * 2 * 32 * n


def bound_s(n: int, peaks: dict) -> float:
    mults, nbytes = work(n)
    return max(mults * peaks["mont_mul_mads"] / peaks["int32_mad_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def read(rec):
    prof = rec["profile"]
    device_s = prof["stage_device_s"].get("prove.witness_map") if prof else None
    if not device_s:
        return None
    proves = len(rec["profiled"])
    return 100.0 * proves * bound_s(rec["config"]["domain_size"], rec["peaks"]) / device_s
