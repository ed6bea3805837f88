"""The work counts of the two rooflines against hand counts at n = 2^4 and
2^6, and the digit count they read."""

import pytest
import torch

import harness
import reference

NTT = harness.load_metric("ntt_roofline.wtns")
MSM = harness.load_metric("msm_roofline.wtns")


def _nontrivial_twiddles(n):
    """Butterflies of a radix-2 transform whose twiddle exponent is not 0,
    enumerated one by one."""
    count, h = 0, 1
    while h < n:
        for _group in range(n // (2 * h)):
            count += sum(1 for j in range(h) if j * (n // (2 * h)) % n)
        h *= 2
    return count


@pytest.mark.parametrize("n, mults, nbytes", [
    # 6 transforms x (8 * 4 - 15) + 2 * 16 pointwise + 3 * 15 coset; 6 x 16 x 32 B in and out
    (16, 6 * 17 + 32 + 45, 6 * 16 * 64),
    (64, 6 * 129 + 128 + 189, 6 * 64 * 64),
])
def test_ntt_work_hand_counts(n, mults, nbytes):
    assert _nontrivial_twiddles(n) == (n // 2) * (n.bit_length() - 1) - (n - 1)
    assert NTT.work(n) == (mults, nbytes)


def _sizes(n):
    return {"a": n, "b1": n, "b2": n, "l": n - 2, "h": n}


@pytest.mark.parametrize("n, c, reduce_adds", [
    # 31 windows of 8 bits and one of 6: 31 * 2 * 254 + 2 * 62
    (16, 8, 31 * 2 * 254 + 2 * 62),
    # 19 windows of 13 bits and one of 7: 19 * 2 * 8190 + 2 * 126
    (64, 13, 19 * 2 * 8190 + 2 * 126),
])
def test_msm_work_hand_counts(n, c, reduce_adds):
    sizes = _sizes(n)
    digits = dict(sizes)  # every scalar one nonzero digit
    g1 = (4 * n - 2) * 11 + 4 * reduce_adds * 12
    g2 = n * 39 + reduce_adds * 42
    nbytes = 64 * (4 * n - 2) + 128 * n + 32 * 2 * n
    assert MSM.work(digits, sizes, c) == (g1 + g2, nbytes)


@pytest.mark.parametrize("c, expected", [(8, 2 + 1), (13, 1 + 1)])
def test_nonzero_digits(c, expected):
    f = reference.Fr("cpu")
    # 2^8 + 1: two 8-bit digits, one 13-bit digit; 2^200: one digit; 0: none
    x = f.from_ints([(1 << 8) + 1, 1 << 200, 0])
    assert MSM.nonzero_digits(x, c) == expected


def test_rooflines_silent_without_device_time():
    rec = {"profile": {"stage_device_s": {}, "busy_s": 0.0, "window_s": 1.0}, "profiled": [],
           "config": {"domain_size": 16, "window_bits": 8}, "scalars": {}, "peaks": {}}
    assert NTT.read(rec) is None and MSM.read(rec) is None
    assert harness.load_metric("idle_share.wtns").read(rec) is None


def test_ntt_roofline_reads_the_stage(tmp_path):
    peaks = harness.load_json(harness.HERE / "peaks.json")
    n = 1 << 20
    rec = {"profile": {"stage_device_s": {"prove.witness_map": 0.02}}, "profiled": [{}, {}],
           "config": {"domain_size": n}, "peaks": peaks}
    mults, nbytes = NTT.work(n)
    bound = max(mults * 264 / peaks["int32_mad_per_s"], nbytes / peaks["hbm_bytes_per_s"])
    assert NTT.read(rec) == pytest.approx(100 * 2 * bound / 0.02)
    assert torch.tensor(NTT.read(rec)) < 100
