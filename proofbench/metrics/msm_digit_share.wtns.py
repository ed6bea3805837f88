"""The share of the rows the MSM gathers that carry a nonzero digit, in %.

Numerator: the nonzero digits of a proof's five MSMs (A, B1, L and H in
G1, B2 in G2) at the configuration's window c (window_bits), counted on
the scalars the reference recomputed for each profiled request's pool
entry, as msm_roofline.wtns counts them; the mean over those requests.

Denominator: the rows ops/msm.py `bucket_sums` gathers into its level-0
reduce a proof, from the program's host-side counters BUCKET_ROWS and
BUCKET_CALLS over the whole run: G1 rows over G1 calls plus G2 rows over
G2 calls (one call of each group a proof). None on a program without the
counters.
"""

import importlib.util
from pathlib import Path


def _roofline():
    path = Path(__file__).with_name("msm_roofline.wtns.py")
    spec = importlib.util.spec_from_file_location("proofbench_metric_msm_roofline.wtns", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rows_a_proof():
    """G1 rows a call plus G2 rows a call, None without the counters."""
    from circom_compat_tpu_torch.ops import msm

    rows, calls = getattr(msm, "BUCKET_ROWS", None), getattr(msm, "BUCKET_CALLS", None)
    if not rows or not calls or not calls.get("g1") or not calls.get("g2"):
        return None
    return rows["g1"] / calls["g1"] + rows["g2"] / calls["g2"]


def digits_a_proof(sc: dict, c: int, nonzero_digits) -> int:
    z, ni = sc["z"], sc["num_inputs"]
    return sum(nonzero_digits(v, c) for v in (z, z, z[:, ni:], sc["h"], z))


def read(rec):
    rows = rows_a_proof()
    done = [ans for ans in rec["profiled"] if ans["error"] is None]
    if not rows or not done:
        return None
    c = rec["config"]["window_bits"]
    nonzero_digits = _roofline().nonzero_digits
    by_pool = {}
    for ans in done:
        sc = rec["scalars"].get(ans["pool"])
        if sc is None:
            return None
        if ans["pool"] not in by_pool:
            by_pool[ans["pool"]] = digits_a_proof(sc, c, nonzero_digits)
    digits = sum(by_pool[ans["pool"]] for ans in done) / len(done)
    return 100.0 * digits / rows
