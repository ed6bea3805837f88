"""The seconds of the batch's `prove.encode` span (the witness's Python ints
encoded and copied to the card on BatchProver.prove_many's feeding thread),
over the proofs of the traced run's profiled stretch: the mean over the
requests that hold a `batch.witness_wait` span of each one's encode, from
the spans that utils/trace.py `recent()` keeps flagged `profiled` (nothing
synchronizes the card there). None on a program without those spans."""


def read(rec):
    from circom_compat_tpu_torch.utils import trace

    recent = getattr(trace, "recent", None)
    if recent is None:
        return None
    spans = [sp for sp in recent() if sp.profiled]
    batch = {sp.request_id for sp in spans if sp.name == "batch.witness_wait"}
    by_request = {rid: 0.0 for rid in batch}
    for sp in spans:
        if sp.name == "prove.encode" and sp.request_id in batch:
            by_request[sp.request_id] += sp.seconds
    return sum(by_request.values()) / len(by_request) if by_request else None
