"""The seconds BatchProver.prove_many's feeding thread waits for the next
witness (the program's span `batch.witness_wait`), over the proofs of the
traced run's profiled stretch: the mean over requests of each request's
waits, from the spans that utils/trace.py `recent()` keeps flagged
`profiled` (no collector and no logger listens there, so nothing
synchronizes the card). None on a program without those spans."""


def read(rec):
    from circom_compat_tpu_torch.utils import trace

    recent = getattr(trace, "recent", None)
    if recent is None:
        return None
    by_request = {}
    for sp in recent():
        if sp.profiled and sp.name == "batch.witness_wait":
            by_request[sp.request_id] = by_request.get(sp.request_id, 0.0) + sp.seconds
    return sum(by_request.values()) / len(by_request) if by_request else None
