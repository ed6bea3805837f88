"""The mean seconds of the program's span `server.read_wtns` a request (the
.wtns file read and widened to (N, 16) limbs inside ProveServer.handle),
over the traced run's profiled stretch: the spans that utils/trace.py
`recent()` keeps flagged `profiled`, where no collector and no logger
listens, so no span synchronizes the card. None on a program without
those spans."""


def read(rec):
    from circom_compat_tpu_torch.utils import trace

    recent = getattr(trace, "recent", None)
    if recent is None:
        return None
    by_request = {}
    for sp in recent():
        if sp.profiled and sp.name == "server.read_wtns":
            by_request[sp.request_id] = by_request.get(sp.request_id, 0.0) + sp.seconds
    return sum(by_request.values()) / len(by_request) if by_request else None
