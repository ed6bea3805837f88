"""The mean seconds of the program's span `server.handle` less its
`server.prove` child, a request: ProveServer.handle's own host work (the
.wtns read, the public inputs' decode, the response), timed inside the
server, over the traced run's profiled stretch (the spans that
utils/trace.py `recent()` keeps flagged `profiled`; nothing synchronizes
the card there). None on a program without those spans."""


def read(rec):
    from circom_compat_tpu_torch.utils import trace

    recent = getattr(trace, "recent", None)
    if recent is None:
        return None
    spans = [sp for sp in recent() if sp.profiled]
    prove = {}
    for sp in spans:
        if sp.name == "server.prove":
            prove[sp.parent_id] = prove.get(sp.parent_id, 0.0) + sp.seconds
    host = [sp.seconds - prove.get(sp.span_id, 0.0) for sp in spans if sp.name == "server.handle"]
    return sum(host) / len(host) if host else None
