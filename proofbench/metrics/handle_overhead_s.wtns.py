"""The mean of the benchmark's host-clock span around ProveServer.handle
less the prove_s the server returns, a request: the .wtns read, the public
inputs' decode and the response's JSON."""


def read(rec):
    pairs = rec["handle"]
    return sum(span - prove for span, prove in pairs) / len(pairs) if pairs else None
