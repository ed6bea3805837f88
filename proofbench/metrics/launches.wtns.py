"""The program's kernel launches a request: the sum of
ops/field_kernels.LAUNCHES and ops/curve_kernels.LAUNCHES over one
ProveServer.handle, averaged over the collected stretch."""


def read(rec):
    counts = rec["launches"]
    return sum(counts) / len(counts) if counts else None
