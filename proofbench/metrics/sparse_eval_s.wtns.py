"""The mean seconds of the program's span `witness_map.sparse` a request
(the A z and B z row sums of ops/ntt.py `witness_map`, nested in
`prove.witness_map`), over the traced run's collected stretch (a collected
span synchronizes the card at both ends, so it holds its own device work).
None on a program without the span."""

LEAF = "witness_map.sparse"


def read(rec):
    seconds = [s for path, values in rec["stages"].items()
               if path.rsplit("/", 1)[-1] == LEAF for s in values]
    requests = len(rec["launches"])
    return sum(seconds) / requests if seconds and requests else None
