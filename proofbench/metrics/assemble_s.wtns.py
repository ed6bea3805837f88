"""The mean seconds of the program's trace stage `prove.assemble` a request, over the
traced run's collected stretch (a collected stage synchronizes the card at
both ends, so it holds its own device work)."""


def read(rec):
    seconds = rec["stages"].get("prove.assemble")
    return sum(seconds) / len(seconds) if seconds else None
