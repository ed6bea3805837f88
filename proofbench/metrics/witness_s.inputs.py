"""The mean seconds of the program's trace stage `witness.calculate`, which
BatchProver's worker threads run: read through the program's trace logger
(CIRCOM_TPU_TIMINGS), to which the harness attaches a handler for the
collected stretch."""


def read(rec):
    seconds = rec["logged"].get("witness.calculate")
    return sum(seconds) / len(seconds) if seconds else None
