"""The device's idle share over the profiled stretch of requests, in %:
100 (1 - union of device activity / the stretch's span). No collector and
no logger is active there, so no stage synchronizes the card."""


def read(rec):
    prof = rec["profile"]
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
