"""Host oracle: exact BN254 field, curve and pairing arithmetic on Python ints."""

from . import curve, field, pairing  # noqa: F401
