"""Prover and setup: device proving key, prove core, the streamed prover,
the Groth16 facade and the trusted setup."""

from .groth16 import Groth16, Proof  # noqa: F401
from .setup import (  # noqa: F401
    generate_parameters,
    generate_parameters_from_matrices,
    generate_random_parameters,
)
from .streamed import StreamedProvingKey, prove_streamed  # noqa: F401
