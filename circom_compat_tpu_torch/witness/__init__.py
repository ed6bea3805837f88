"""Witness generation layer: a first-party WASM interpreter and the circom
ABI bindings (reference: src/witness/)."""

from .calculator import WitnessCalculator, WitnessCalcError  # noqa: F401
from .fnv import fnv  # noqa: F401
from .memory import SafeMemory  # noqa: F401
from .circom_abi import Wasm  # noqa: F401
