"""From-scratch core-WASM decoder + interpreter (no external WASM runtime)."""

from .module import decode_module, Module  # noqa: F401
from .interp import Instance, Memory, WasmTrap, instantiate  # noqa: F401
