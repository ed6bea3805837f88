"""The squaring chain of upstream's complex-circuit, `b[i] <== b[i-1] * b[i-1]`.

Wires [1, out, a, b1..b_{k-1}] for k = cfg["k"] constraints: row i
squares wire i + 2 into wire i + 3, the last row into `out` (wire 1), the
one public output. Frozen copies of circom_compat_tpu_torch/utils/chain.py
`chain_witness` and `chain_matrices` (with C), and of its witness module
(chain_wasm.py).
"""

from __future__ import annotations

from typing import List

import numpy as np

from reference import R


def shape(cfg: dict) -> dict:
    k = cfg["k"]
    return {"num_constraints": k, "n_vars": k + 2, "num_inputs": 2}


def matrices(cfg: dict) -> dict:
    k = cfg["k"]
    rows = np.arange(k, dtype=np.int64)
    ones = np.ones(k, dtype=np.int64)
    out = rows + 3
    out[-1] = 1
    return {"a": (rows, rows + 2, ones), "b": (rows, rows + 2, ones), "c": (rows, out, ones)}


def pool_input(cfg: dict, rng) -> int:
    return rng.randrange(1, R)


def chain_witness(k: int, a: int) -> List[int]:
    """[1, out, a, b1..b_{k-1}]: b1 = a^2, b_{i+1} = b_i^2, out = b_{k-1}^2."""
    w = [1, 0, a % R] + [0] * (k - 1)
    v = a % R
    for i in range(k - 1):
        v = v * v % R
        w[3 + i] = v
    w[1] = v * v % R
    return w


def witness(cfg: dict, x: int) -> List[int]:
    return chain_witness(cfg["k"], x)


def signals(x: int) -> dict:
    return {"a": x}


def wasm(cfg: dict) -> bytes:
    from chain_wasm import chain_wasm

    return chain_wasm(cfg["k"])
