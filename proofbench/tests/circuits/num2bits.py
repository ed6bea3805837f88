"""circomlib's Num2Bits(n) (circuits/bitify.circom) as `circom --O0` writes
it, its n bits the public outputs: a test-only circuit generator.

Wires [1, out[0..n-1], in] for n = cfg["bits"]. Constraints: for i < n,
out[i] * (out[i] - 1) = 0, whose B holds r - 1 on the constant wire; then
the linear sum_i 2^i out[i] - in = 0, which circom writes with A and B
empty and every term in C, so that the zkey carries none of it. No
witness module.
"""

from __future__ import annotations

from typing import List

import numpy as np

from reference import R


def shape(cfg: dict) -> dict:
    n = cfg["bits"]
    return {"num_constraints": n + 1, "n_vars": n + 2, "num_inputs": n + 1}


def matrices(cfg: dict) -> dict:
    n = cfg["bits"]
    i = np.arange(n, dtype=np.int64)
    a = (i, i + 1, np.ones(n, dtype=np.int64))
    b = (np.repeat(i, 2), np.stack((np.zeros(n, dtype=np.int64), i + 1), axis=1).reshape(-1),
         [R - 1, 1] * n)
    c = (np.full(n + 1, n, dtype=np.int64), np.arange(1, n + 2, dtype=np.int64),
         [1 << j for j in range(n)] + [R - 1])
    return {"a": a, "b": b, "c": c}


def pool_input(cfg: dict, rng) -> int:
    return rng.randrange(1 << cfg["bits"])


def witness(cfg: dict, x: int) -> List[int]:
    n = cfg["bits"]
    return [1] + [(x >> j) & 1 for j in range(n)] + [x]


def signals(x: int) -> dict:
    return {"in": x}


def wasm(cfg: dict):
    return None
