"""One round of SHA-256's compression, built from circuits/sha256.py's
template functions: a test-only circuit generator of a few hundred rows.

Wires [1, out (256), a..h (256), w (32), the round's own]: the round t =
cfg["round"] of Sha256compression (T1, T2, sume and suma, K(t) a
constant) on the private inputs a..h and w, each word least significant
bit first; main's out <== the new state (a..h)[t + 1], one C-only row a
bit (main's signals are not substituted away), its 256 bits the public
signals. A pool input is nine seeded 32-bit words, the state a..h and w.
No witness module.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import List

import numpy as np

_SHA256 = Path(__file__).resolve().parents[2] / "circuits" / "sha256.py"
_spec = importlib.util.spec_from_file_location("proofbench_circuit_sha256_of_round", _SHA256)
sha = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sha)


def _build(cfg: dict, x, rows: bool) -> sha.System:
    cs = sha.System(rows)
    out = cs.signal(np.zeros(8 * sha.WORD, np.int64))
    state = [cs.signal(sha.bits_of(v)) for v in x[:8]]
    w = cs.signal(sha.bits_of(x[8]))
    k = sha.k_const(cfg.get("round", 0))
    new = sha.cat(sha.sha_round(cs, state, k, w))
    cs.rows(len(out), c=[(out.wires, 1), (new.wires, -1)])
    out.bits[:] = new.bits
    return cs


def shape(cfg: dict) -> dict:
    cs = _build(cfg, [0] * 9, False)
    return {"num_constraints": cs.n_rows, "n_vars": 1 + cs.n_wires, "num_inputs": 257}


def matrices(cfg: dict) -> dict:
    return sha.place(_build(cfg, [0] * 9, True).local_coo(), 1, 0)


def pool_input(cfg: dict, rng) -> tuple:
    return tuple(rng.getrandbits(32) for _ in range(9))


def witness(cfg: dict, x) -> List[int]:
    return [1] + _build(cfg, x, False).value_array().tolist()


def signals(x) -> dict:
    return {"state": list(x[:8]), "w": x[8]}


def wasm(cfg: dict):
    return None
