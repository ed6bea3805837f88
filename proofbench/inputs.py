"""The benchmark's inputs, made from the seed: a pooled known-dlog proving
key for the squaring chain, its `.zkey`, witness files, and request inputs.

Frozen copies, so that a later change to the program cannot move the
yardstick:
  - the chain's assignment is reference.chain_witness, the copy of
    circom_compat_tpu_torch/utils/chain.py `chain_witness`;
  - `chain_matrices` is that file's `chain_matrices` (row i of A and of B
    reads wire i + 2 with coefficient one), as plain arrays;
  - `PooledKey` is chip_smoke.py's `point_pools` and `synthetic_key`: POOL
    seeded scalars k_j with k_j G1 and k_j G2; query row i of a section is
    the pool point (i + offset) mod POOL, three rows per section are
    infinity; alpha, beta, gamma, delta seeded;
  - `write_zkey` is circom_compat_tpu_torch/circom/zkey_writer.py
    `write_zkey` (snarkjs layout, Fq in Montgomery form, section-4
    coefficients as v R^2 with the appended public-input rows), vectorised;
  - `write_wtns` is circom_compat_tpu_torch/circom/wtns.py `write_wtns`.
"""

from __future__ import annotations

import random
import struct
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from reference import G1, G2, Q, R, chain_witness, ints_to_bytes

POOL = 509
OFFSETS = {"a": 0, "b1": 101, "l": 202, "h": 303, "b2": 404}
INFINITY_ROWS = (5, 77)  # and length - 3
ZKEY_MAGIC, WTNS_MAGIC = b"zkey", b"wtns"


def chain_matrices(k: int) -> dict:
    """The chain's A and B as COO arrays of plain coefficients."""
    rows = np.arange(k, dtype=np.int64)
    return {"num_constraints": k, "a_rows": rows, "a_cols": rows + 2, "a_coeffs": [1] * k,
            "b_rows": rows.copy(), "b_cols": rows + 2, "b_coeffs": [1] * k}


def _mont_q(v: int) -> bytes:
    return ((v << 256) % Q).to_bytes(32, "little")


def g1_bytes(p) -> bytes:
    return b"\0" * 64 if p is None else _mont_q(p[0]) + _mont_q(p[1])


def g2_bytes(p) -> bytes:
    if p is None:
        return b"\0" * 128
    (x0, x1), (y0, y1) = p
    return _mont_q(x0) + _mont_q(x1) + _mont_q(y0) + _mont_q(y1)


@dataclass
class PooledKey:
    """A proving key for the chain of k squares whose every point has a
    known discrete log."""

    k: int
    domain_size: int
    ks: List[int]
    alpha: int
    beta: int
    gamma: int
    delta: int
    g1_pool: list
    g2_pool: list
    pool: int = POOL
    num_inputs: int = 2  # the constant one and the public output
    n_public: int = 1

    @property
    def n_vars(self) -> int:
        return self.k + 2

    @staticmethod
    def make(k: int, domain_size: int, rng: random.Random) -> "PooledKey":
        if domain_size < k + 2 or domain_size & (domain_size - 1):
            raise ValueError(f"domain {domain_size} cannot hold {k} constraints and 2 inputs")
        ks = [rng.randrange(1, R) for _ in range(POOL)]
        alpha, beta, gamma, delta = (rng.randrange(1, R) for _ in range(4))
        return PooledKey(k, domain_size, ks, alpha, beta, gamma, delta,
                         [G1.affine(G1.mul_gen(x)) for x in ks],
                         [G2.affine(G2.mul_gen(x)) for x in ks])

    def section_lengths(self) -> Dict[str, int]:
        n = self.n_vars
        return {"a": n, "b1": n, "b2": n, "l": n - self.n_public - 1, "h": self.domain_size}

    def class_index(self) -> Dict[str, np.ndarray]:
        """Per section, each row's pool index; POOL for a row at infinity."""
        out = {}
        for name, length in self.section_lengths().items():
            idx = (np.arange(length, dtype=np.int64) + OFFSETS[name]) % POOL
            idx[[i for i in INFINITY_ROWS + (length - 3,) if i < length]] = POOL
            out[name] = idx
        return out

    def matrices(self) -> dict:
        return chain_matrices(self.k)

    def write_zkey(self, path: str) -> int:
        """The key as a snarkjs Groth16 `.zkey`; returns its size in bytes."""
        mul1 = lambda x: G1.affine(G1.mul_gen(x))  # noqa: E731
        mul2 = lambda x: G2.affine(G2.mul_gen(x))  # noqa: E731
        hdr = (struct.pack("<I", 32) + Q.to_bytes(32, "little") + struct.pack("<I", 32)
               + R.to_bytes(32, "little")
               + struct.pack("<III", self.n_vars, self.n_public, self.domain_size)
               + g1_bytes(mul1(self.alpha)) + g1_bytes(mul1(self.beta)) + g2_bytes(mul2(self.beta))
               + g2_bytes(mul2(self.gamma)) + g1_bytes(mul1(self.delta))
               + g2_bytes(mul2(self.delta)))
        ic = b"".join(g1_bytes(p) for p in self.g1_pool[: self.n_public + 1])

        # section 4: both matrices' rows, then the appended public-input rows
        k = self.k
        entry = np.dtype([("m", "<u4"), ("c", "<u4"), ("s", "<u4"), ("v", "u1", (32,))])
        coeffs = np.zeros(2 * k + self.n_public + 1, entry)
        one = np.frombuffer(((1 << 512) % R).to_bytes(32, "little"), np.uint8)
        rows = np.arange(k, dtype=np.uint32)
        coeffs["m"][k : 2 * k] = 1
        coeffs["c"][:k], coeffs["c"][k : 2 * k] = rows, rows
        coeffs["s"][:k], coeffs["s"][k : 2 * k] = rows + 2, rows + 2
        tail = np.arange(self.n_public + 1, dtype=np.uint32)
        coeffs["c"][2 * k :] = k + tail
        coeffs["s"][2 * k :] = tail
        coeffs["v"][:] = one
        sec4 = struct.pack("<I", len(coeffs)) + coeffs.tobytes()

        pools = {False: np.frombuffer(b"".join(g1_bytes(p) for p in self.g1_pool) + bytes(64),
                                      np.uint8).reshape(POOL + 1, 64),
                 True: np.frombuffer(b"".join(g2_bytes(p) for p in self.g2_pool) + bytes(128),
                                     np.uint8).reshape(POOL + 1, 128)}
        classes = self.class_index()
        sections = [(1, struct.pack("<I", 1)), (2, hdr), (3, ic), (4, sec4)]
        for sec_id, name in ((5, "a"), (6, "b1"), (7, "b2"), (8, "l"), (9, "h")):
            sections.append((sec_id, pools[name == "b2"][classes[name]].tobytes()))
        sections.append((10, bytes(64) + struct.pack("<I", 0)))
        with open(path, "wb") as fh:
            fh.write(ZKEY_MAGIC + struct.pack("<II", 1, len(sections)))
            for sec_id, payload in sections:
                fh.write(struct.pack("<IQ", sec_id, len(payload)))
                fh.write(payload)
            size = fh.tell()
        return size


def write_wtns(values: List[int], path: str) -> None:
    """A snarkjs `.wtns` (version 2) of the field elements `values`."""
    header = struct.pack("<I", 32) + R.to_bytes(32, "little") + struct.pack("<I", len(values))
    body = ints_to_bytes([v % R for v in values])
    with open(path, "wb") as fh:
        fh.write(WTNS_MAGIC + struct.pack("<II", 2, 2))
        fh.write(struct.pack("<IQ", 1, len(header)) + header)
        fh.write(struct.pack("<IQ", 2, len(body)) + body)


def chain_wtns(k: int, a: int, path: str) -> None:
    write_wtns(chain_witness(k, a), path)
