"""circomlib's SHA-256 generator (proofbench/circuits/sha256.py) on the CPU.

  - its witness's 256 public outputs equal hashlib.sha256 on seeded
    messages at the one- and two-block padding edges and at the benchmark
    configuration's 2103 bytes;
  - a one-block witness satisfies A z o B z = C z on every row, and one
    flipped bit breaks a row;
  - one round of the compression (proofbench/tests/circuits/sha256_round.py,
    built from the generator's template functions) gives the new state of a
    plain SHA-256 round and satisfies its rows. proofbench/tests proves that
    round through ProveServer.handle against the benchmark's plain
    reference: one CPU prove costs about 35 s at any size (the plain
    versions' tile scans), too long for this file.

Every wire is 0 or 1 and every coefficient is below 2^35 in magnitude, so
the row sums are exact in int64, and equal mod r exactly when equal.
"""

import hashlib
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "proofbench"))
import harness  # noqa: E402

torch.set_num_threads(1)
SHA = harness.load_generator("sha256")
ROUND = harness._load(harness.HERE / "tests" / "circuits" / "sha256_round.py",
                      "test_circuit_sha256_round")
SEED = 2**31 + 1811


def rows_hold(mats: dict, z, n_rows: int) -> np.ndarray:
    """For each row, whether (A z)(B z) = C z."""
    zi = np.asarray(z, dtype=np.int64)
    ev = {}
    for m, (rows, cols, coeffs) in mats.items():
        acc = np.zeros(n_rows, np.int64)
        np.add.at(acc, rows, np.asarray(coeffs, np.int64) * zi[cols])
        ev[m] = acc
    return ev["a"] * ev["b"] == ev["c"]


def digest(z) -> bytes:
    """The 256 public outputs, main's out, as bytes."""
    return np.packbits(np.asarray(z[1:257], np.uint8)).tobytes()


# the one- and two-block padding edges, and sha256_2e20's 33 blocks
@pytest.mark.parametrize("n_bytes", [0, 3, 55, 56, 64, 119, 2103])
def test_outputs_are_the_digest(n_bytes):
    cfg = {"message_bytes": n_bytes}
    msg = SHA.pool_input(cfg, harness.request_rng(SEED, "msg", n_bytes))
    z = SHA.witness(cfg, msg)
    assert len(z) == SHA.shape(cfg)["n_vars"] and z[0] == 1
    assert digest(z) == hashlib.sha256(msg).digest()


@pytest.fixture(scope="module")
def one_block():
    cfg = {"message_bytes": 55}
    shape = SHA.shape(cfg)
    msg = SHA.pool_input(cfg, harness.request_rng(SEED, "block"))
    return cfg, shape, SHA.matrices(cfg), SHA.witness(cfg, msg)


def test_one_block_satisfies_every_row(one_block):
    cfg, shape, mats, z = one_block
    assert SHA.n_blocks(8 * cfg["message_bytes"]) == 1
    assert max(int(m[0].max()) for m in mats.values()) == shape["num_constraints"] - 1
    assert all(rows_hold(mats, z, shape["num_constraints"]))


# a public output (the last block's out), a message bit, the block's wires
# early, in the middle and at its end (fsum's carries)
@pytest.mark.parametrize("where", ["out", "in", 0.1, 0.5, 0.999])
def test_a_flipped_bit_breaks_a_row(one_block, where):
    cfg, shape, mats, z = one_block
    n_in = 8 * cfg["message_bytes"]
    first = 257 + n_in
    i = {"out": 100, "in": 257 + n_in // 2}.get(where)
    if i is None:
        i = first + int(where * (shape["n_vars"] - first))
    bad = list(z)
    bad[i] ^= 1
    assert not all(rows_hold(mats, bad, shape["num_constraints"]))


def _plain_round(x, t):
    """The new state a..h of SHA-256's round t on Python ints."""
    def rotr(v, r):
        return ((v >> r) | (v << (32 - r))) & 0xFFFFFFFF

    a, b, c, d, e, f, g, h = x[:8]
    s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
    ch = (e & f) ^ (~e & g)
    t1 = (h + s1 + ch + SHA.K64[t] + x[8]) & 0xFFFFFFFF
    s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
    mj = (a & b) ^ (a & c) ^ (b & c)
    t2 = (s0 + mj) & 0xFFFFFFFF
    return [(t1 + t2) & 0xFFFFFFFF, a, b, c, (d + t1) & 0xFFFFFFFF, e, f, g]


@pytest.mark.parametrize("t", [0, 63])
def test_one_round_is_a_sha256_round(t):
    cfg = {"round": t}
    shape = ROUND.shape(cfg)
    x = ROUND.pool_input(cfg, harness.request_rng(SEED, "round", t))
    z = ROUND.witness(cfg, x)
    out = np.asarray(z[1:257], np.int64).reshape(8, 32)
    assert [int(w @ SHA.POW2[:32]) for w in out] == _plain_round(x, t)
    assert len(z) == shape["n_vars"]
    assert all(rows_hold(ROUND.matrices(cfg), z, shape["num_constraints"]))
