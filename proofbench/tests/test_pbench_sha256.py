"""circomlib's SHA-256 (circuits/sha256.py) and the two metrics of its cell.

  - the blocks placed by `matrices` equal one traversal of the whole
    circuit (`traverse`) at 2 blocks, row for row and term for term, and
    that traversal's values are the witness, which satisfies the rows;
  - --O1 left no copy or constant row, and no wire outside A and B;
  - the constraint table of the module's docstring adds up, each template
    built alone gives its rows and wires, and the table gives `shape`;
  - sha256_2e20's shape fits its domain, one more block would not, and its
    window is the program's pick;
  - one round (tests/circuits/sha256_round.py) through harness.run on the
    CPU: correct, and not correct with a faulted answer; the control fails
    every answer;
  - msm_digit_share.wtns and sparse_eval_s.wtns return None without their
    counter or span, and msm_digit_share.wtns against a hand count.
"""

import json
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import control
import harness
import reference

torch.set_num_threads(2)
SHA = harness.load_generator("sha256")
ROUND_FILE = Path(__file__).resolve().parent / "circuits" / "sha256_round.py"
SEED = 2**31 + 1817


def _rows_hold(mats, z, n_rows):
    """Whether (A z)(B z) = C z on each row: every wire is 0 or 1 and every
    coefficient small, so int64 sums are exact."""
    zi = np.asarray(z, dtype=np.int64)
    ev = {}
    for m, (rows, cols, coeffs) in mats.items():
        acc = np.zeros(n_rows, np.int64)
        np.add.at(acc, rows, np.asarray(coeffs, np.int64) * zi[cols])
        ev[m] = acc
    return ev["a"] * ev["b"] == ev["c"]


@pytest.fixture(scope="module")
def two_blocks():
    cfg = {"message_bytes": 64 + 30}
    msg = SHA.pool_input(cfg, harness.request_rng(SEED, "two"))
    return cfg, msg, SHA.matrices(cfg), SHA.witness(cfg, msg)


def test_placed_blocks_equal_a_direct_build(two_blocks):
    cfg, msg, mats, z = two_blocks
    assert SHA.n_blocks(8 * cfg["message_bytes"]) == 2
    cs = SHA.traverse(SHA.message_bits(msg), True)
    shape = SHA.shape(cfg)
    assert (cs.n_rows, 1 + cs.n_wires) == (shape["num_constraints"], shape["n_vars"])
    direct = SHA.place(cs.local_coo(), 1, 0)
    for m in "abc":
        for placed, built in zip(mats[m], direct[m]):
            assert np.array_equal(placed, built), m
    assert z == [1] + cs.value_array().tolist()


def test_two_blocks_satisfy_every_row(two_blocks):
    cfg, _, mats, z = two_blocks
    assert all(_rows_hold(mats, z, SHA.shape(cfg)["num_constraints"]))


def test_no_copy_or_constant_row_is_left(two_blocks):
    """--O1, on a block whose hin and inp are all signals: the rows with A
    empty are the BinSums' lin === lout alone (312, each over two 32-bit
    words and more), those with B alone empty the Xor3 mid rows on ShR's
    zero bits (48 SigmaPlus x (10 + 3)); no row holds a signal equal to another
    or to a constant. In the whole circuit every wire is in a row."""
    coo, own, n = SHA._block_rows()
    in_a, in_b = np.zeros(n, bool), np.zeros(n, bool)
    in_a[coo["a"][0]] = in_b[coo["b"][0]] = True
    c_terms = np.bincount(coo["c"][0], minlength=n)
    assert (~in_a).sum() == 312 and c_terms[~in_a].min() >= 2 * SHA.WORD + 1
    assert (in_a & ~in_b).sum() == 48 * 13
    cfg, _, mats, _ = two_blocks
    used = np.zeros(SHA.shape(cfg)["n_vars"], bool)
    for m in "abc":
        used[mats[m][1]] = True
    assert used.all()


def _table():
    """{template: (rows, wires, [(count, component)])} from the docstring."""
    rows = {}
    for line in SHA.__doc__.splitlines():
        m = re.match(r"^ {4}(\S+)\s+(\d+)\s+(\d+)(?:\s+(.*))?$", line)
        if m:
            parts = [p.split(" ", 1) for p in (m.group(4) or "").split(", ") if p]
            rows[m.group(1)] = (int(m.group(2)), int(m.group(3)),
                                [(int(k), name) for k, name in parts])
    return rows


def test_docstring_counts_add_up_to_shape():
    table = _table()
    assert len(table) == 16
    for name, (rows, wires, parts) in table.items():
        if parts:  # --O1 leaves a composite template no row or wire of its own
            assert rows == sum(k * table[c][0] for k, c in parts), name
            assert wires == sum(k * table[c][1] for k, c in parts), name
    main = re.search(r"(\d+) B rows; wires 1 \+ nBits \+ (\d+) B", SHA.__doc__)
    block_rows, block_wires = (int(g) for g in main.groups())
    assert (block_rows, block_wires) == table["Sha256compression"][:2]
    for n_bytes in (0, 55, 56, 2103):
        b = SHA.n_blocks(8 * n_bytes)
        assert SHA.shape({"message_bytes": n_bytes}) == {
            "num_constraints": block_rows * b, "n_vars": 1 + 8 * n_bytes + block_wires * b,
            "num_inputs": 257}


# each template: the 32-bit words it takes, and its build on them
BUILDS = {
    "RotR(32,r)": (1, lambda cs, x: SHA.rotr(x[0], 7)),
    "ShR(32,r)": (1, lambda cs, x: SHA.shr(x[0], 3)),
    "Xor3(32)": (3, lambda cs, x: SHA.xor3(cs, *x)),
    "Ch_t(32)": (3, lambda cs, x: SHA.ch(cs, *x)),
    "Maj_t(32)": (3, lambda cs, x: SHA.maj(cs, *x)),
    "BinSum(32,2)": (2, lambda cs, x: SHA.binsum(cs, x)),
    "BinSum(32,4)": (4, lambda cs, x: SHA.binsum(cs, x)),
    "BinSum(32,5)": (5, lambda cs, x: SHA.binsum(cs, x)),
    "K(t)": (0, lambda cs, x: SHA.k_const(5)),
    "H(x)": (0, lambda cs, x: SHA.h_const(5)),
    "SmallSigma": (1, lambda cs, x: SHA.small_sigma(cs, x[0], 7, 18, 3)),
    "BigSigma": (1, lambda cs, x: SHA.big_sigma(cs, x[0], 2, 13, 22)),
    "SigmaPlus": (4, lambda cs, x: SHA.sigma_plus(cs, *x)),
    "T1": (6, lambda cs, x: SHA.t1(cs, *x)),
    "T2": (3, lambda cs, x: SHA.t2(cs, *x)),
    "Sha256compression": (24, lambda cs, x: SHA.compression(cs, SHA.cat(x[:8]),
                                                            SHA.cat(x[8:]))),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_each_template_builds_its_count(name):
    cs = SHA.System(True)
    words, build = BUILDS[name]
    build(cs, [cs.signal(np.zeros(32, np.int64)) for _ in range(words)])
    assert (cs.n_rows, cs.n_wires - 32 * words) == _table()[name][:2]


def test_the_configuration_fits_its_domain():
    from circom_compat_tpu_torch.ops.msm import pick_window_bits

    cfg = harness.load_json(harness.HERE / "configs" / "sha256_2e20.json")
    shape = SHA.shape(cfg)
    blocks = SHA.n_blocks(8 * cfg["message_bytes"])
    assert cfg["message_bytes"] == 64 * blocks - 9
    assert shape["num_constraints"] + shape["num_inputs"] <= cfg["domain_size"]
    more = SHA.shape({"message_bytes": 64 * (blocks + 1) - 9})
    assert more["num_constraints"] + more["num_inputs"] > cfg["domain_size"]
    assert cfg["window_bits"] == pick_window_bits(max(shape["n_vars"], cfg["domain_size"]))
    assert cfg["reduced"] == []


ROUND = {"name": "sha256_round", "generator": "sha256_round", "round": 0, "domain_size": 1024,
         "window_bits": 8, "witness_pool": 2}
CPU_TRAFFIC = {"profile_seconds": 0.0, "profile_min_requests": 1}


@pytest.fixture
def round_bench(tmp_path, monkeypatch):
    """BENCHMARK.json with the one-round circuit in the cell
    `sha256_round.wtns`, its generator found beside the others, the
    program's MSM window at 8 bits."""
    from circom_compat_tpu_torch.models import groth16_device as gd

    monkeypatch.setattr(gd, "default_window_bits", lambda dpk: 8)
    circuits = tmp_path / "circuits"
    circuits.mkdir()
    (circuits / ROUND_FILE.name).symlink_to(ROUND_FILE)
    monkeypatch.setattr(harness, "CIRCUITS", circuits)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    path = tmp_path / "sha256_round.json"
    path.write_text(json.dumps(ROUND))
    bench["configs"].append({"name": "sha256_round", "file": str(path), "reduced": []})
    bench["workloads"].append({"name": "sha256_round.wtns", "config": "sha256_round",
                               "traffic": "wtns", "chips": 1})
    return bench


def test_the_control_fails_on_one_round(round_bench):
    for seed in (3, 2**31 + 7):
        compared = control.run_control("sha256_round.wtns", seed, "cpu", round_bench)
        assert not harness.is_correct(compared)
        assert compared["answers_wrong"]["value"] == compared["answers_checked"]["value"] > 0


def _alter_answer(monkeypatch):
    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.refmath import curve as rc

    original = gd.assemble_proof

    def altered(*args, **kwargs):
        p = original(*args, **kwargs)
        return type(p)(a=p.a, b=p.b, c=rc.G1.add(p.c, rc.g1_generator()))

    monkeypatch.setattr(gd, "assemble_proof", altered)


@pytest.mark.parametrize("fault, correct", [(None, True), (_alter_answer, False)])
def test_a_run_on_one_round(round_bench, monkeypatch, fault, correct):
    """The whole run on the CPU: every answer's proof against the
    reference's point for point, and its 256 public bits."""
    if fault:
        fault(monkeypatch)
    res = harness.run("sha256_round.wtns", SEED, 0.5, False, "cpu", time.perf_counter(),
                      round_bench, traffic_overrides=CPU_TRAFFIC)
    assert res["correct"] is correct, res["compared"]
    assert res["compared"]["answers_checked"]["value"] >= 1


DIGITS = harness.load_metric("msm_digit_share.wtns")
SPARSE = harness.load_metric("sparse_eval_s.wtns")


def _rec(f, z, h, ni, c):
    return {"config": {"window_bits": c}, "profiled": [{"pool": 0, "error": None}] * 2,
            "scalars": {0: {"z": f.from_ints(z), "h": f.from_ints(h), "num_inputs": ni}},
            "stages": {}, "launches": [1, 1]}


def test_readers_find_nothing_without_their_counter_or_span(monkeypatch):
    from circom_compat_tpu_torch.ops import msm

    f = reference.Fr("cpu")
    rec = _rec(f, [1, 1, 0, 1, 0], [0, 1 << 13, 5, 0], 2, 13)
    monkeypatch.delattr(msm, "BUCKET_ROWS")
    monkeypatch.delattr(msm, "BUCKET_CALLS")
    assert DIGITS.read(rec) is None
    assert SPARSE.read(rec) is None
    rec["stages"] = {"prove.witness_map": [0.5, 0.5]}
    assert SPARSE.read(rec) is None
    rec["stages"]["prove.witness_map/witness_map.sparse"] = [0.25, 0.75]
    assert SPARSE.read(rec) == 0.5


def test_digit_share_hand_count(monkeypatch):
    """z = [1, 1, 0, 1, 0], two public wires, h = [0, 2^13, 5, 0] at c = 13:
    nonzero digits A 3, B1 3, B2 3, L 1 (z[2:]), H 2 = 12 a proof; rows
    W (5 + 5 + 3 + 4) in G1 and W 5 in G2 a call, two calls of each."""
    from circom_compat_tpu_torch.ops import msm

    W = msm.num_windows(13)
    monkeypatch.setattr(msm, "BUCKET_ROWS", {"g1": 2 * W * 17, "g2": 2 * W * 5})
    monkeypatch.setattr(msm, "BUCKET_CALLS", {"g1": 2, "g2": 2})
    f = reference.Fr("cpu")
    rec = _rec(f, [1, 1, 0, 1, 0], [0, 1 << 13, 5, 0], 2, 13)
    assert DIGITS.read(rec) == pytest.approx(100.0 * 12 / (22 * W))
    monkeypatch.setattr(msm, "BUCKET_CALLS", {"g1": 0, "g2": 0})
    assert DIGITS.read(rec) is None
