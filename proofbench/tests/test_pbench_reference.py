"""The plain reference against Python integers and against the program on
the CPU; the control and the faults that the comparison must catch."""

import json
import random
import time
from pathlib import Path

import pytest
import torch

import control
import harness
import inputs
import reference as ref

R = ref.R
torch.set_num_threads(2)


def test_field_ops_match_python_ints():
    rng = random.Random(3)
    f = ref.Fr("cpu")
    xs = [rng.randrange(R) for _ in range(64)] + [0, 1, R - 1]
    ys = [rng.randrange(R) for _ in range(64)] + [R - 1, R - 1, R - 1]
    a, b = f.from_ints(xs), f.from_ints(ys)
    rinv = pow(1 << 256, -1, R)
    assert f.to_ints(f.mul(a, b)) == [x * y * rinv % R for x, y in zip(xs, ys)]
    assert f.to_ints(f.add(a, b)) == [(x + y) % R for x, y in zip(xs, ys)]
    assert f.to_ints(f.sub(a, b)) == [(x - y) % R for x, y in zip(xs, ys)]


@pytest.mark.parametrize("n", [2, 8, 32])
def test_ntt_matches_the_dft(n):
    rng = random.Random(n)
    f = ref.Fr("cpu")
    dom = ref.Domain(f, n)
    v = [rng.randrange(R) for _ in range(n)]
    w = ref.root_of_unity(n)
    dft = [sum(x * pow(w, i * j, R) for i, x in enumerate(v)) % R for j in range(n)]
    rinv = pow(1 << 256, -1, R)
    got = [x * rinv % R for x in f.to_ints(dom.fft(f.mont_ints(v)))]
    assert got == dft
    back = [x * rinv % R for x in f.to_ints(dom.ifft(f.mont_ints(dft)))]
    assert back == v


def test_curve_against_the_program():
    from circom_compat_tpu_torch.refmath import curve as rc

    k = 0x1234567890ABCDEF1234567890ABCDEF
    assert ref.G1.affine(ref.G1.mul_gen(k)) == rc.G1.mul(rc.g1_generator(), k)
    assert ref.G2.affine(ref.G2.mul_gen(k)) == rc.G2.mul(rc.g2_generator(), k)


def test_reference_proof_equals_the_program_on_cpu(tmp_path):
    """zkey and wtns from the benchmark, proved by the program's server on
    the CPU, equal the reference's proof point for point."""
    from circom_compat_tpu_torch.server import ProveServer

    rng = random.Random(2**31 + 99)
    chain, cfg = harness.load_generator("chain"), {"k": 30}
    key = inputs.PooledKey.make(chain.shape(cfg), chain.matrices(cfg), 32, rng)
    key.write_zkey(str(tmp_path / "k.zkey"))
    a, r, s = (rng.randrange(1, R) for _ in range(3))
    inputs.write_wtns(chain.witness(cfg, a), str(tmp_path / "w.wtns"))
    server = ProveServer(str(tmp_path / "k.zkey"), device="cpu")
    server.window_bits = 4
    resp = server.handle({"witness_file": str(tmp_path / "w.wtns"), "r": str(r), "s": str(s)})
    cr = ref.Reference(key, lambda x: chain.witness(cfg, x), "cpu")
    sc = cr.scalars(a)
    assert ref.proof_tuple(resp["proof"]) == cr.proof(sc["dots"], r, s)
    assert [int(v) for v in resp["public"]] == sc["public"]
    # the control's h (no coset shift) is another proof
    assert cr.proof(cr.scalars(a, coset=False)["dots"], r, s) != cr.proof(sc["dots"], r, s)


TINY = {"chain_2e20": {"k": 30, "domain_size": 32, "witness_pool": 2},
        "chain_1e4": {"k": 62, "domain_size": 64, "witness_pool": 2}}
CPU_TRAFFIC = {"profile_seconds": 0.0, "profile_min_requests": 1}
TEST_CIRCUITS = Path(__file__).resolve().parent / "circuits"
# Not in BENCHMARK.json: circomlib's Num2Bits(16), 16 public outputs, two-term
# B rows with r - 1 and one row that lives in C alone.
NUM2BITS = {"name": "num2bits_16", "generator": "num2bits", "bits": 16, "domain_size": 64,
            "window_bits": 4, "witness_pool": 2}
GENERATORS = [("chain", TINY["chain_2e20"]), ("chain", TINY["chain_1e4"]),
              ("num2bits", NUM2BITS)]


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """BENCHMARK.json with its configurations at a CPU size, and the
    program's MSM window at 4 bits, the cheapest for its plain CPU path;
    beside them the test-only Num2Bits(16) in cells `num2bits_16.wtns` and
    `num2bits_16.inputs`, its generator found beside the chain's."""
    from circom_compat_tpu_torch.models import groth16_device as gd

    monkeypatch.setattr(gd, "default_window_bits", lambda dpk: 4)
    circuits = tmp_path / "circuits"
    circuits.mkdir()
    for src in (harness.CIRCUITS / "chain.py", TEST_CIRCUITS / "num2bits.py"):
        (circuits / src.name).symlink_to(src)
    monkeypatch.setattr(harness, "CIRCUITS", circuits)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = dict(harness.load_json(harness.ROOT / c["file"]), **TINY[c["name"]])
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    path = tmp_path / "num2bits_16.json"
    path.write_text(json.dumps(NUM2BITS))
    bench["configs"].append({"name": "num2bits_16", "file": str(path), "reduced": []})
    for traffic in ("wtns", "inputs"):
        bench["workloads"].append({"name": f"num2bits_16.{traffic}", "config": "num2bits_16",
                                   "traffic": traffic, "chips": 1})
    return bench


def _tiny_generator(name):
    return harness._load(TEST_CIRCUITS / "num2bits.py" if name == "num2bits"
                         else harness.CIRCUITS / f"{name}.py", f"test_circuit_{name}")


def _rows_satisfied(matrices, z, num_constraints):
    """For each row, whether (A z)(B z) = C z, in Python integers."""
    ev = {}
    for m, (rows, cols, coeffs) in matrices.items():
        acc = [0] * num_constraints
        for i, j, v in zip(rows.tolist(), cols.tolist(), coeffs):
            acc[i] = (acc[i] + int(v) * z[j]) % R
        ev[m] = acc
    return [a * b % R == c for a, b, c in zip(ev["a"], ev["b"], ev["c"])]


@pytest.mark.parametrize("name, cfg", GENERATORS, ids=["chain_30", "chain_62", "num2bits_16"])
def test_generators_satisfy_their_r1cs(name, cfg):
    """A z o B z = C z row by row for a pool witness; the same witness
    with its last wire moved breaks a row."""
    gen = _tiny_generator(name)
    shp = gen.shape(cfg)
    x = gen.pool_input(cfg, harness.request_rng(2**31 + 23, "pool", 0))
    z = gen.witness(cfg, x)
    assert len(z) == shp["n_vars"] and z[0] == 1
    assert cfg["domain_size"] >= shp["num_constraints"] + shp["num_inputs"]
    mats = gen.matrices(cfg)
    assert all(_rows_satisfied(mats, z, shp["num_constraints"]))
    assert not all(_rows_satisfied(mats, z[:-1] + [(z[-1] + 1) % R], shp["num_constraints"]))


@pytest.mark.parametrize("workload", ["chain_2e20.wtns", "chain_2e20.inputs", "num2bits_16.wtns"])
def test_control_fails_the_comparison(tiny_bench, workload):
    for seed in (1, 2, 2**31 + 3):
        compared = control.run_control(workload, seed, "cpu", tiny_bench)
        assert not harness.is_correct(compared)
        assert compared["answers_wrong"]["value"] == compared["answers_checked"]["value"] > 0


def _alter_answer(monkeypatch):
    """A fault where the answer is produced: C moved by the generator."""
    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.refmath import curve as rc

    original = gd.assemble_proof

    def altered(*args, **kwargs):
        p = original(*args, **kwargs)
        return type(p)(a=p.a, b=p.b, c=rc.G1.add(p.c, rc.g1_generator()))

    monkeypatch.setattr(gd, "assemble_proof", altered)


def _drop_half_the_batch(monkeypatch):
    """A fault in the batch: half of its results never come."""
    from circom_compat_tpu_torch.models.batch import BatchProver

    original = BatchProver.prove_many

    def half(self, inputs_list, *args, **kwargs):
        out = original(self, inputs_list, *args, **kwargs)
        return out[: len(out) // 2] + [None] * (len(out) - len(out) // 2)

    monkeypatch.setattr(BatchProver, "prove_many", half)


@pytest.mark.parametrize("workload, fault, correct", [
    ("chain_2e20.wtns", None, True),
    ("chain_2e20.wtns", _alter_answer, False),
    ("chain_2e20.inputs", _alter_answer, False),
    ("chain_2e20.inputs", _drop_half_the_batch, False),
    ("num2bits_16.wtns", None, True),
    ("num2bits_16.wtns", _alter_answer, False),
])
def test_a_run_catches_the_faults(tiny_bench, monkeypatch, workload, fault, correct):
    """The whole run on the CPU (the look for a card skipped), with the
    timed path broken underneath; every answer's public signals compared
    (Num2Bits: its 16 outputs)."""
    if fault:
        fault(monkeypatch)
    checked = []
    check = harness.check

    def spy(key, witness, pool, answers, device):
        checked.extend(a for a in answers if a["error"] is None)
        return check(key, witness, pool, answers, device)

    monkeypatch.setattr(harness, "check", spy)
    res = harness.run(workload, 2**31 + 17, 0.5, False, "cpu", time.perf_counter(),
                      tiny_bench, traffic_overrides=CPU_TRAFFIC)
    assert res["correct"] is correct, res["compared"]
    assert list(res)[-1] == "compared"
    n_public = 16 if workload.startswith("num2bits") else 1
    assert all(len(a["public"]) == n_public for a in checked)
    assert checked or not correct


def test_inputs_without_a_witness_module_stop_before_setup(tiny_bench, monkeypatch):
    """Inputs traffic on a circuit with no witness module: no key is made."""
    def no_key(*args):
        raise AssertionError("set-up began")

    monkeypatch.setattr(inputs.PooledKey, "make", no_key)
    with pytest.raises(harness.CellError, match="num2bits"):
        harness.run("num2bits_16.inputs", 5, 0.5, False, "cpu", time.perf_counter(), tiny_bench)


class _TimedProver:
    """prove_many at a fixed time a proof, every result present."""

    def __init__(self, seconds_a_proof):
        self.seconds_a_proof, self.sizes = seconds_a_proof, []

    def prove_many(self, inputs_list, rs, inflight):
        self.sizes.append(len(inputs_list))
        time.sleep(self.seconds_a_proof * len(inputs_list))
        proof = type("P", (), {"a": None, "b": None, "c": None})()
        return [type("B", (), {"proof": proof, "public_inputs": [1]})() for _ in inputs_list]


@pytest.mark.parametrize("warm_rate", [25.0, 50.0, 200.0])
def test_inputs_window_has_no_batch_size(warm_rate):
    """The inputs driver fills a window with calls sized to the time left:
    a few calls whatever the warm-up's rate, and the window ends within a
    proof of its length."""
    drv = object.__new__(harness.BatchInputs)
    drv.cfg, drv.traffic, drv.seed = {"witness_pool": 4}, {"inflight": 2}, 5
    drv.signals = [{"a": x} for x in range(1, 5)]
    drv.bp, drv.n, drv.calls, drv.rate = _TimedProver(0.01), 0, 0, warm_rate
    answers = []
    elapsed = drv.window(0.6, answers)
    assert 1 <= len(drv.bp.sizes) <= 3, drv.bp.sizes
    assert sum(drv.bp.sizes) == len(answers) == drv.n
    assert 0.6 - 0.02 <= elapsed <= 0.6 + 0.05
    assert abs(drv.rate - 100) < 20


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "proofbench/run.py", "--workload", "chain_1e4.wtns",
                          "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
