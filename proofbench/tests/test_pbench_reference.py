"""The plain reference against Python integers and against the program on
the CPU; the control and the faults that the comparison must catch."""

import json
import random
import time

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
    key = inputs.PooledKey.make(30, 32, rng)
    key.write_zkey(str(tmp_path / "k.zkey"))
    a, r, s = (rng.randrange(1, R) for _ in range(3))
    inputs.chain_wtns(30, a, str(tmp_path / "w.wtns"))
    server = ProveServer(str(tmp_path / "k.zkey"), device="cpu")
    server.window_bits = 4
    resp = server.handle({"witness_file": str(tmp_path / "w.wtns"), "r": str(r), "s": str(s)})
    cr = ref.ChainReference(key, "cpu")
    sc = cr.scalars(a)
    assert ref.proof_tuple(resp["proof"]) == cr.proof(sc["dots"], r, s)
    assert [int(v) for v in resp["public"]] == sc["public"]
    # the control's h (no coset shift) is another proof
    assert cr.proof(cr.scalars(a, coset=False)["dots"], r, s) != cr.proof(sc["dots"], r, s)


TINY = {"chain_2e20": {"k": 30, "domain_size": 32, "witness_pool": 2},
        "chain_1e4": {"k": 62, "domain_size": 64, "witness_pool": 2}}
CPU_TRAFFIC = {"profile_seconds": 0.0, "profile_min_requests": 1}


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """BENCHMARK.json with its configurations at a CPU size, and the
    program's MSM window at 4 bits, the cheapest for its plain CPU path."""
    from circom_compat_tpu_torch.models import groth16_device as gd

    monkeypatch.setattr(gd, "default_window_bits", lambda dpk: 4)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = dict(harness.load_json(harness.ROOT / c["file"]), **TINY[c["name"]])
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    return bench


@pytest.mark.parametrize("workload", ["chain_2e20.wtns", "chain_2e20.inputs"])
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
])
def test_a_run_catches_the_faults(tiny_bench, monkeypatch, workload, fault, correct):
    """The whole run on the CPU (the look for a card skipped), with the
    timed path broken underneath."""
    if fault:
        fault(monkeypatch)
    res = harness.run(workload, 2**31 + 17, 0.5, False, "cpu", time.perf_counter(),
                      tiny_bench, traffic_overrides=CPU_TRAFFIC)
    assert res["correct"] is correct, res["compared"]
    assert list(res)[-1] == "compared"


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
