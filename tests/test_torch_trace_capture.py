"""The port's spans under the benchmark's capture, on the CPU.

  - one prove on tests/golden/chain254.zkey through
    ProveServer.handle({witness_file}) under a CPU torch.profiler inside
    proofbench/devtrace.py `stage_ranges` (the benchmark's own wrapper of
    the `stage` alias): each stage of proofbench/harness.py STAGES the
    prove enters opens exactly one profiler range; the server.* spans and
    the prove's stages share one request id and nest under server.handle;
    the stages keep the paths the benchmark reads ("prove.assemble"); the
    two .wtns readers (wtns_read_s, server_host_s) return numbers; the
    span witness_map.sparse nests in prove.witness_map; ops/msm.py's row
    counters gain, in one G1 call and one G2 call, the rows of nonzero
    window digit of the assignment (A, B1, L; B2) and of h (H), and skip the
    rest of W (2 n_vars + aux + domain) and W n_vars; and the proof, at the
    golden fixed (r, s), is
    tests/golden/chain254_proof.json byte for byte (test_torch_groth16
    proves the same bytes with no collector);
  - BatchProver.prove_many of two inputs on the c = a * b circuit of
    test_torch_witness.mul_module (a dev-mode key, window_bits=4):
    witness.calculate runs on a worker thread and batch.witness_wait on the
    caller's, under the same request id, one id an input; the two .inputs
    readers (witness_wait_s, encode_s) return numbers.
Tolerance: exact (names, ids, counts).
"""

import collections
import json
import pathlib
import random
import sys
import threading

import pytest
import torch

from circom_compat_tpu_torch.circom.circuit import CircomCircuit
from circom_compat_tpu_torch.circom.r1cs import read_r1cs
from circom_compat_tpu_torch.circom.wtns import write_wtns
from circom_compat_tpu_torch.circom.zkey import read_zkey
from circom_compat_tpu_torch.circom.zkey_writer import write_zkey
from circom_compat_tpu_torch.models import generate_random_parameters
from circom_compat_tpu_torch.models import groth16_device as gd
from circom_compat_tpu_torch.models.batch import BatchProver
from circom_compat_tpu_torch.ops import field_kernels as fk
from circom_compat_tpu_torch.server import ProveServer
from circom_compat_tpu_torch.utils import trace
from circom_compat_tpu_torch.utils.chain import chain_circuit
from test_torch_circom import mul_r1cs
from test_torch_witness import mul_module

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "proofbench"))
import devtrace  # noqa: E402
import harness  # noqa: E402
import reference  # noqa: E402

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
ZKEY = str(ROOT / "tests" / "golden" / "chain254.zkey")
SERVER = ("server.handle", "server.read_wtns", "server.public", "server.prove",
          "server.respond")


@pytest.fixture
def ring(monkeypatch):
    """A fresh recent-span ring, with the logging knob unset; torch.profiler
    records user ranges (record_function) alone: a CPU prove runs ~10^7
    small tensor ops, which a full capture takes minutes to record."""
    monkeypatch.delenv("CIRCOM_TPU_TIMINGS", raising=False)
    fresh = collections.deque(maxlen=trace.RING_SIZE)
    monkeypatch.setattr(trace, "_ring", fresh)
    enable = torch.autograd.profiler._enable_profiler
    user = {torch._C._profiler.RecordScope.USER_SCOPE}
    monkeypatch.setattr(torch.autograd.profiler, "_enable_profiler",
                        lambda config, activities, scopes=None: enable(config, activities, user))
    return fresh


def test_server_prove_under_stage_ranges(ring, tmp_path):
    from circom_compat_tpu_torch.ops import msm

    golden = json.loads((ROOT / "tests" / "golden" / "chain254_proof.json").read_text())
    wtns = tmp_path / "w.wtns"
    write_wtns(chain_circuit(k=254, a=3).full_assignment(), wtns)
    srv = ProveServer(ZKEY, device="cpu")
    srv.window_bits = 4  # the proof does not depend on it; the CPU's cheapest
    msm.reset_counters()
    with devtrace.stage_ranges(trace):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function(devtrace.REQUEST):
                with trace.collect() as tr:
                    resp = srv.handle({"witness_file": str(wtns), "r": str(golden["r"]),
                                       "s": str(golden["s"])})
    assert resp["ok"], resp
    p = golden["proof"]
    assert reference.proof_tuple(resp["proof"]) == (
        tuple(int(v, 16) for v in p["a"]), tuple(tuple(int(v, 16) for v in c) for c in p["b"]),
        tuple(int(v, 16) for v in p["c"]))
    dpk, W = srv.dpk, msm.num_windows(4)
    z = torch.from_numpy(gd.encode_assignment(chain_circuit(k=254, a=3).full_assignment()))
    h = fk.fr_from_mont(dpk.matrices.witness_map(fk.fr_to_mont(z)))[: len(dpk.queries["h"])]

    def nonzero(words):  # the rows of nonzero digit, which bucket_sums gathers
        return int((msm.window_digits(words, 4) != 0).sum())

    za = nonzero(z)
    assert msm.BUCKET_ROWS == {
        "g1": 2 * za + nonzero(z[dpk.num_inputs : dpk.num_inputs + dpk.aux_len]) + nonzero(h),
        "g2": za}
    assert {g: msm.BUCKET_ROWS[g] + msm.BUCKET_SKIPPED[g] for g in ("g1", "g2")} == {
        "g1": W * (2 * dpk.n_vars + dpk.aux_len + dpk.domain_size), "g2": W * dpk.n_vars}
    assert msm.BUCKET_CALLS == {"g1": 1, "g2": 1}

    # the events devtrace.read_capture reads (prof.events() folds a range
    # nested in one of the same name into one)
    ranges = collections.Counter(e.name() for e in prof.profiler.kineto_results.events())
    entered = {sp.name for sp in tr.spans}
    stages = entered & set(harness.STAGES)
    assert stages == set(harness.STAGES) - {"witness.calculate"}
    assert {name: ranges[name] for name in stages} == {name: 1 for name in stages}

    assert entered >= set(SERVER)
    assert all(sp.profiled for sp in tr.spans) and list(ring) == tr.spans
    handle = next(sp for sp in tr.spans if sp.name == "server.handle")
    assert {sp.request_id for sp in tr.spans} == {handle.request_id}
    by_id = {sp.span_id: sp for sp in tr.spans}
    for sp in tr.spans:
        if sp.name in SERVER[1:]:
            assert sp.parent_id == handle.span_id
        elif sp is not handle:  # a prove stage: its chain of parents ends at server.prove
            top = sp
            while by_id[top.parent_id].name not in SERVER:
                top = by_id[top.parent_id]
            assert by_id[top.parent_id].name == "server.prove"
    paths = dict(tr.stages)
    assert {"prove.assemble", "prove.msm", "prove.witness_map", "server.read_wtns"} <= set(paths)
    sparse = next(sp for sp in tr.spans if sp.name == "witness_map.sparse")
    assert [sp.path for sp in tr.spans].count(sparse.path) == 1
    assert sparse.path == "prove.witness_map/witness_map.sparse"
    assert by_id[sparse.parent_id].name == "prove.witness_map"

    read_s = harness.load_metric("wtns_read_s.wtns").read({})
    host_s = harness.load_metric("server_host_s.wtns").read({})
    prove = next(sp for sp in tr.spans if sp.name == "server.prove")
    assert 0 < read_s < host_s < handle.seconds
    assert host_s == pytest.approx(handle.seconds - prove.seconds)


def test_prove_many_spans_share_request_ids(ring, tmp_path):
    circuit = CircomCircuit(r1cs=read_r1cs(mul_r1cs()))
    pk = generate_random_parameters(circuit, rng=random.Random(3), device="cpu")
    ma, mb, _ = circuit.to_matrices()
    write_zkey(str(tmp_path / "mul.zkey"), pk, ma, mb, len(ma))
    pk, matrices = read_zkey(str(tmp_path / "mul.zkey"))
    dpk = gd.DeviceProvingKey.build(pk, matrices, matrices.num_constraints, device="cpu")
    bp = BatchProver(dpk, mul_module(), workers=2, window_bits=4)
    assert harness.load_metric("witness_wait_s.inputs").read({}) is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.collect() as tr:
            results = bp.prove_many([{"a": 3, "b": 11}, {"a": 5, "b": 7}],
                                    rs=[(5, 6), (7, 8)])
    assert [r.public_inputs for r in results] == [[33], [35]]

    caller = threading.get_native_id()
    calc = [sp for sp in tr.spans if sp.name == "witness.calculate"]
    wait = [sp for sp in tr.spans if sp.name == "batch.witness_wait"]
    assert len(calc) == len(wait) == 2
    assert all(sp.thread_id != caller for sp in calc)
    assert all(sp.thread_id == caller and sp.profiled for sp in wait)
    rids = {sp.request_id for sp in wait}
    assert len(rids) == 2 and {sp.request_id for sp in calc} == rids
    for rid in rids:
        names = {sp.name for sp in tr.spans if sp.request_id == rid}
        assert names == {"witness.calculate", "batch.witness_wait", "prove.encode",
                         "prove.witness_map", "witness_map.sparse", "prove.msm", "sorts",
                         "msm_g1", "msm_g2", "prove.assemble", "readback", "fold"}

    wait_s = harness.load_metric("witness_wait_s.inputs").read({})
    encode_s = harness.load_metric("encode_s.inputs").read({})
    assert wait_s == pytest.approx(sum(sp.seconds for sp in wait) / 2)
    encodes = [sp.seconds for sp in tr.spans if sp.name == "prove.encode"]
    assert len(encodes) == 2 and encode_s == pytest.approx(sum(encodes) / 2)
