"""circom_compat_tpu_torch spans (utils/trace.py) on the CPU.

  - the JAX package's tests/test_trace.py cases on the port's trace:
    nesting paths, a no-op without a collector, nested collectors, the
    CIRCOM_TPU_TIMINGS logging (its message format, which the benchmark's
    log tap parses);
  - a collector on the main thread receives a worker thread's spans, with
    the request id the worker was handed and parent ids that nest; a root
    span starts its children's paths afresh; request ids are fresh and
    restored on exit;
  - with nothing listening a span appends nothing to the ring, opens no
    profiler range and synchronizes nothing; under the profiler alone it
    opens one range, is flagged `profiled` and synchronizes nothing;
  - no module of the package calls the `stage` alias;
  - the stage names at their counterparts: zkey.load, key.stage,
    witness.calculate, verify with ic_msm and pairing nested, and
    timed_stages deriving the stage_times keys from the trace's leaf names;
  - `--timings prove --backend streamed --device cpu` on
    tests/golden/chain254.zkey at the default chunk (one chunk): the proof
    verifies (through `--timings verify`), and stderr holds the stage table
    with zkey.load and prove.msm_stream.
Tolerance: exact (names, exit codes).
"""

import collections
import logging
import pathlib
import threading
import time

import pytest

import torch

from circom_compat_tpu_torch.circom.wtns import write_wtns
from circom_compat_tpu_torch.circom.zkey import read_zkey
from circom_compat_tpu_torch.cli import main
from circom_compat_tpu_torch.models import groth16_device as gd
from circom_compat_tpu_torch.utils import trace
from circom_compat_tpu_torch.utils.chain import chain_circuit
from circom_compat_tpu_torch.witness import WitnessCalculator
from test_torch_witness import mul_module

# The plain versions run many small tensor ops: one thread per test process
# keeps parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)
ZKEY = str(pathlib.Path(__file__).resolve().parent / "golden" / "chain254.zkey")


PACKAGE = pathlib.Path(trace.__file__).resolve().parent.parent


@pytest.fixture
def ring(monkeypatch):
    """A fresh recent-span ring, with the logging knob unset."""
    monkeypatch.delenv("CIRCOM_TPU_TIMINGS", raising=False)
    fresh = collections.deque(maxlen=trace.RING_SIZE)
    monkeypatch.setattr(trace, "_ring", fresh)
    return fresh


def test_collect_records_stages_and_nesting():
    with trace.collect() as tr:
        with trace.span("outer"):
            time.sleep(0.01)
            with trace.span("inner"):
                time.sleep(0.01)
    d = tr.as_dict()
    assert set(d) == {"outer", "outer/inner"}
    assert d["outer"] >= d["outer/inner"] >= 0.01
    assert "inner" in tr.table()
    inner, outer = tr.spans
    assert (inner.path, outer.path) == ("outer/inner", "outer")
    assert inner.parent_id == outer.span_id and outer.parent_id is None
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns


def test_stage_is_noop_without_collector(monkeypatch):
    monkeypatch.delenv("CIRCOM_TPU_TIMINGS", raising=False)
    with trace.span("nothing", torch.device("cpu")):
        assert trace._stack() == []
    assert trace._stack() == []


def test_nested_collectors_both_record():
    with trace.collect() as outer:
        with trace.span("a"):
            with trace.collect() as inner:
                with trace.span("b"):
                    pass
    assert [n for n, _ in outer.stages] == ["a/b", "a"]
    assert [n for n, _ in inner.stages] == ["a/b"]


def test_env_logging(monkeypatch, caplog):
    monkeypatch.setenv("CIRCOM_TPU_TIMINGS", "1")
    with caplog.at_level(logging.INFO, logger="circom_compat_tpu_torch.trace"):
        with trace.span("logged-stage"):
            pass
    rec = next(r for r in caplog.records if "logged-stage" in r.getMessage())
    assert rec.msg == "%s: %.1f ms" and rec.args[0] == "logged-stage"
    assert isinstance(rec.args[1], float)


def test_collector_receives_worker_spans_with_its_request(ring):
    got = {}

    def worker(rid):
        with trace.request(rid):
            with trace.span("work"):
                with trace.span("step"):
                    pass
        got["thread"] = threading.get_native_id()

    with trace.collect() as tr:
        with trace.request() as rid:
            with trace.span("caller"):
                t = threading.Thread(target=worker, args=(rid,))
                t.start()
                t.join(timeout=30)
    assert not t.is_alive()
    by_name = {sp.name: sp for sp in tr.spans}
    assert set(by_name) == {"work", "step", "caller"}
    assert {sp.request_id for sp in tr.spans} == {rid}
    work, step, caller = by_name["work"], by_name["step"], by_name["caller"]
    assert work.thread_id == step.thread_id == got["thread"] != caller.thread_id
    # parents are the enclosing span on the same thread
    assert step.parent_id == work.span_id and work.parent_id is None
    assert caller.parent_id is None
    assert [sp.path for sp in tr.spans] == ["work/step", "work", "caller"]
    assert list(ring) == tr.spans and not any(sp.profiled for sp in ring)


def test_root_span_starts_paths_afresh(ring):
    with trace.collect() as tr:
        with trace.span("boundary", root=True):
            with trace.span("prove.msm"):
                with trace.span("sorts"):
                    pass
    assert [n for n, _ in tr.stages] == ["prove.msm/sorts", "prove.msm", "boundary"]
    sorts, msm, boundary = tr.spans
    assert sorts.parent_id == msm.span_id and msm.parent_id == boundary.span_id


def test_request_ids_fresh_and_restored():
    with trace.request() as a:
        with trace.request() as b:
            with trace.request(a) as c:
                assert c == a
            assert trace._tls.rid == b
        assert trace._tls.rid == a
    assert b != a and trace.new_request_id() > b
    assert getattr(trace._tls, "rid", None) is None


def test_nothing_listening_records_ranges_and_syncs_nothing(ring, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a span with nothing listening reached the card or profiler")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with trace.span("quiet", torch.device("cuda:0")):
        with trace.span("inner", "cuda"):
            pass
    assert len(ring) == 0 and trace._stack() == []


def test_profiler_alone_ranges_and_syncs_nothing(ring, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a span synchronized under the profiler alone")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.request() as rid:
            with trace.span("ranged.outer", torch.device("cuda:0")):
                with trace.span("ranged.inner", "cuda"):
                    torch.arange(8).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("ranged.outer") == names.count("ranged.inner") == 1
    inner, outer = ring
    assert inner.profiled and outer.profiled
    assert inner.parent_id == outer.span_id and {inner.request_id, outer.request_id} == {rid}


def test_ring_keeps_the_last_spans(monkeypatch):
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=3))
    with trace.collect():
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
    assert [sp.name for sp in trace.recent()] == ["s2", "s3", "s4"]


def test_no_module_calls_the_stage_alias():
    callers = [str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py")
               if "trace.stage(" in p.read_text()]
    assert callers == []


def test_stage_names_at_their_counterparts():
    with trace.collect() as tr:
        pk, m = read_zkey(ZKEY)
        gd.DeviceProvingKey.build(pk, m, m.num_constraints, device="cpu")
        assert WitnessCalculator(mul_module()).calculate_witness({"a": 3, "b": 11}) == \
            [1, 33, 3, 11]
    assert [n for n, _ in tr.stages] == ["zkey.load", "key.stage", "witness.calculate"]

    times = {}
    with trace.collect() as tr:
        with gd.timed_stages(times, {"sorts": "sorts"}):
            with trace.span("prove.msm", "cpu"):
                with trace.span("sorts", "cpu"):
                    pass
        with gd.timed_stages(None, {"sorts": "sorts"}):
            with trace.span("sorts"):
                pass
    assert [n for n, _ in tr.stages] == ["prove.msm/sorts", "prove.msm", "sorts"]
    assert list(times) == ["sorts"]


def test_cli_timings_streamed_prove(tmp_path, capsys):
    w, proof, public = (str(tmp_path / f) for f in ("w.wtns", "proof.json", "public.json"))
    write_wtns(chain_circuit(k=254, a=3).full_assignment(), w)
    assert main(["--timings", "prove", ZKEY, w, proof, public, "--device", "cpu",
                 "--backend", "streamed"]) == 0
    err = capsys.readouterr().err
    assert "--- stage timings ---" in err
    assert _labels(err) == ["zkey.load", "key.stage", "prove.encode", "witness_map.sparse",
                            "prove.witness_map", "prove.msm_stream", "prove.assemble"]
    assert main(["--timings", "verify", ZKEY, public, proof]) == 0
    captured = capsys.readouterr()
    assert captured.out == "OK!\n"
    assert _labels(captured.err) == ["zkey.load", "ic_msm", "pairing", "verify"]


def _labels(table: str):
    """The stage labels of a --timings table, each row's time in ms."""
    rows = table.splitlines()[1:]
    assert all(row.endswith(" ms") for row in rows)
    return [row.split()[0] for row in rows]
