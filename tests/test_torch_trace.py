"""circom_compat_tpu_torch per-stage observability (utils/trace.py) on the CPU.

  - the JAX package's tests/test_trace.py cases on the port's trace:
    nesting paths, a no-op without a collector, nested collectors, the
    CIRCOM_TPU_TIMINGS logging, device_profile writing a Chrome trace on
    the CPU and its disabled no-op;
  - the stage names at their counterparts: zkey.load, key.stage,
    witness.calculate, verify with ic_msm and pairing nested, and
    timed_stages deriving the stage_times keys from the trace's leaf names;
  - `--timings prove --backend streamed --device cpu` on
    tests/golden/chain254.zkey at the default chunk (one chunk): the proof
    verifies (through `--timings verify`), and stderr holds the stage table
    with zkey.load and prove.msm_stream.
Tolerance: exact (names, exit codes).
"""

import logging
import os
import pathlib
import time

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


def test_collect_records_stages_and_nesting():
    with trace.collect() as tr:
        with trace.stage("outer"):
            time.sleep(0.01)
            with trace.stage("inner"):
                time.sleep(0.01)
    d = tr.as_dict()
    assert set(d) == {"outer", "outer/inner"}
    assert d["outer"] >= d["outer/inner"] >= 0.01
    assert "inner" in tr.table()
    assert tr.total() == d["outer"]


def test_stage_is_noop_without_collector(monkeypatch):
    monkeypatch.delenv("CIRCOM_TPU_TIMINGS", raising=False)
    with trace.stage("nothing", torch.device("cpu")):
        pass
    assert trace._state().stack == []


def test_nested_collectors_both_record():
    with trace.collect() as outer:
        with trace.stage("a"):
            with trace.collect() as inner:
                with trace.stage("b"):
                    pass
    assert [n for n, _ in outer.stages] == ["a/b", "a"]
    assert [n for n, _ in inner.stages] == ["a/b"]


def test_env_logging(monkeypatch, caplog):
    monkeypatch.setenv("CIRCOM_TPU_TIMINGS", "1")
    with caplog.at_level(logging.INFO, logger="circom_compat_tpu_torch.trace"):
        with trace.stage("logged-stage"):
            pass
    assert any("logged-stage" in rec.getMessage() for rec in caplog.records)


def test_device_profile_writes_trace(tmp_path):
    with trace.device_profile(str(tmp_path)):
        torch.arange(8).sum()
    found = [f for _r, _d, files in os.walk(tmp_path) for f in files]
    assert found and all(f.endswith(".json") for f in found)


def test_device_profile_disabled_is_noop(tmp_path):
    with trace.device_profile(str(tmp_path), enabled=False):
        pass
    assert not any(files for _r, _d, files in os.walk(tmp_path))


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
            with trace.stage("prove.msm", "cpu"):
                with trace.stage("sorts", "cpu"):
                    pass
        with gd.timed_stages(None, {"sorts": "sorts"}):
            with trace.stage("sorts"):
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
    assert _labels(err) == ["zkey.load", "key.stage", "prove.encode", "prove.witness_map",
                            "prove.msm_stream", "prove.assemble"]
    assert main(["--timings", "verify", ZKEY, public, proof]) == 0
    captured = capsys.readouterr()
    assert captured.out == "OK!\n"
    assert _labels(captured.err) == ["zkey.load", "ic_msm", "pairing", "verify"]


def _labels(table: str):
    """The stage labels of a --timings table, each row's time in ms."""
    rows = table.splitlines()[1:]
    assert all(row.endswith(" ms") for row in rows)
    return [row.split()[0] for row in rows]
