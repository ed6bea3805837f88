"""BENCHMARK.json against the benchmark's contract, the layout found by
name, the isolation of the harness from JAX and the JAX package, and the
run's refusals."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_resolve_by_name(workload):
    import harness

    wl, cfg, traffic, e2e, per_layer = harness.cell(BENCH, workload["name"])
    assert cfg["name"] == wl["config"]
    assert traffic["driver"] in harness.DRIVERS
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per_layer
    moved = {m["name"] for m in e2e}
    for m in per_layer:
        assert m["moves"] in moved
        assert callable(harness.load_metric(m["name"]).read)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    import harness

    path = ROOT / config["file"]
    assert path.is_relative_to(BENCH_DIR)
    cfg = json.loads(path.read_text())
    assert cfg["reduced"] == config["reduced"] == []
    gen = harness.load_generator(cfg["generator"])
    shape = gen.shape(cfg)
    # snarkjs: the domain holds the constraints, the constant's row and one row a public signal
    assert cfg["domain_size"] >= shape["num_constraints"] + shape["num_inputs"]
    assert shape["n_vars"] >= shape["num_inputs"] >= 1


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_inputs_cells_have_a_witness_module(workload):
    """A cell whose traffic sends inputs runs a circuit with a witness module."""
    import harness

    _, cfg, traffic, _, _ = harness.cell(BENCH, workload["name"])
    if harness.DRIVERS[traffic["driver"]].needs_wasm:
        assert harness.load_generator(cfg["generator"]).wasm(cfg)[:4] == b"\0asm"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_or_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "circom_compat_tpu"}, tops


YARDSTICK = ["reference.py", "inputs.py", "chain_wasm.py"] + sorted(
    str(p.relative_to(BENCH_DIR)) for p in (BENCH_DIR / "circuits").glob("*.py"))


@pytest.mark.parametrize("name", YARDSTICK)
def test_reference_imports_nothing_of_the_program(name):
    tops = {m.split(".")[0] for m in _imports(BENCH_DIR / name)}
    assert "circom_compat_tpu_torch" not in tops
    code = (f"import sys, importlib.util; sys.path.insert(0, {str(BENCH_DIR)!r}); "
            f"spec = importlib.util.spec_from_file_location('m', {str(BENCH_DIR / name)!r}); "
            "sys.modules['m'] = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(sys.modules['m']); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'circom_compat_tpu_torch', 'circom_compat_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd="/")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run(cwd, workload="chain_1e4.wtns"):
    return subprocess.run([sys.executable, "proofbench/run.py", "--workload", workload,
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0 and _no_result(out), out.stdout[-500:]


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "proofbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and _no_result(out), out.stdout[-500:]


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "circom_compat_tpu_torch_x", sys)
    assert "circom_compat_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "circom_compat_tpu.ops", sys)
    assert "circom_compat_tpu" in run.forbidden_modules()
