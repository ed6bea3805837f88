"""circom_compat_tpu_torch's three witness engines against the JAX package's.

The port's WitnessCalculator takes `engine=` ("aot", the default; "native";
"interp"). On three modules, each through the port's three engines and the
JAX package's three (its AOT engine by default, its C++ VM with
CIRCOM_TPU_AOT=0, its interpreter with CIRCOM_TPU_AOT=0 and
CIRCOM_TPU_NATIVE=0, each asserted by the type of `jwc.instance`):
  - test_torch_witness.mul_module(), a circom-2 ABI generator for c = a * b;
  - test_torch_witness.legacy_mul_module(), the same on the circom-1 ABI
    (the AOT engine's call_range readback and memory-snapshot decode);
  - utils/chain_wasm.chain_wasm(30), the squaring chain's generator,
    which must also equal utils/chain.chain_witness(30, a) for seeded a;
the witnesses (calculate_witness) and limbs (calculate_witness_limbs)
are equal, and an unknown signal gives the same error on every engine.
Also: the chain's CIOS multiply at edge operands against Python ints; an
unknown engine raises ValueError; an engine whose compiler is missing
raises and names it; CIRCOM_TPU_AOT=0 leaves the port's engine as it is;
every library the port loads lies under its own caches, never native/ or
the JAX package's .cache/aot.
Tolerance: exact equality.
"""

import os
import pathlib
import random
import re

import numpy as np
import pytest

from circom_compat_tpu.witness import WitnessCalculator as JaxWitnessCalculator
from circom_compat_tpu.witness import WitnessCalcError as JaxWitnessCalcError
from circom_compat_tpu_torch import _host_build
from circom_compat_tpu_torch.constants import R_SCALAR
from circom_compat_tpu_torch.ops import limbs as lc
from circom_compat_tpu_torch.ops import native_field
from circom_compat_tpu_torch.utils.chain import chain_witness
from circom_compat_tpu_torch.utils.chain_wasm import chain_pages, chain_wasm, mont_mul_wasm
from circom_compat_tpu_torch.witness import WitnessCalculator, WitnessCalcError
from circom_compat_tpu_torch.witness.wasm import aot, native
from circom_compat_tpu_torch.witness.wasm.interp import Instance
from circom_compat_tpu_torch.witness.wasm.module import decode_module
from test_torch_witness import legacy_mul_module, mul_module

RNG = random.Random(0xE9)
ENGINES = ("aot", "native", "interp")
PORT_TYPES = {"aot": "AotInstance", "native": "NativeInstance", "interp": "Instance"}
JAX_SWITCHES = {  # engine -> (CIRCOM_TPU_AOT, CIRCOM_TPU_NATIVE, type of the instance)
    "aot": (None, None, "AotInstance"),
    "native": ("0", None, "NativeInstance"),
    "interp": ("0", "0", "Instance"),
}
MODULES = {"circom2": mul_module, "legacy": legacy_mul_module, "chain30": lambda: chain_wasm(30)}


def _inputs(name):
    if name == "chain30":
        return [{"a": a} for a in (3, RNG.randrange(R_SCALAR), R_SCALAR - 1, 0)]
    return [{"a": 3, "b": [11]}, {"a": RNG.randrange(1 << 31), "b": [RNG.randrange(1 << 32)]}]


def _jax_calculator(monkeypatch, data, engine):
    aot_env, native_env, kind = JAX_SWITCHES[engine]
    for var, value in (("CIRCOM_TPU_AOT", aot_env), ("CIRCOM_TPU_NATIVE", native_env)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    jwc = JaxWitnessCalculator(data)
    assert type(jwc.instance).__name__ == kind
    return jwc


@pytest.mark.parametrize("name", list(MODULES))
def test_engines_match_jax(monkeypatch, name):
    data = MODULES[name]()
    inputs = _inputs(name)
    want = None
    for engine in ENGINES:
        wc = WitnessCalculator(data, engine=engine)
        jwc = _jax_calculator(monkeypatch, data, engine)
        assert wc.engine == engine and type(wc.instance).__name__ == PORT_TYPES[engine]
        assert (wc.n32, wc.prime, wc.legacy) == (jwc.n32, jwc.prime, jwc.legacy)
        got = [(wc.calculate_witness(x), wc.calculate_witness_limbs(x)) for x in inputs]
        jgot = [(jwc.calculate_witness(x), jwc.calculate_witness_limbs(x)) for x in inputs]
        for (w, limbs), (jw, jlimbs) in zip(got, jgot):
            assert w == jw
            assert limbs.dtype == np.uint32 and np.array_equal(limbs, jlimbs)
            assert np.array_equal(limbs, lc.ints_to_limbs(w, dtype=np.uint32))
        if want is None:
            want = [w for w, _ in got]
        assert [w for w, _ in got] == want
    if name == "chain30":
        assert want == [chain_witness(30, x["a"] % R_SCALAR) for x in inputs]


@pytest.mark.parametrize("name", ["circom2", "chain30"])
def test_engine_errors_match_jax(monkeypatch, name):
    data = MODULES[name]()
    calcs = [(WitnessCalculator(data, engine=e), WitnessCalcError) for e in ENGINES]
    calcs += [(_jax_calculator(monkeypatch, data, e), JaxWitnessCalcError) for e in ENGINES]
    for calc, err in calcs:
        with pytest.raises(err, match="^Signal not found.$"):
            calc.calculate_witness({"bogus": 1})
    if name == "circom2":
        for calc, err in calcs:
            with pytest.raises(err, match="Not all inputs have been set. Only 1 out of 2"):
                calc.calculate_witness({"a": 1})
    else:  # a position past the chain's one input signal
        for calc, err in calcs:
            with pytest.raises(err, match="^Input signal array access exceeds the size.$"):
                calc.calculate_witness({"a": [1, 2]})


def test_legacy_errors_match_jax(monkeypatch):
    data = legacy_mul_module()
    calcs = [(WitnessCalculator(data, engine=e), WitnessCalcError) for e in ENGINES]
    calcs += [(_jax_calculator(monkeypatch, data, e), JaxWitnessCalcError) for e in ENGINES]
    for calc, err in calcs:
        with pytest.raises(err, match=r"runtime error, exiting early: \(1,\)"):
            calc.calculate_witness({"c": 1})


def test_chain_multiply_edge_operands():
    """The chain's CIOS multiply, through the interpreter, against Python
    ints: 0, 1, r - 1, values whose 32-bit limbs are all set below r, R^2,
    seeded values."""
    inst = Instance(decode_module(mont_mul_wasm()), {})
    mont = inst.exported("montMul")
    top = R_SCALAR >> 224
    edges = [0, 1, 2, R_SCALAR - 1, R_SCALAR - 2, (1 << 224) - 1, ((top - 1) << 224) | ((1 << 224) - 1),
             R_SCALAR - (1 << 32), (1 << 256) % R_SCALAR, (1 << 512) % R_SCALAR]
    edges += [RNG.randrange(R_SCALAR) for _ in range(4)]
    r_inv = pow(1 << 256, -1, R_SCALAR)
    for x in edges:
        for y in edges:
            inst.memory.write(0, x.to_bytes(32, "little"))
            inst.memory.write(32, y.to_bytes(32, "little"))
            mont(64, 0, 32)
            assert int.from_bytes(inst.memory.read(64, 32), "little") == x * y * r_inv % R_SCALAR


def test_chain_module_shape():
    assert chain_pages((1 << 20) - 2) == 513  # the wires fill 512 pages, the header one more
    wc = WitnessCalculator(chain_wasm(6), engine="interp")
    assert wc.instance.memory.pages == chain_pages(6) == 1
    assert wc.instance.exported("getWitnessSize")() == 8
    with pytest.raises(ValueError, match="k >= 1"):
        chain_wasm(0)


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="engine='wasmer'"):
        WitnessCalculator(mul_module(), engine="wasmer")


@pytest.mark.parametrize("engine,tool", [("aot", "gcc"), ("native", "g++")])
def test_missing_toolchain_raises(monkeypatch, tmp_path, engine, tool):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match=re.escape(f"engine='{engine}' builds with {tool}")):
        WitnessCalculator(mul_module(), engine=engine)
    with pytest.raises(RuntimeError, match=re.escape(f"{tool} not found on PATH")):
        _host_build.compiler(tool)


def test_environment_does_not_choose_the_engine(monkeypatch):
    monkeypatch.setenv("CIRCOM_TPU_AOT", "0")
    monkeypatch.setenv("CIRCOM_TPU_NATIVE", "0")
    wc = WitnessCalculator(mul_module())
    assert wc.engine == "aot" and isinstance(wc.instance, aot.AotInstance)
    assert isinstance(WitnessCalculator(mul_module(), engine="native").instance,
                      native.NativeInstance)


def test_loaded_libraries_lie_under_the_port_caches():
    repo = pathlib.Path(__file__).resolve().parents[1]
    wc = WitnessCalculator(chain_wasm(30))
    paths = {"aot": pathlib.Path(wc.instance._lib._name).resolve()}
    WitnessCalculator(mul_module(), engine="native")
    paths["native"] = pathlib.Path(native._load_lib()._name).resolve()
    native_field.mont_strip(lc.ints_to_limbs([5], dtype=np.uint16), R_SCALAR)
    paths["field_ops"] = pathlib.Path(native_field._load_lib()._name).resolve()
    assert paths["aot"].parent == aot.cache_dir().resolve()
    assert paths["aot"].parent.name == "aot_torch"
    for name in ("native", "field_ops"):
        assert paths[name].parent == _host_build.build_dir().resolve()
        assert _host_build.CACHE.resolve() in paths[name].parents
    for path in paths.values():
        assert (repo / "native") not in path.parents
        assert (repo / ".cache" / "aot") not in path.parents
        assert os.path.isfile(path)
