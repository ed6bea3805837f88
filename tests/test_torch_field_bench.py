"""circom_compat_tpu_torch's K9 op chain (ops/field_bench.py) against the
Pallas microbenchmark it ports, scripts/bench_field_ops.py's run_op, run in
interpret mode at one block of 512 lanes and its default K = 64 steps.

Every op's plain chain (what fq_op_chain runs for CPU tensors) must give
the kernel's words for seeded canonical Fq operands. Tolerance: exact
equality of the 256-bit results (the ops are integer arithmetic, and the
lazy ones agree word for word, not only mod q).
"""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_compat_tpu_torch.constants import Q
from circom_compat_tpu_torch.ops import field_bench as fbn
from circom_compat_tpu_torch.ops import limbs as tl

torch.set_num_threads(1)
SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "bench_field_ops.py"


@pytest.fixture(scope="module")
def run_op():
    """The script's run_op. Importing the script sets a compile-cache
    directory and a path entry of its own; both are put back."""
    saved_path = list(sys.path)
    saved_cache = jax.config.jax_compilation_cache_dir
    saved_min = jax.config.jax_persistent_cache_min_compile_time_secs
    spec = importlib.util.spec_from_file_location("bench_field_ops", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved_path
        jax.config.update("jax_compilation_cache_dir", saved_cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved_min)
    assert (mod.LANES, mod.K) == (512, 64)
    return mod.run_op


@pytest.mark.parametrize("op", fbn.OPS)
def test_plain_chain_matches_run_op(run_op, op):
    a, b = fbn.operands(512, seed=9, device="cpu")
    want = run_op(op, *(jnp.asarray(np.ascontiguousarray(x.numpy()).view("<u2").astype(np.uint32).T)
                        for x in (a, b)))
    got = fbn.fq_op_chain(op, a, b, 64)
    assert torch.equal(got, torch.from_numpy(np.asarray(want).T.astype("<u2").copy().view("<i4")))
    vals = tl.words_to_ints(got.numpy())
    bound = Q if op in ("mont_mul", "add") else 2 * Q
    assert all(v < bound for v in vals)


def test_op_chain_checks_its_operands():
    a, b = fbn.operands(4, device="cpu")
    with pytest.raises(ValueError, match="unknown op"):
        fbn.fq_op_chain("normalize", a, b, 3)
    with pytest.raises(ValueError):
        fbn.fq_op_chain("add", a, b[:2], 3)
    assert torch.equal(fbn.fq_op_chain("mul9", a, b, 0), a)
    with pytest.raises(ValueError, match="CUDA"):
        fbn.run(4, 2, device="cpu")


def test_operands_default_to_the_card(monkeypatch):
    """Without a CUDA device the default raises and names device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fbn.operands(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fbn.run(4, 2)
    assert fbn.operands(4, device="cpu")[0].device == torch.device("cpu")
