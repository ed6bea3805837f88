"""circom_compat_tpu_torch's K9 op chain (ops/field_bench.py) against the
Pallas microbenchmark it ports, scripts/bench_field_ops.py's run_op, run in
interpret mode at one block of 512 lanes and its default K = 64 steps.

Every op's plain chain (what fq_op_chain runs for CPU tensors) must give
the kernel's words for seeded canonical Fq operands, and for the op's edge
operands (0, 1, q - 1, values whose low seven words are all ones, 2q - 1
for the lazy ops, paired with b = 1, q - 1 and 2q - 1) padded to the
script's 512 lanes with seeded values. Tolerance: exact equality of the
256-bit results (the ops are integer arithmetic, and the lazy ones agree
word for word, not only mod q).
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


def _run_op_words(run_op, op, a, b):
    """run_op on (n, 8) words, as (n, 8) words: the script takes (16, n)
    16-bit limbs in uint32 lanes."""
    want = run_op(op, *(jnp.asarray(np.ascontiguousarray(x.numpy()).view("<u2").astype(np.uint32).T)
                        for x in (a, b)))
    return torch.from_numpy(np.asarray(want).T.astype("<u2").copy().view("<i4"))


@pytest.mark.parametrize("op", fbn.OPS)
def test_plain_chain_matches_run_op(run_op, op):
    a, b = fbn.operands(512, seed=9, device="cpu")
    got = fbn.fq_op_chain(op, a, b, 64)
    assert torch.equal(got, _run_op_words(run_op, op, a, b))
    vals = tl.words_to_ints(got.numpy())
    bound = Q if op in ("mont_mul", "add") else 2 * Q
    assert all(v < bound for v in vals)


@pytest.mark.parametrize("op", fbn.OPS)
def test_edge_chain_matches_run_op(run_op, op):
    """The edge operands lead 512 lanes of seeded values."""
    a, b = fbn.edge_operands(op, 512, seed=9, device="cpu")
    got = fbn.fq_op_chain(op, a, b, 64)
    assert torch.equal(got, _run_op_words(run_op, op, a, b))
    bound = 2 * Q if op in fbn.LAZY_OPS else Q
    assert all(v < bound for v in tl.words_to_ints(got.numpy()))


def test_edge_operands_hold_every_pairing():
    for op in fbn.OPS:
        av, bv = fbn.edge_values(op)
        lazy = op in fbn.LAZY_OPS
        assert (2 * Q - 1 in av) == lazy and (2 * Q - 1 in bv) == lazy
        assert {1, Q - 1} <= set(bv) and {0, 1, Q - 1} <= set(av)
        ones = [v for v in av if v & ((1 << 224) - 1) == (1 << 224) - 1 and v < Q]
        assert len(ones) == 2
        a, b = fbn.edge_operands(op, 100, device="cpu")
        pairs = list(zip(tl.words_to_ints(a.numpy()), tl.words_to_ints(b.numpy())))
        assert pairs[: len(av) * len(bv)] == [(x, y) for x in av for y in bv]
        assert all(x < Q and y < Q for x, y in pairs[len(av) * len(bv):])


@pytest.mark.parametrize("op", fbn.OPS)
def test_plain_chain_at_runtime_steps_is_the_field_op(op):
    """At step counts other than the script's 64 (the kernel's runtime loop
    on the card), the plain chain on the edge operands is the op's field
    arithmetic: equal to it mod q, canonical for mont_mul and add, below
    2q for the lazy ops. Montgomery products are a * b / 2^256 mod q."""
    a, b = fbn.edge_operands(op, 40, seed=5, device="cpu")
    r_inv = pow(1 << 256, -1, Q)
    step = {"mont_mul": lambda x, y: x * y * r_inv, "mont_mul_lazy": lambda x, y: x * y * r_inv,
            "add": lambda x, y: x + y, "add_lazy": lambda x, y: x + y, "sub_lazy": lambda x, y: x - y,
            "mul9": lambda x, y: 8 * x + y}[op]
    for k in (1, 5, 9):
        got = tl.words_to_ints(fbn.fq_op_chain(op, a, b, k).numpy())
        for x, y, g in zip(tl.words_to_ints(a.numpy()), tl.words_to_ints(b.numpy()), got):
            want = x
            for _ in range(k):
                want = step(want, y) % Q
            assert g % Q == want and g < (2 * Q if op in fbn.LAZY_OPS else Q)


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
