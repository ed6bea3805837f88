"""Per-op microbenchmark of the Fq arithmetic in csrc/field.cuh (K9).

fq_op_chain(op, a, b, k) runs acc = op(acc, b) k times per element, acc
starting at a, in one kernel launch (csrc/field_kernels.cu), so a chain's
time over n * k is the cost of one op with no memory traffic in the way.
It ports scripts/bench_field_ops.py's run_op, which times the same chain of
one limb-major op per Pallas call. Ops:

  mont_mul       Montgomery product, canonical
  mont_mul_lazy  Montgomery product, lazy [0, 2p)
  add            a + b mod p (canonical inputs)
  add_lazy       a + b mod 2p
  sub_lazy       a - b mod 2p
  mul9           8 acc + b: three lazy doublings and one lazy add

The script's "normalize" is a carry pass of 16-bit limbs held in 32-bit
lanes; 32-bit words carry inside the multiply-add chain, so it has no
counterpart here.

Run on the card from the repository's root:
    python -m circom_compat_tpu_torch.ops.field_bench
It prints the card's name and power limit, then G ops/s for each op.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Sequence

import numpy as np
import torch

from .. import _build
from ..constants import Q
from ..device import resolve_device
from . import field as fl
from . import limbs as limb_codec

OPS = ("mont_mul", "mont_mul_lazy", "add", "add_lazy", "sub_lazy", "mul9")
LAUNCHES = {"fq_op_chain": 0}

# 32-bit integer operations of one op on 8-word elements (the bound's
# count): a Montgomery multiply is 264 multiply-adds (csrc/field.cuh), a
# conditional subtraction 8 word subtracts, an add 8 word adds plus its
# conditional subtraction, a subtraction 8 adds (+ 2p), 8 subtracts and
# its conditional subtraction; mul9 is four lazy adds.
INT_OPS = {"mont_mul": 272, "mont_mul_lazy": 264, "add": 16, "add_lazy": 16,
           "sub_lazy": 24, "mul9": 64}


def reset_launches() -> None:
    LAUNCHES["fq_op_chain"] = 0


def _step(op: str, acc: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    F = fl.FQ
    if op == "mont_mul":
        return fl.mont_mul(F, acc, y)
    if op == "mont_mul_lazy":
        return fl.mont_mul_lazy(F, acc, y)
    if op == "add":
        return fl.add(F, acc, y)
    if op == "add_lazy":
        return fl.add_lazy(F, acc, y)
    if op == "sub_lazy":
        return fl.sub_lazy(F, acc, y)
    x2 = fl.add_lazy(F, acc, acc)
    x4 = fl.add_lazy(F, x2, x2)
    return fl.add_lazy(F, fl.add_lazy(F, x4, x4), y)


def fq_op_chain_plain(op: str, a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    acc, y = fl.words_to_limbs(a), fl.words_to_limbs(b)
    for _ in range(k):
        acc = _step(op, acc, y)
    return fl.limbs_to_words(acc)


def fq_op_chain(op: str, a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """a, b (n, 8) Fq words (canonical for mont_mul and add, below 2q for
    the lazy ops) -> the (n, 8) result of k dependent steps."""
    if op not in OPS:
        raise ValueError(f"unknown op {op}; one of {OPS}")
    for t in (a, b):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 8 or not t.is_contiguous():
            raise ValueError("expected contiguous (n, 8) int32 words")
    if b.shape != a.shape or b.device != a.device:
        raise ValueError("a and b must have one shape and one device")
    if k < 0:
        raise ValueError("k must be >= 0")
    if _build.runs_plain(a):
        return fq_op_chain_plain(op, a, b, k)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        rc = _build.lib("field_kernels").ccf_fq_op_chain(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], OPS.index(op), k,
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "fq_op_chain")
    LAUNCHES["fq_op_chain"] += 1
    return out


def operands(n: int, seed: int = 3, device=None):
    """Two (n, 8) tensors of seeded canonical Fq values (Montgomery form is
    irrelevant to the op count), on the card unless device names another."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(2 * n)]
    w = torch.from_numpy(limb_codec.ints_to_words(vals))
    return w[:n].contiguous().to(dev), w[n:].contiguous().to(dev)


def run(n: int = 1 << 16, k: int = 64, ops: Sequence[str] = OPS, reps: int = 5,
        device=None) -> Dict[str, float]:
    """{op: G ops/s} on the card: each op's chain timed with CUDA events
    over `reps` launches after one warm-up launch."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the microbenchmark times the card's kernel: pass a CUDA device")
    a, b = operands(n, device=dev)
    rates = {}
    for op in ops:
        fq_op_chain(op, a, b, k)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fq_op_chain(op, a, b, k)
        end.record()
        torch.cuda.synchronize(dev)
        sec = start.elapsed_time(end) / reps / 1e3
        rates[op] = n * k / sec / 1e9
    return rates


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("field_bench needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    n, k = 1 << 16, 64
    print(f"{card}; n={n} elements, K={k} dependent steps per launch")
    for op, rate in run(n, k).items():
        print(f"RESULT {op}: {rate:.3f} G ops/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
