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
It prints the card's name and power limit, then for each op at n = 2^16
and 2^20 (K = 64) G ops/s by device time (the kernels' spans in
torch.profiler, utils/trace.device_ms) and by CUDA events around the
launches (wrapper included).
"""

from __future__ import annotations

import subprocess
from typing import Dict, Sequence

import numpy as np
import torch

from .. import _build
from ..constants import Q
from ..device import resolve_device
from ..utils.trace import device_ms
from . import field as fl
from . import limbs as limb_codec

OPS = ("mont_mul", "mont_mul_lazy", "add", "add_lazy", "sub_lazy", "mul9")
# ops whose operands and results are lazy, in [0, 2q); mont_mul and add take
# and give canonical values
LAZY_OPS = ("mont_mul_lazy", "add_lazy", "sub_lazy", "mul9")
LAUNCHES = {"fq_op_chain": 0}

# 32-bit integer operations of one op on 8-word elements (the bound's
# count): a Montgomery multiply is 264 multiply-adds (csrc/field.cuh), a
# conditional subtraction 8 word subtracts, an add 8 word adds plus its
# conditional subtraction, a subtraction 8 adds (+ 2p), 8 subtracts and
# its conditional subtraction; mul9 is four lazy adds.
INT_OPS = {"mont_mul": 272, "mont_mul_lazy": 264, "add": 16, "add_lazy": 16,
           "sub_lazy": 24, "mul9": 64}
# The bound's rate of those operations, a streaming multiprocessor a clock:
# the Montgomery products are multiply-add bound (64 32-bit IMAD an SM a
# clock, on the FMA pipe); the ops with no multiply issue their word adds,
# subtracts and selects on the ALU and FMA pipes side by side, up to 128 an
# SM a clock (four schedulers of 32 lanes).
OPS_PER_SM_CLOCK = {"mont_mul": 64, "mont_mul_lazy": 64, "add": 128, "add_lazy": 128,
                    "sub_lazy": 128, "mul9": 128}


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
    irrelevant to the op count): random words, the top one below q's, on
    the card unless device names another."""
    dev = resolve_device(device)
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(2 * n, 8), dtype=np.uint32)
    w[:, 7] %= Q >> 224
    t = torch.from_numpy(w.view(np.int32))
    return t[:n].contiguous().to(dev), t[n:].contiguous().to(dev)


def edge_values(op: str):
    """(a values, b values) of op's edge operands: 0, 1, q - 1 and two values
    whose low seven words are 0xffffffff (top word 0 and q's top word less
    one), 2q - 1 too for the lazy ops; b is 1 or q - 1 (or 2q - 1)."""
    ones = (1 << 224) - 1
    lazy = [2 * Q - 1] if op in LAZY_OPS else []
    return [0, 1, Q - 1, ones, (((Q >> 224) - 1) << 224) | ones, *lazy], [1, Q - 1, *lazy]


def edge_operands(op: str, n: int, seed: int = 3, device=None):
    """operands(n, seed) with the leading rows replaced by every pairing of
    edge_values(op), on the card unless device names another."""
    a, b = operands(n, seed, device)
    av, bv = edge_values(op)
    pairs = [(x, y) for x in av for y in bv]
    if n < len(pairs):
        raise ValueError(f"n must hold the {len(pairs)} edge pairs")
    for t, vals in ((a, [x for x, _ in pairs]), (b, [y for _, y in pairs])):
        t[: len(pairs)] = torch.from_numpy(limb_codec.ints_to_words(vals)).to(t.device)
    return a, b


def run(n: int = 1 << 16, k: int = 64, ops: Sequence[str] = OPS, reps: int = 20,
        device=None) -> Dict[str, dict]:
    """{op: {device_ms, spans, event_ms, device_gops, event_gops}} on the
    card: each op's chain after one warm-up launch, timed over `reps`
    launches by its kernel's device spans (device_ms, the mean of the
    `spans` recorded) and by CUDA events around the launches, the wrapper's
    host work included (event_ms); G ops/s are n * k over each. device_ms
    and device_gops are None when the profiler recorded no kernel."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the microbenchmark times the card's kernel: pass a CUDA device")
    a, b = operands(n, device=dev)
    rows = {}
    for op in ops:
        fq_op_chain(op, a, b, k)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fq_op_chain(op, a, b, k)
        end.record()
        torch.cuda.synchronize(dev)
        event = start.elapsed_time(end) / reps
        dev_ms, spans = device_ms(lambda: fq_op_chain(op, a, b, k), reps, "fq_op_chain")
        rows[op] = dict(device_ms=dev_ms, spans=spans, event_ms=event,
                        device_gops=None if dev_ms is None else n * k / dev_ms / 1e6,
                        event_gops=n * k / event / 1e6)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("field_bench needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    k = 64
    print(f"{card}; K={k} dependent steps per launch")
    for log_n in (16, 20):
        for op, row in run(1 << log_n, k).items():
            shown = "not measured" if row["device_gops"] is None else f"{row['device_gops']:.3f}"
            print(f"RESULT n=2^{log_n} {op}: {shown} G ops/s by device time "
                  f"({row['spans']} spans), {row['event_gops']:.3f} by events")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
