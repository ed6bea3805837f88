#!/usr/bin/env python3
"""Run one cell of the benchmark of circom_compat_tpu_torch once.

    python3 proofbench/run.py --workload chain_1e4.wtns --seed 7 --seconds 30 --trace 0

From the root of a checkout. Prints the compared numbers beside their
limits as the last lines on standard error and one JSON object as the last
line on standard output. Exits non-zero, with no result, without as many
CUDA devices as the cell asks for, without the program, or if the process
loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "circom_compat_tpu")


def forbidden_modules() -> list:
    """Top-level module names of sys.modules that the run may not hold,
    compared whole (circom_compat_tpu_torch is not circom_compat_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch

    import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                         T_START, bench)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 4
    try:
        import subprocess

        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
        result["card"] = {"power_limit": out.splitlines()[0] if out else None}
    except (OSError, subprocess.SubprocessError):
        result["card"] = {"power_limit": None}
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
