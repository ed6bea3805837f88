#!/usr/bin/env python3
"""The control of the comparison that decides `correct`.

    python3 proofbench/control.py --workload chain_2e20.wtns --seeds 11 12 13

The system states no precision; its configurations state a guarantee:
every proof is the exact Groth16 proof under the CircomReduction witness
map, whose h lives on the coset of the 2n-th root of unity. The control
puts the plain reference in the program's place with that guarantee
broken: h taken on the domain itself (no coset shift). For each seed it
makes the run's own inputs and requests at the cell's own size (as many
requests as `--requests`, by default four passes over the pool), answers
them with the control, and applies the run's comparison. Each line printed is one seed's compared numbers; the
comparison has to fail on every one. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402
import inputs  # noqa: E402
import reference  # noqa: E402


def control_answers(key, cfg, seed, device, n):
    ctrl = reference.ChainReference(key, device)
    scalars, answers = {}, []
    for j in range(n):
        a, r, s = harness.request_inputs(seed, cfg, j)
        if a not in scalars:
            scalars[a] = ctrl.scalars(a, coset=False)
        answers.append({"a": a, "r": r, "s": s, "error": None,
                        "proof": ctrl.proof(scalars[a]["dots"], r, s),
                        "public": scalars[a]["public"]})
    return answers


def run_control(workload, seed, device, bench=None, requests=None):
    bench = bench or harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, _, _, _ = harness.cell(bench, workload)
    key = inputs.PooledKey.make(cfg["k"], cfg["domain_size"], harness.request_rng(seed, "key"))
    answers = control_answers(key, cfg, seed, device, requests or 4 * cfg["witness_pool"])
    compared, _ = harness.check(key, answers, device)
    return compared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests a seed (default: four passes over the pool)")
    args = ap.parse_args(argv)
    failed_all = True
    for seed in args.seeds:
        compared = run_control(args.workload, seed, args.device, requests=args.requests)
        correct = harness.is_correct(compared)
        failed_all &= not correct
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": correct,
                          "compared": compared}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
