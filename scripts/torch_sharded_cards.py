#!/usr/bin/env python3
"""The multi-device provers (parallel/) over distinct cards.

    python3 scripts/torch_sharded_cards.py [--log-n 20]

On a machine with at least four cards: chip_smoke.py's phase 4 key (a
2^log_n squaring chain with a synthetic key of known discrete logs) staged
on cuda:0 and proved there as the reference (held against the host's
known-dlog A, B, C), then chip_smoke.sharded_phase, which runs
build_sharded_prover with the distributed NTT on and off,
prove_streamed_sharded over a mesh of the first four cards and over cuda:0
repeated (each proof equal to the reference byte for byte, with medians,
stages, peak memory on each card and launches), the sharded witness map,
msm_g1_sharded and dist-dryrun with gloo; then dist-dryrun with NCCL (two
processes of two cards, the global and the two-level mesh). Prints the
cards' names and power limits and the calls that synchronized a card in
one sharded prove; exits non-zero on any mismatch or failure.
"""

import argparse
import json
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as cs
    from circom_compat_tpu_torch import _build
    from circom_compat_tpu_torch.constants import R_SCALAR
    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.ops import curve_kernels as ck
    from circom_compat_tpu_torch.ops import field_kernels as fk
    from circom_compat_tpu_torch.ops import limbs as lc
    from circom_compat_tpu_torch.utils.chain import chain_matrices, chain_witness

    ap = argparse.ArgumentParser()
    ap.add_argument("--log-n", type=int, default=cs.LOG_N)
    args = ap.parse_args()
    if torch.cuda.device_count() < cs.SHARDS:
        print(f"torch_sharded_cards: needs {cs.SHARDS} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    card = cs.nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda", 0)
    rng = random.Random(cs.SEED)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    ks, g1_pool, g2_pool = cs.point_pools(rng)
    n = 1 << args.log_n
    pk, secret = cs.synthetic_key(n - 2, rng, ks, g1_pool, g2_pool)
    matrices = chain_matrices(n - 2)
    dpk = gd.DeviceProvingKey.build(pk, matrices, n - 2, 2, device=dev)
    asg = chain_witness(n - 2, a=3)
    r, s = rng.randrange(R_SCALAR), rng.randrange(R_SCALAR)
    torch.cuda.reset_peak_memory_stats(dev)
    resident = gd.prove_prepared(dpk, r, s, asg)
    peak = torch.cuda.max_memory_allocated(dev)
    h = fk.fr_from_mont(dpk.matrices.witness_map(
        fk.fr_to_mont(torch.from_numpy(gd.encode_assignment(asg)).to(dev))))
    if resident != cs.expected_proof(secret, asg, lc.words_to_ints(h.cpu().numpy()), r, s):
        raise AssertionError("the resident reference proof differs from the host's known-dlog A, B, C")
    del h
    print(f"reference: resident prove at 2^{args.log_n} on cuda:0 equals the known-dlog A, B, C; "
          f"peak {peak} B ({card})")

    def reset_all():
        fk.reset_launches()
        ck.reset_launches()

    def record(counts, names, path):
        for name in names:
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} did not launch on {path}")

    def on_path(path, names, fn):
        reset_all()
        out = fn()
        torch.cuda.synchronize()
        now = {**fk.LAUNCHES, **ck.LAUNCHES}
        record(now, names, path)
        return out, {k: v for k, v in now.items() if v}

    def check(name, kernel_fn, plain_fn, reps, nbytes, mads, replaces, source, note=""):
        if cs.max_abs_err(kernel_fn(), plain_fn()) != 0:
            raise AssertionError(f"{name}{note}: kernel and plain version differ")
        print(f"{name}{note}: equal to plain; {cs.timed(kernel_fn, reps)[1]:.4f} ms")

    from circom_compat_tpu_torch.parallel import mesh as pm
    from circom_compat_tpu_torch.parallel import prove_sharded as ps

    for dist_ntt in (True, False):
        prover = ps.build_sharded_prover(dpk, pm.make_mesh(cs.SHARDS), dist_ntt=dist_ntt)
        ps.prove_sharded(dpk, prover, r, s, asg)
        got, sites = cs.sync_sites(lambda: ps.prove_sharded(dpk, prover, r, s, asg))
        if got != resident:
            raise AssertionError("the sharded proof under sync debugging differs")
        print(f"distinct cards, dist_ntt {dist_ntt}: calls that synchronized a card in one prove "
              f"(file:line: count): {json.dumps(sites)}")
        del prover

    cs.sharded_phase(dev, card, dpk, matrices, resident, asg, r, s, g1_pool, gen, on_path, record,
                     check, 264, peak, log_n=args.log_n)

    for extra in ([], ["--two-level"]):
        cmd = [sys.executable, "-m", "circom_compat_tpu_torch", "dist-dryrun", "--processes", "2",
               "--local-devices", "2", "--chain-k", str((1 << cs.LOG_SMALL) - 2), "--timeout", "240",
               *extra]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"dist-dryrun (NCCL) {extra} failed ({out.returncode}): "
                                 f"{out.stderr[-3000:]}")
        line = json.loads(out.stdout.strip().splitlines()[-1])
        if line["backend"] != "nccl" or not line["proof_matches_single_process"]:
            raise AssertionError(f"dist-dryrun (NCCL) {extra}: {line}")
        print(f"[nccl] {' '.join(cmd[3:])}: {time.perf_counter() - t0:.3f} s wall ({card}); record "
              + json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
