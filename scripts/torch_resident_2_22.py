#!/usr/bin/env python3
"""Does the device-resident prover hold a 2^22-domain key on one card?

    python3 scripts/torch_resident_2_22.py [--log-n 22]

Stages chip_smoke.py's synthetic known-dlog squaring-chain key at
2^log_n with DeviceProvingKey.build and proves once with prove_prepared,
stage by stage (stage_times). Prints the card's name and power limit, the
staged key's device bytes, each stage that finished and, if the card runs
out of memory, the stage it ran out in, the allocator's message (the
allocation it refused) and the bytes allocated and reserved at that point;
otherwise the proof's check against the host's expectation and the peak
device memory. Exits 0 either way: the outcome is the measurement. The
streamed prover (models/streamed.py, chip_smoke.py phase 12) is what
proves past this size.
"""

import argparse
import json
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    import chip_smoke as cs
    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.utils.chain import chain_matrices, chain_witness

    ap = argparse.ArgumentParser()
    ap.add_argument("--log-n", type=int, default=22)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_resident_2_22: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.nvidia_smi("name,power.limit"))
    rng = random.Random(cs.SEED)
    ks, g1_pool, g2_pool = cs.point_pools(rng)
    k = (1 << args.log_n) - 2
    pk, _ = cs.synthetic_key(k, rng, ks, g1_pool, g2_pool)
    asg = chain_witness(k, a=3)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dpk = gd.DeviceProvingKey.build(pk, chain_matrices(k), k, 2, device=dev)
    print(f"2^{args.log_n}: key staged in {time.perf_counter() - t0:.3f} s, {dpk.nbytes()} device "
          "bytes (queries, matrices, NTT tables)")
    times = {}
    try:
        gd.prove_prepared(dpk, 1, 2, asg, stage_times=times)
    except torch.cuda.OutOfMemoryError as exc:
        done = list(times)
        order = ["encode", "witness_map", "sorts", "msm_g1", "msm_g2", "readback", "assemble"]
        failed = next(s for s in order if s not in done)
        print(f"out of device memory in stage {failed} (stages done: {json.dumps(times)})")
        print(f"allocated {torch.cuda.memory_allocated()} B, reserved "
              f"{torch.cuda.memory_reserved()} B, peak {torch.cuda.max_memory_allocated()} B")
        print("allocator: " + str(exc).splitlines()[0])
        return 0
    print(f"the resident prove ran: stages {json.dumps(times)}, peak device memory "
          f"{torch.cuda.max_memory_allocated()} B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
