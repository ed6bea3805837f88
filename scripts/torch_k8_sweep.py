#!/usr/bin/env python3
"""K8 (point_tile_scan) of this tree beside other trees' sources, on one
NVIDIA GPU.

    python3 scripts/torch_k8_sweep.py [--source DIR ...] [--reps N] [--sass]

Builds this tree's csrc/curve_kernels.cu and the one in each --source
directory (another tree's csrc/, e.g. a parent commit's, or a copy with
another register budget), all nvcc runs in parallel. Prints each build's
ptxas registers and spill bytes for its tile-scan kernels, then times
every build on the same inputs at the 2^20 prove's shapes (level-0 madd
and level-1 add, G1 and G2) with CUDA events, in turns (A, B, ..., B, A),
and checks that every build returns this tree's words. The inputs are
seeded random lazy Fq words, Z = one for madd (1 row in 97 the identity),
one flag in 128: the kernels' arithmetic does not depend on the points
lying on the curve, and chip_smoke.py holds the kernel against its plain
version on curve points.
"""

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from circom_compat_tpu_torch import _build  # noqa: E402

# (group, mode, T): the 2^20 prove's level-0 and level-1 scans (w = 13, 20 windows)
SHAPES = (("g1", "madd", 5_242_880), ("g1", "add", 327_680),
          ("g2", "madd", 1_310_720), ("g2", "add", 81_920))
Q_TOP = 0x30644E72  # top word of q: keeps random words below 2q


def build(sources):
    """{tag: csrc dir} -> {tag: (ccf_point_tile_scan, ptxas rows of its tile-scan kernels)}."""
    procs = []
    for tag, src in sources.items():
        d = _build.CACHE / "sweep" / tag
        d.mkdir(parents=True, exist_ok=True)
        log = open(d / "ptxas.txt", "w")
        cmd = _build.nvcc_command(Path(src) / "curve_kernels.cu", d / "curve_kernels.so")
        procs.append((tag, d, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    libs = {}
    for tag, d, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{(d / 'ptxas.txt').read_text()[-3000:]}")
        fn = ctypes.CDLL(str(d / "curve_kernels.so")).ccf_point_tile_scan
        fn.argtypes = _build.SIGNATURES["curve_kernels"]["ccf_point_tile_scan"]
        fn.restype = ctypes.c_int
        report = _build.ptxas_report(d / "ptxas.txt")
        libs[tag] = (fn, {k: row for k, row in report.items() if "tile_scan" in k})
    return libs


def sass_histogram(so: Path) -> dict:
    """{kernel: (static instruction count, the 12 most frequent opcodes)}
    of the tile-scan kernels in a library, from cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], check=True, capture_output=True, text=True).stdout
    hist, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "tile_scan" in m.group(1) else None
            if name:
                hist[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            hist[name][m.group(1)] += 1
    return {k: (sum(c.values()), c.most_common(12)) for k, c in hist.items()}


def inputs(group, mode, T, gen, dev):
    import torch

    from circom_compat_tpu_torch.ops import curve as cv

    g2 = group == "g2"
    shape = (T, 16, 3) + ((2,) if g2 else ()) + (8,)
    v = torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device=dev, generator=gen)
    v[..., 7] = torch.remainder(v[..., 7].to(torch.int64), Q_TOP).to(torch.int32)
    if mode == "madd":  # affine-encoded: Z = one, or the identity's Z = 0
        v[:, :, 2] = cv.proj_identity_const(g2, dev)[1]
        v.view((T * 16,) + shape[2:])[::97, 2] = 0
    f = torch.rand(T, 16, device=dev, generator=gen) < 1 / 128
    return v, f


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", nargs="*", default=[], help="other csrc directories")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sass", action="store_true", help="print SASS opcode counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k8_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    sources = {"this": _build.CSRC, **{f"source-{i}": s for i, s in enumerate(args.source)}}
    t0 = time.perf_counter()
    libs = build(sources)
    print(f"{card}; built {len(libs)} trees in {time.perf_counter() - t0:.1f} s")
    for tag, (_, res) in libs.items():
        print(f"ptxas {tag} ({sources[tag]}): {json.dumps(res)}")
        if args.sass:
            for kern, (count, top) in sass_histogram(_build.CACHE / "sweep" / tag / "curve_kernels.so").items():
                print(f"sass {tag} {kern}: {count} instructions; {top}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    stream = torch.cuda.current_stream().cuda_stream
    tags = list(libs)
    results = {}
    for group, mode, T in SHAPES:
        v, f = inputs(group, mode, T, gen, dev)
        ref = None  # this tree's words, from its first turn
        times = {tag: [] for tag in tags}
        for tag in tags + tags[::-1]:
            fn = libs[tag][0]
            out, carry = torch.empty_like(v), torch.empty_like(v[:, 0])

            def launch():
                rc = fn(int(group == "g2"), int(mode == "madd"), v.data_ptr(), f.data_ptr(),
                        out.data_ptr(), carry.data_ptr(), T, 16, stream)
                _build.check(rc, f"point_tile_scan ({tag})")

            launch()
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(args.reps):
                launch()
            e.record()
            torch.cuda.synchronize()
            times[tag].append(s.elapsed_time(e) / args.reps)
            if ref is None:
                ref = (out, carry)
            elif not (torch.equal(out, ref[0]) and torch.equal(carry, ref[1])):
                raise AssertionError(f"{tag} differs from this tree at {group} {mode}")
        results[f"{group} {mode} T={T}"] = times
        print(f"{group} {mode} T={T} ms (A..B, B..A): {json.dumps(times)}")
        del v, f, ref, out, carry
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "ms": results,
                      "ptxas": {tag: res for tag, (_, res) in libs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
