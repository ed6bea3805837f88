#!/usr/bin/env python3
"""The point kernels K6/K7 (point_add) and K8 (point_tile_scan) of this
tree beside other builds, on one NVIDIA GPU.

    python3 scripts/torch_point_sweep.py [--source DIR ...] [--vary SPEC ...]
        [--kernels add,scan] [--reps N] [--sass]

Builds this tree's csrc/curve_kernels.cu, the one in each --source directory
(another tree's csrc/, e.g. a parent commit's) and, for each --vary SPEC, a
copy of this tree's csrc/ with constants of curve_kernels.cu changed
(SPEC = "NAME=VALUE[,NAME=VALUE]", e.g. "kAddBlocksG1=8"), all nvcc runs in
parallel. Prints each build's ptxas registers and spill bytes for its point
kernels, then times every build on the same inputs with CUDA events, in
turns (A, B, ..., B, A), and checks that every build returns this tree's
words:
  add   K6/K7 at the path's shapes: G2 general add at 1,310,720 and 163,840
        (the 2^20 prove's Phase C), 16,384 (the 2^13 prove's largest) and a
        2^19 madd (a setup chunk of the fixed-base fold); G1 general add at
        5,242,880, 655,360 and 65,536, and a 2^19 madd;
  scan  K8 at the 2^20 prove's level-0 madd and level-1 add (G1 and G2).
The inputs are seeded random lazy Fq words, Z = one for madd (1 row in 97
the identity), one scan flag in 128: the kernels' arithmetic does not
depend on the points lying on the curve, and chip_smoke.py holds the
kernels against their plain versions on curve points.
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

# (group, mode, n points)
ADD_SHAPES = (("g2", "add", 1_310_720), ("g2", "add", 163_840), ("g2", "add", 16_384),
              ("g2", "madd", 1 << 19), ("g1", "add", 5_242_880), ("g1", "add", 655_360),
              ("g1", "add", 65_536), ("g1", "madd", 1 << 19))
# (group, mode, T): the 2^20 prove's level-0 and level-1 scans (w = 13, 20 windows)
SCAN_SHAPES = (("g1", "madd", 5_242_880), ("g1", "add", 327_680),
               ("g2", "madd", 1_310_720), ("g2", "add", 81_920))
Q_TOP = 0x30644E72  # top word of q: keeps random words below 2q
POINT_KERNELS = ("point_add", "tile_scan")  # substrings of the kernels' (mangled) names


def varied_copy(spec: str, root: Path) -> Path:
    """A copy of this tree's csrc/ with the constants of `spec` changed."""
    d = root / "csrc"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    path = d / "curve_kernels.cu"
    text = path.read_text()
    for item in spec.split(","):
        name, value = item.split("=")
        text, count = re.subn(rf"(constexpr \w+ {name} = )[^;]+;", rf"\g<1>{value};", text)
        if count != 1:
            raise ValueError(f"--vary {spec}: no single constant {name} in curve_kernels.cu")
    path.write_text(text)
    return d


def build(sources):
    """{tag: csrc dir} -> {tag: (library, ptxas rows of its point kernels)}."""
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
        lib = ctypes.CDLL(str(d / "curve_kernels.so"))
        for fn, argtypes in _build.SIGNATURES["curve_kernels"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        report = _build.ptxas_report(d / "ptxas.txt")
        libs[tag] = (lib, {k: row for k, row in report.items() if any(s in k for s in POINT_KERNELS)})
    return libs


def sass_histogram(so: Path) -> dict:
    """{kernel: (static instruction count, the 12 most frequent opcodes)}
    of the point kernels in a library, from cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], check=True, capture_output=True, text=True).stdout
    hist, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if any(s in m.group(1) for s in POINT_KERNELS) else None
            if name:
                hist[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            hist[name][m.group(1)] += 1
    return {k: (sum(c.values()), c.most_common(12)) for k, c in hist.items()}


def random_points(group, mode, lead, gen, dev):
    """Seeded lazy words of shape lead + point; affine-encoded for madd."""
    import torch

    from circom_compat_tpu_torch.ops import curve as cv

    g2 = group == "g2"
    shape = tuple(lead) + (3,) + ((2,) if g2 else ()) + (8,)
    v = torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device=dev, generator=gen)
    v[..., 7] = torch.remainder(v[..., 7].to(torch.int64), Q_TOP).to(torch.int32)
    if mode == "madd":  # affine-encoded: Z = one, or the identity's Z = 0
        flat = v.view((-1,) + shape[len(lead):])
        flat[:, 2] = cv.proj_identity_const(g2, dev)[1]
        flat[::97, 2] = 0
    return v


def run_case(libs, tags, launch_of, reps):
    """Times each build on one case, in turns; returns {tag: [ms, ms]}."""
    import torch

    ref = None  # this tree's words, from its first turn
    times = {tag: [] for tag in tags}
    for tag in tags + tags[::-1]:
        launch, outputs = launch_of(libs[tag][0], tag)
        launch()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            launch()
        e.record()
        torch.cuda.synchronize()
        times[tag].append(s.elapsed_time(e) / reps)
        if ref is None:
            ref = [o.clone() for o in outputs]
        elif not all(torch.equal(a, b) for a, b in zip(outputs, ref)):
            raise AssertionError(f"{tag} differs from this tree")
    return times


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", nargs="*", default=[], help="other csrc directories")
    ap.add_argument("--vary", nargs="*", default=[], help="NAME=VALUE[,NAME=VALUE] copies of this csrc")
    ap.add_argument("--kernels", default="add,scan", help="add (K6/K7), scan (K8) or both")
    ap.add_argument("--reps", type=int, default=3, help="launches per timed turn (more for small n)")
    ap.add_argument("--sass", action="store_true", help="print SASS opcode counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_point_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    sources = {"this": _build.CSRC, **{f"source-{i}": s for i, s in enumerate(args.source)}}
    for spec in args.vary:
        sources[spec] = varied_copy(spec, _build.CACHE / "sweep" / f"vary-{len(sources)}")
    t0 = time.perf_counter()
    libs = build(sources)
    print(f"{card}; built {len(libs)} trees in {time.perf_counter() - t0:.1f} s")
    for tag, (_, res) in libs.items():
        print(f"ptxas {tag} ({sources[tag]}): {json.dumps(res)}")
        if args.sass:
            so = _build.CACHE / "sweep" / tag / "curve_kernels.so"
            for kern, (count, top) in sass_histogram(so).items():
                print(f"sass {tag} {kern}: {count} instructions; {top}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    stream = torch.cuda.current_stream().cuda_stream
    tags = list(libs)
    kernels = args.kernels.split(",")
    results = {}

    def report(key, times, n):
        results[key] = times
        per = {tag: [round(t * (1 << 20) / n, 4) for t in ts] for tag, ts in times.items()}
        print(f"{key} ms (A..B, B..A): {json.dumps(times)}; per 2^20: {json.dumps(per)}")

    if "add" in kernels:
        for group, mode, n in ADD_SHAPES:
            p = random_points(group, "add", (n,), gen, dev)
            q = random_points(group, mode, (n,), gen, dev)
            out = torch.empty_like(p)

            def launch_of(lib, tag):
                def launch():
                    rc = lib.ccf_point_add(int(group == "g2"), int(mode == "madd"), p.data_ptr(),
                                           q.data_ptr(), out.data_ptr(), n, stream)
                    _build.check(rc, f"point_add ({tag})")
                return launch, (out,)

            reps = max(args.reps, min(200, (1 << 22) // n))
            report(f"add {group} {mode} n={n}", run_case(libs, tags, launch_of, reps), n)
            del p, q, out
            torch.cuda.empty_cache()
    if "scan" in kernels:
        for group, mode, T in SCAN_SHAPES:
            v = random_points(group, mode, (T, 16), gen, dev)
            f = torch.rand(T, 16, device=dev, generator=gen) < 1 / 128
            out, carry = torch.empty_like(v), torch.empty_like(v[:, 0])

            def launch_of(lib, tag):
                def launch():
                    rc = lib.ccf_point_tile_scan(int(group == "g2"), int(mode == "madd"), v.data_ptr(),
                                                 f.data_ptr(), out.data_ptr(), carry.data_ptr(), T, 16,
                                                 stream)
                    _build.check(rc, f"point_tile_scan ({tag})")
                return launch, (out, carry)

            report(f"scan {group} {mode} T={T}", run_case(libs, tags, launch_of, args.reps), T * 16)
            del v, f, out, carry
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "ms": results,
                      "ptxas": {tag: res for tag, (_, res) in libs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
