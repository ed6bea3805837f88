#!/usr/bin/env python3
"""The point kernels K6/K7 (point_add) and K8 (point_tile_scan), the NTT
row kernel K3/K4 (ntt_rows), the flat chain's stage kernel K5, the Fr
tile scan K2 and the Fq op chain K9 of this tree beside other builds, on
one NVIDIA GPU.

    python3 scripts/torch_point_sweep.py [--source DIR ...] [--vary SPEC ...]
        [--kernels add,scan,ntt,butterfly,tile_scan,k9] [--reps N] [--sass]

Builds the sources the chosen kernels need (csrc/curve_kernels.cu for add
and scan, csrc/field_kernels.cu for the others) from this tree, from each --source
directory (another tree's csrc/, e.g. a parent commit's) and, for each
--vary SPEC, from a copy of this tree's csrc/ with constants changed (SPEC =
"NAME=VALUE[,NAME=VALUE]", e.g. "kAddBlocksG1=8" or "kNttLogE=2"; each NAME
a constexpr of exactly one source), all nvcc runs in parallel. Prints each
build's ptxas registers and spill bytes for the chosen kernels, then times
every build on the same inputs with CUDA events, in turns (A, B, ..., B,
A), and checks that every build returns this tree's words:
  add   K6/K7 at the path's shapes: G2 general add at 1,310,720 and 163,840
        (the 2^20 prove's Phase C), 16,384 (the 2^13 prove's largest) and a
        2^19 madd (a setup chunk of the fixed-base fold); G1 general add at
        5,242,880, 655,360 and 65,536, and a 2^19 madd;
  scan  K8 at the 2^20 prove's level-0 madd and level-1 add (G1 and G2);
  ntt   K3/K4 at the 2^20 prove's three modes (1024 rows of 1024: DIF +
        pre + post, DIT + pre + post-sub, mid) and the 2^13 flat chain's
        rows (16 of 512: DIF, DIT + pre), on the plan's own tables;
  butterfly  K5 at the 2^13 flat chain's high stages (half 4096 .. 512,
        DIF and DIT: one fused launch, or a tree without it one launch a
        stage) and one stage at 2^20, with the profiler's device time
        beside the event time;
  tile_scan  K2 at the 2^20 prove's shape (T = 2^16 tiles of 16, flags at
        0.9) and a ragged T, with the profiler's device time;
  k9    K9 (fq_op_chain) at n = 2^16 and 2^20, K = 64, each op on its edge
        operands (ops/field_bench.edge_operands), with the profiler's
        device time; --sass adds each K = 64 kernel's SASS opcodes a step
        (its static count over the steps it holds).
The point inputs are seeded random lazy Fq words, Z = one for madd (1 row
in 97 the identity), one scan flag in 128: the kernels' arithmetic does not
depend on the points lying on the curve, and chip_smoke.py holds the
kernels against their plain versions on curve points. The ntt inputs are
seeded lazy Fr words.
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
R_TOP = 0x30644E72  # top word of r (the same): keeps random words below 2r
# kernel set -> (source, substrings of its kernels' (mangled) names)
SETS = {"add": ("curve_kernels", ("point_add",)), "scan": ("curve_kernels", ("tile_scan",)),
        "ntt": ("field_kernels", ("ntt_rows",)), "butterfly": ("field_kernels", ("butterfly",)),
        "tile_scan": ("field_kernels", ("fr_tile_scan",)), "k9": ("field_kernels", ("fq_op_chain",))}
# entry points of older trees that this tree no longer has
OLD_SIGNATURES = {"ccf_fr_butterfly_stage": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                                     ctypes.c_int, ctypes.c_void_p]}


def varied_copy(spec: str, root: Path) -> Path:
    """A copy of this tree's csrc/ with the constants of `spec` changed."""
    d = root / "csrc"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    for item in spec.split(","):
        name, value = item.split("=")
        hits = 0
        for path in sorted(d.glob("*.cu")):
            text, count = re.subn(rf"(constexpr \w+ {name} = )[^;]+;", rf"\g<1>{value};",
                                  path.read_text())
            if count:
                path.write_text(text)
            hits += count
        if hits != 1:
            raise ValueError(f"--vary {spec}: no single constant {name} in csrc/*.cu")
    return d


def build(sources, names, markers):
    """{tag: csrc dir} -> {tag: ({source: library}, ptxas rows of the kernels
    whose names hold one of `markers`)}; builds each of `names` per tree."""
    procs = []
    for tag, src in sources.items():
        d = _build.CACHE / "sweep" / tag
        d.mkdir(parents=True, exist_ok=True)
        for name in names:
            log = open(d / f"{name}.ptxas.txt", "w")
            cmd = _build.nvcc_command(Path(src) / f"{name}.cu", d / f"{name}.so")
            procs.append((tag, name, d, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    libs = {}
    for tag, name, d, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{(d / f'{name}.ptxas.txt').read_text()[-3000:]}")
        lib = ctypes.CDLL(str(d / f"{name}.so"))
        for fn, argtypes in {**_build.SIGNATURES[name], **OLD_SIGNATURES}.items():
            if hasattr(lib, fn):  # another tree may lack a newer entry point, or have an older one
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        report = _build.ptxas_report(d / f"{name}.ptxas.txt")
        found, res = libs.setdefault(tag, ({}, {}))
        found[name] = lib
        res.update({k: row for k, row in report.items() if any(m in k for m in markers)})
    return libs


def disassemble(so: Path) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(so)], check=True, capture_output=True, text=True).stdout


def demangle(name: str) -> str:
    tool = shutil.which("c++filt")
    if tool is None:
        return name
    return subprocess.run([tool, name], check=True, capture_output=True, text=True).stdout.strip()


def sass_histogram(so: Path, markers) -> dict:
    """{kernel: (static instruction count, the 12 most frequent opcodes)}
    of the kernels whose names hold one of `markers`, from cuobjdump -sass."""
    funcs = sass_functions(disassemble(so), markers)
    return {k: (len(ins), collections.Counter(op for _, op, _ in ins).most_common(12))
            for k, ins in funcs.items()}


def sass_functions(text: str, markers) -> dict:
    """{kernel: [(address, opcode, line)]} of the kernels whose names hold
    one of `markers`, from cuobjdump -sass text."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if any(s in m.group(1) for s in markers) else None
            if name:
                funcs[name] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(2), line))
    return funcs


def k9_step_sass(so: Path, csrc: Path) -> dict:
    """{op: (instructions a step, {opcode: count a step})} of the K = 64
    kernels of a tree that compiles K in (fq_op_chain_kernel<OP, 64>).
    Where the steps run in a loop (a conditional backward branch), the
    loop's body over the steps it holds (the op's unroll constant); else
    (the add family, straight-line) the whole kernel over its 64 steps, the
    loads, index and stores spread over them."""
    from circom_compat_tpu_torch.ops import field_bench as fbn

    text = (csrc / "field_kernels.cu").read_text()
    unroll = {}
    for const in ("kChainMulUnroll", "kChainMul9Unroll", "kChainAddUnroll"):
        m = re.search(rf"constexpr int {const} = (\d+);", text)
        if m is None:
            return {}
        unroll[const] = int(m.group(1))
    out = {}
    for kern, ins in sass_functions(disassemble(so), ("fq_op_chain",)).items():
        m = re.search(r"fq_op_chain_kernel<(\d+), (\d+)>", demangle(kern))
        if m is None or int(m.group(2)) == 0:
            continue
        op = int(m.group(1))
        const = "kChainMulUnroll" if op <= 1 else "kChainMul9Unroll" if op == 5 else "kChainAddUnroll"
        loops = []
        for addr, opcode, line in ins:
            b = re.search(r"@!?P\d\s+BRA\s+(0x[0-9a-f]+)", line)
            if opcode == "BRA" and b and int(b.group(1), 16) < addr:
                loops.append((addr - int(b.group(1), 16), int(b.group(1), 16), addr))
        if loops:
            _, lo, hi = max(loops)
            body = [opcode for addr, opcode, _ in ins if lo <= addr <= hi]
            steps = min(unroll[const], 64)
        else:
            body = [opcode for _, opcode, _ in ins]
            steps = 64
        counter = collections.Counter(body)
        out[fbn.OPS[op]] = (round(len(body) / steps, 2),
                            {k: round(v / steps, 2) for k, v in counter.most_common(10)})
    return out


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


def device_times(libs, tags, launch_of, reps, match):
    """{tag: mean device ms per launch} under torch.profiler
    (utils/trace.device_ms: the mean of the recorded spans of the
    kernels whose names hold `match`, one a launch() call, over up to five
    sessions); None if none was recorded, and a note when fewer than reps
    were."""
    import torch

    from circom_compat_tpu_torch.utils import trace

    out = {}
    for tag in tags:
        launch, _ = launch_of(libs[tag][0], tag)
        launch()
        torch.cuda.synchronize()
        ms, spans = trace.device_ms(launch, reps, match)
        out[tag] = None if ms is None else round(ms, 5)
        if spans < reps:
            print(f"    the profiler recorded {spans} spans of {tag} for {reps} launches")
    return out


def run_case(libs, tags, launch_of, reps, same=None):
    """Times each build on one case, in turns; returns {tag: [ms, ms]}.
    same(tag, outputs, reference) replaces word-for-word equality."""
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
        elif same is not None:
            same(tag, outputs, ref)
        elif not all(torch.equal(a, b) for a, b in zip(outputs, ref)):
            raise AssertionError(f"{tag} differs from this tree")
    return times


def field_lazy(shape, gen, dev):
    import torch

    v = torch.randint(-2**31, 2**31, tuple(shape) + (8,), dtype=torch.int32, device=dev, generator=gen)
    v[..., 7] = torch.remainder(v[..., 7].to(torch.int64), 2 * R_TOP).to(torch.int32)
    return v


def ntt_cases(libs, tags, gen, dev, stream, reps, report):
    """K3/K4 at the 2^20 prove's three modes and the 2^13 flat chain's rows."""
    import torch

    from circom_compat_tpu_torch.ops import field_kernels as fk
    from circom_compat_tpu_torch.ops import ntt

    four = ntt.get_plan(1 << 20).tables(dev, "four_step")
    flat = ntt.get_plan(1 << 13).tables(dev, "flat")
    x, pre, post = (field_lazy((1024, 1024), gen, dev) for _ in range(3))
    xs, pres = field_lazy((16, 512), gen, dev), field_lazy((16, 512), gen, dev)
    mid = four["coset4"].reshape(1024, 1024, 8)
    # name, x, (tw_dif, tw_dit, pre, mid, post, post_op), launches per timed turn
    cases = (("2^20 DIF + pre + post", x, (four["tw1_inv"], None, pre, None, post, 0), reps),
             ("2^20 DIT + pre + post-sub", x, (None, four["tw1_fwd"], pre, None, post, 1), reps),
             ("2^20 mid", x, (four["tw2_inv"], four["tw2_fwd"], None, mid, None, 0), reps),
             ("2^13 flat DIF", xs, (flat["low_inv"], None, None, None, None, 0), 20 * reps),
             ("2^13 flat DIT + pre", xs, (None, flat["low_fwd"], pres, None, None, 0), 20 * reps))
    one = torch.tensor([1, 0, 0, 0, 0, 0, 0, 0], dtype=torch.int32, device=dev)

    def same_ntt(tag, outputs, ref):
        """This tree's copies return its words; another tree (one without
        the skip of multiplies by one) the same values mod r."""
        if torch.equal(outputs[0], ref[0]):
            return
        canon = [fk.fr_binary_plain("mul_canon", o.reshape(-1, 8), one) for o in (outputs[0], ref[0])]
        if tag.startswith("source-") and torch.equal(*canon):
            return
        raise AssertionError(f"{tag} differs from this tree")

    for name, xin, (tw_dif, tw_dit, p, m, q, post_op), n_reps in cases:
        out = torch.empty_like(xin)
        ptr = [None if t is None else t.data_ptr() for t in (tw_dif, tw_dit, p, m, q)]
        rows, L = xin.shape[:2]

        def launch_of(lib, tag):
            def launch():
                rc = lib["field_kernels"].ccf_ntt_rows(xin.data_ptr(), out.data_ptr(), *ptr, post_op, rows,
                                                       L.bit_length() - 1, stream)
                _build.check(rc, f"ntt_rows ({tag})")
            return launch, (out,)

        report(f"ntt {name}", run_case(libs, tags, launch_of, n_reps, same_ntt), rows * L)


def butterfly_cases(libs, tags, gen, dev, stream, reps, report):
    """K5 at the 2^13 flat chain's high stages and as one 2^20 stage: this
    tree's fused entry (ccf_fr_butterfly_stages) or, in a tree without it,
    one ccf_fr_butterfly_stage launch a stage (the same words)."""
    import torch

    from circom_compat_tpu_torch.ops import ntt

    # name, log2 n, half_lo, half_hi, dif, launches per timed turn
    cases = (("2^13 DIF 4096..512", 13, 512, 4096, True, 50 * reps),
             ("2^13 DIT 512..4096", 13, 512, 4096, False, 50 * reps),
             ("2^20 DIF one stage", 20, 1 << 19, 1 << 19, True, 5 * reps),
             ("2^20 DIT one stage", 20, 1 << 19, 1 << 19, False, 5 * reps))
    for name, log_n, lo, hi, dif, n_reps in cases:
        n = 1 << log_n
        tw = ntt.get_plan(n).tables(dev, "flat")["tw_inv" if dif else "tw_fwd"]
        x = field_lazy((n,), gen, dev)
        bufs = [torch.empty_like(x), torch.empty_like(x)]
        halves = [1 << k for k in range(lo.bit_length() - 1, hi.bit_length())]
        halves = halves[::-1] if dif else halves
        log_r = len(halves)

        def launch_of(lib, tag):
            field = lib["field_kernels"]
            if hasattr(field, "ccf_fr_butterfly_stages"):
                def launch():
                    rc = field.ccf_fr_butterfly_stages(x.data_ptr(), tw.data_ptr(), bufs[0].data_ptr(), n,
                                                       lo.bit_length() - 1, log_r, int(dif), stream)
                    _build.check(rc, f"fr_butterfly_stages ({tag})")
                return launch, (bufs[0],)

            def launch():
                src = x
                for i, half in enumerate(halves):
                    dst = bufs[(log_r - 1 - i) % 2]  # the last stage writes bufs[0]
                    rc = field.ccf_fr_butterfly_stage(src.data_ptr(), tw.data_ptr(), dst.data_ptr(), n,
                                                      half.bit_length() - 1, int(dif), stream)
                    _build.check(rc, f"fr_butterfly_stage ({tag})")
                    src = dst
            return launch, (bufs[0],)

        report(f"butterfly {name}", run_case(libs, tags, launch_of, n_reps), n,
               device_times(libs, tags, launch_of, n_reps, "butterfly_stage"))


def tile_scan_cases(libs, tags, gen, dev, stream, reps, report):
    """K2 at the 2^20 prove's shape (T = 2^16 tiles of 16, flags at 0.9)
    and a ragged T."""
    import torch

    for T in (1 << 16, (1 << 16) - 37):
        v = field_lazy((T, 16), gen, dev)
        f = torch.rand(T, 16, device=dev, generator=gen) < 0.9
        out, carry = torch.empty_like(v), torch.empty_like(v[:, 0])

        def launch_of(lib, tag):
            def launch():
                rc = lib["field_kernels"].ccf_fr_tile_scan(v.data_ptr(), f.data_ptr(), out.data_ptr(),
                                                           carry.data_ptr(), T, 16, stream)
                _build.check(rc, f"fr_tile_scan ({tag})")
            return launch, (out, carry)

        report(f"tile_scan T={T}", run_case(libs, tags, launch_of, 10 * reps), T * 16,
               device_times(libs, tags, launch_of, 10 * reps, "fr_tile_scan"))


def k9_cases(libs, tags, dev, stream, reps, report):
    """K9 at n = 2^16 and 2^20, K = 64, each op on its edge operands."""
    import torch

    from circom_compat_tpu_torch.ops import field_bench as fbn

    for log_n in (16, 20):
        n = 1 << log_n
        for op in fbn.OPS:
            a, b = fbn.edge_operands(op, n, device=dev)
            out = {}

            def launch_of(lib, tag):
                field = lib["field_kernels"]
                o = out.setdefault(tag, torch.empty_like(a))

                def launch():
                    rc = field.ccf_fq_op_chain(a.data_ptr(), b.data_ptr(), o.data_ptr(), n, fbn.OPS.index(op),
                                               64, stream)
                    _build.check(rc, f"fq_op_chain ({tag})")
                return launch, (o,)

            n_reps = reps * (20 if log_n == 16 else 2)
            report(f"k9 {op} n=2^{log_n}", run_case(libs, tags, launch_of, n_reps), n,
                   device_times(libs, tags, launch_of, n_reps, "fq_op_chain"))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", nargs="*", default=[], help="other csrc directories")
    ap.add_argument("--vary", nargs="*", default=[], help="NAME=VALUE[,NAME=VALUE] copies of this csrc")
    ap.add_argument("--kernels", default="add,scan",
                    help="any of add (K6/K7), scan (K8), ntt (K3/K4), butterfly (K5), tile_scan (K2), k9")
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
    kernels = args.kernels.split(",")
    names = sorted({SETS[k][0] for k in kernels})
    markers = tuple(m for k in kernels for m in SETS[k][1])
    t0 = time.perf_counter()
    libs = build(sources, names, markers)
    print(f"{card}; built {len(libs)} trees in {time.perf_counter() - t0:.1f} s")
    for tag, (_, res) in libs.items():
        print(f"ptxas {tag} ({sources[tag]}): {json.dumps(res)}")
        if args.sass:
            for name in names:
                so = _build.CACHE / "sweep" / tag / f"{name}.so"
                for kern, (count, top) in sass_histogram(so, markers).items():
                    print(f"sass {tag} {kern}: {count} instructions; {top}")
            if "k9" in kernels:
                for key, (count, top) in k9_step_sass(_build.CACHE / "sweep" / tag / "field_kernels.so",
                                                      Path(sources[tag])).items():
                    print(f"sass a step {tag} {key}: {count} instructions; {json.dumps(top)}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    stream = torch.cuda.current_stream().cuda_stream
    tags = list(libs)
    results, device = {}, {}

    def report(key, times, n, dev_ms=None):
        results[key] = times
        per = {tag: [round(t * (1 << 20) / n, 4) for t in ts] for tag, ts in times.items()}
        shown = "" if dev_ms is None else f"; device ms (profiler): {json.dumps(dev_ms)}"
        if dev_ms is not None:
            device[key] = dev_ms
        print(f"{key} ms (A..B, B..A): {json.dumps(times)}; per 2^20: {json.dumps(per)}{shown}")

    if "add" in kernels:
        for group, mode, n in ADD_SHAPES:
            p = random_points(group, "add", (n,), gen, dev)
            q = random_points(group, mode, (n,), gen, dev)
            out = torch.empty_like(p)

            def launch_of(lib, tag):
                def launch():
                    rc = lib["curve_kernels"].ccf_point_add(int(group == "g2"), int(mode == "madd"), p.data_ptr(),
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
                    rc = lib["curve_kernels"].ccf_point_tile_scan(int(group == "g2"), int(mode == "madd"), v.data_ptr(),
                                                 f.data_ptr(), out.data_ptr(), carry.data_ptr(), T, 16,
                                                 stream)
                    _build.check(rc, f"point_tile_scan ({tag})")
                return launch, (out, carry)

            report(f"scan {group} {mode} T={T}", run_case(libs, tags, launch_of, args.reps), T * 16)
            del v, f, out, carry
            torch.cuda.empty_cache()
    if "ntt" in kernels:
        ntt_cases(libs, tags, gen, dev, stream, args.reps, report)
    if "butterfly" in kernels:
        butterfly_cases(libs, tags, gen, dev, stream, args.reps, report)
    if "tile_scan" in kernels:
        tile_scan_cases(libs, tags, gen, dev, stream, args.reps, report)
    if "k9" in kernels:
        k9_cases(libs, tags, dev, stream, args.reps, report)
    print(json.dumps({"card": card, "ms": results, "device_ms": device,
                      "ptxas": {tag: res for tag, (_, res) in libs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
