#!/usr/bin/env python3
"""Smoke run of circom_compat_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each passes or raises; nothing is caught):
  1. card: builds the CUDA kernels from csrc/ (nvcc, sm_90a), prints each
     kernel's registers and spill bytes (ptxas; the K3/K4, K6/K7 and K8
     entry kernels by their C names, K3/K4's with each row length's block
     shape, shared memory and resident warps, K2's batch and persistent
     grid) and the card's name and power limit;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the 2^20-domain prove gives it, word for word (max_abs_err 0);
     K6/K7 at 2^20 pairs and at the path's largest general add (Phase C
     over the level-0 carries: 5,242,880 G1, 1,310,720 G2); K3/K4 also at
     the 2^22 four-step shape (rows of 2048: ccf_ntt_rows_log11); K10
     (proof_fold) at the 2^20 prove's windows (w = 13, W = 20) and the 10^4
     prove's (w = 8, W = 32), its bound the latency of its longest chain of
     dependent Fq multiplies (K9 in one thread);
  3. each kernel's time (CUDA events, warmed up, averaged), its bound and
     the plain version's time; K3/K4's bounds count the butterflies whose
     twiddle is not one, and their rows are also checked and timed at the
     2^13 flat chain's shape (16 rows of 512: DIF, DIT + pre); K5's fused
     stages at the flat chain's shapes (all high stages of a 2^10 to 2^13
     transform, DIF and DIT) and as one stage at 2^20, with the profiler's
     device time beside the event time (at 2^13 an event time per call is
     mostly the host's); K2 also at a ragged T;
  4. the main path: a 2^20-domain squaring-chain proof through
     DeviceProvingKey.build and prove_prepared, against a synthetic key
     whose every point has a known discrete log, so the host knows A, B and
     C exactly; h is also held against the plain witness map run on the
     card; one prove under trace.collect must give the prover's trace
     stages; after the timed proves, one prove under torch.profiler: the
     top device kernels, the device's idle share and each of the port's
     kernel families' summed device time and launches;
  5. golden: chain254 proved from tests/golden/chain254.zkey must equal
     tests/golden/chain254_proof.json and verify;
  6. the small-circuit path at a 2^13 domain: setup on the card
     (generate_parameters_from_matrices, self-check included) -> write_zkey
     -> read_zkey -> DeviceProvingKey.build -> prove_prepared, which must go
     through the flat NTT chain (one fused fr_butterfly_stages launch a
     transform, six in all, no ntt_rows mid launch); h against the plain
     witness map, the proof verified by pairing and a wrong public input
     refused; the steady-state prove and the flat chain timed beside the
     four-step chain at the same size, each with its launches counted;
     one prove under torch.profiler as in phase 4;
  7. setup on the card at 2^20 for phase 4's circuit, by stage, with its
     peak device memory; the 2^20 proof made with that key verified by
     pairing;
  8. the K9 microbenchmark (ops/field_bench.run): G ops/s of each Fq op at
     n = 2^16 and 2^20 by device time (the kernels' profiler spans), the
     CUDA-event rate (wrapper included) beside it;
  9. the prove server at 2^20: phase 7's key written with write_zkey and the
     chain's assignment with write_wtns; a ProveServer on a unix socket
     (staged keys released first) answers a ping, three witness_file
     requests, one with fixed r/s that must equal
     Groth16.create_proof_with_reduction_and_matrices on the same key byte
     for byte, ok: false to a malformed request, then one more proof; one
     served proof verified by pairing; load, staging, warm-up, each
     request's prove_s and the peak device memory;
 10. the CLI at 2^13 (`cli.main`, on the card by default): phase 6's key
     written to a file; prove (which must launch fr_butterfly_stages), prove
     --backend streamed under --timings (the table must hold
     prove.msm_stream; the proof must verify), export-vkey, verify (0; 1 for
     a tampered public input) and export-calldata (the ethereum.Proof tuple);
 11. the standalone msm_g1 / msm_g2 at 2^20 points of known discrete logs
     from phase 4's pools: equal to (sum s_i k_i) G, then points/s (median
     of 3 after the checked call);
 14. (run after 11) (a) the phase-2 ceremony at 2^20: one contribution with
     fixed entropy to phase 7's key (L and H rescaled by s^-1 on the card:
     scalar_mul_const through K6/K7, the batch inversion through K1): delta
     equal to the host's, 64 sampled L and H rows equal to s^-1 P, a proof
     under the new key verified and refused by the old vk; the rescale's
     seconds for L and H, its launches and peak memory; (b) phase 6's
     circuit set up on the card with delta = 1 and given two contributions:
     section 10 through write_zkey / read_zkey, verify_mpc_chain True, False
     for a tampered g1_sx and an unlinked delta, the CLI's contribute (0)
     and verify-chain (0, and 1 on a tampered file); (c) ops/ntt fft, ifft
     and coset_shift at 2^20, 2^13 (flat chain) and 2^9 against their plain
     versions mod r, ifft(fft(x)) = x, fft against Horner at 16 points, with
     times and launches; (d) the iFFT H scalars at the 2^20 domain equal to
     the closed form word for word, each timed; (e) the signed-digit
     msm_g1 / msm_g2 at 2^20 equal to the unsigned result and the
     known-dlog sum, points/s of both; (f) evm.py: keccak vectors, ecPairing
     on phase 6's proof as the verifier contract feeds it (and refusing a
     tampered one), verify-onchain without the artifact raising
     FileNotFoundError as the JAX CLI does.
 15. (run last) the witness engines on utils/chain_wasm.chain_wasm, the
     squaring chain's WASM witness generator: (a) k = 2^20 - 2 through
     engine="aot", its gcc build and run seconds, the witness equal to
     chain_witness and calculate_witness_limbs to its limbs; (b) "native"
     at 2^16 - 2 and "interp" at 2^10 - 2 (and aot at both), each equal to
     chain_witness, all three equal at 2^10 - 2, seconds and WASM
     instructions a second; (c) the CLI's `--timings fullprove ... --engine
     aot` at 2^20 on phase 7's key (written with write_zkey): the stage
     table (witness.calculate beside the prove stages), K1, K2, K3, K4,
     K6/K7 and K8 launched, verify returning OK!; (d) chain_wasm(254) with
     {"a": 3} through each engine proved on tests/golden/chain254.zkey at
     r = 77, s = 88: chain254_proof.json byte for byte; (e) the native
     Montgomery strip against mont_strip_np on the key's section-4 values,
     word for word, the seconds of each beside phase 9's zkey load.
 13. (run right after phase 4, on its key, assignment and r/s) the
     multi-device provers (parallel/) over a mesh of four entries that repeat
     the card (and over distinct cards, in turn, where the machine has two
     or more):
     build_sharded_prover with the distributed NTT on and off, each proof
     equal to phase 4's byte for byte, medians of 3, stages, peak memory,
     launches and one profiled prove; ntt_rows at the distributed witness
     map's shapes against its plain version (on the kernels line); the
     sharded witness map's h against its plain version and, under td_perm,
     the resident one; msm_g1_sharded at 2^20 against msm_g1;
     prove_streamed_sharded at chunk 3 * 2^17 against the resident proof with
     each part's copy and compute time; the CLI's dist-dryrun (two gloo
     processes of two shards sharing the card, 2^13, global and two-level
     mesh), whose workers' launches must include fr_butterfly_stage (K5);
 12. the streamed prover (models/streamed.py; run after phase 8, and its
     key released before phase 9 stages its own): phase 4's key streamed
     at three chunks (3 * 2^17, the last padded) and at one must give phase
     4's resident proof byte for byte; a 2^22 synthetic known-dlog key (past
     what the resident prover holds) streamed at chunk 2^20 (four chunks)
     must give the host's A, B, C, and its h the plain witness map; its
     launches, stage times (median of 3 after the checked prove), each
     chunk's copy and compute time (CUDA events on the two streams), peak
     device memory beside phase 4's (at most 1.10 times it), and one
     profiled prove.
Phases 2-3 also hold the flat chain's stage kernel (2^10 to 2^13 and 2^20), the Fq
binary modes (2^20) and the K9 op chain against their plain versions: K9
on each op's edge operands at 2^16 elements with K = 64 and K = 5, at
2^16 - 37 and at 2^20 (its bound for the ops with no multiply at 128 word
operations an SM a clock, for the Montgomery products at 64); K1
and K9 with the profiler's device time, every op a mode of its row. Each
kernel's launches are counted on the path that
runs it (phase 4, 6 or 7, or 8 for K9), the counts set to 0 just before;
phases 9-15 count theirs the same way (launches_by_path on the kernels
line), and each must launch every kernel of its path.
The kernels line (JSON; the K6/K7 and K8 entries also carry ptxas's
registers and spill bytes per mode, the K3/K4 entries each mode's numbers
and each entry kernel's resources) and then the result line close the
output.
Exits non-zero, printing no result, when there is no CUDA device.
"""

import io
import json
import random
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

SEED = 20
LOG_N = 20
LOG_SMALL = 13  # phase 6: the largest domain of the flat chain
LOG_BIG = 22  # phase 12: past what the resident prover holds on an 80 GB card
K9_N, K9_K = 1 << 16, 64
POOL = 509  # distinct points (and discrete logs) of the synthetic key


def nvidia_smi(fields):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def timed(fn, reps):
    """(result, mean ms) of fn() over reps calls after two warm-up calls."""
    import torch

    out = fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def once_ms(fn):
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def device_ms(fn, reps, match):
    """Mean device time of fn() (one launch of a kernel whose name holds
    `match`) under torch.profiler, after a warm-up call: utils/trace's
    device_ms, the mean of the spans it recorded over up to five sessions
    of reps calls (a note when fewer than reps); None when it recorded
    none."""
    from circom_compat_tpu_torch.utils import trace

    fn()
    ms, spans = trace.device_ms(fn, reps, match)
    if spans < reps:
        print(f"    the profiler recorded {spans} {match} spans for {reps} launches")
    return ms


def proof_fold_levels(c: int, W: int, digits: int = 64) -> int:
    """K10's longest chain of dependent Fq multiplies for 254-bit scalars
    (64 digits of 4 bits): a G1 add or doubling is two levels, a G2 one
    three; a ladder is its table (7 doublings, 7 adds) and four doublings
    and an add a digit. G1: the longer of the folds and the delta1 ladders,
    two adds, the s A / r B1 ladders, two adds; G2: the longer of its fold
    and the delta2 ladder, two adds."""
    def ladder(level):
        return 14 * level + (digits - 1) * 5 * level

    g1 = max((W - 1) * (c + 1) * 2, ladder(2)) + 2 * 2 + ladder(2) + 2 * 2
    g2 = max((W - 1) * (c + 1) * 3, ladder(3)) + 2 * 3
    return max(g1, g2)


def max_abs_err(a, b, chunk=1 << 26):
    """Largest difference of two word tensors read as unsigned 32-bit words,
    in chunks so that the int64 copies stay small beside multi-GB inputs."""
    import torch

    fa, fb = a.reshape(-1), b.reshape(-1)
    if fa.shape != fb.shape:
        raise AssertionError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    err = 0
    for i in range(0, fa.numel(), chunk):
        ua = fa[i : i + chunk].to(torch.int64) & 0xFFFFFFFF
        ub = fb[i : i + chunk].to(torch.int64) & 0xFFFFFFFF
        err = max(err, int((ua - ub).abs().max().item()))
    return err


def sync_sites(fn):
    """(fn(), {file:line: count}) of the calls that synchronized a CUDA
    device while fn ran (torch.cuda.set_sync_debug_mode("warn"))."""
    import collections
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, dict(collections.Counter(
        f"{Path(w.filename).parent.name}/{Path(w.filename).name}:{w.lineno}" for w in caught
        if "called a synchronizing CUDA operation" in str(w.message)))


def profile_prove(fn, phase, label, top=12):
    """Runs fn() (one prove) once under torch.profiler with CUDA activity and
    prints the device kernels by total time and the device's idle share over
    the prove: 1 - (union of device activity) / (the prove's span)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("prove"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    window = next(e for e in events
                  if e.name == "prove" and e.device_type == torch.autograd.DeviceType.CPU).time_range
    # device activity: kernels, copies and sets (the "prove" range also shows
    # on the device timeline as an annotation, and is no activity)
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA and e.name != "prove"]
    if not device:
        print(f"[{phase}] profiled prove at {label}: the profiler recorded no device activity "
              "(idle share not measured)")
        return
    spans = sorted((max(e.time_range.start, window.start), min(e.time_range.end, window.end))
                   for e in device)
    busy, end = 0.0, window.start
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = window.end - window.start
    by_name = {}
    for e in device:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.end - e.time_range.start, count + 1)
    print(f"[{phase}] profiled prove at {label}: span {span / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms, device idle share {1 - busy / span:.4f}")
    for name, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[{phase}]   {total / 1e3:10.3f} ms  {count:5d} x  {name[:110]}")
    families = {}
    for name, (total, count) in by_name.items():
        fam = kernel_family(name)
        if fam:
            t, c = families.get(fam, (0.0, 0))
            families[fam] = (t + total, c + count)
    print(f"[{phase}] the port's kernel families at {label} (device ms, launches): " + json.dumps(
        {fam: [round(t / 1e3, 4), c] for fam, (t, c) in sorted(families.items(), key=lambda kv: -kv[1][0])}))


def kernel_family(name):
    """The family of one of the port's kernels in a profiler name, or None
    for other kernels: an entry kernel with a C name (ccf_point_add_g2_madd)
    gives its group's family (ccf_point_add_g2), a template kernel of
    csrc/field_kernels.cu (in an anonymous namespace) its function name."""
    import re

    m = re.search(r"\b(ccf_\w+?)(?:_madd|_add)?\b(?:\(|$)", name)
    if m:
        return m.group(1)
    if "anonymous namespace" in name:
        m = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
        return m.group(1) if m else None
    return None


def point_pools(rng):
    """POOL seeded scalars k_j with k_j * G1 and k_j * G2."""
    from circom_compat_tpu_torch.constants import R_SCALAR
    from circom_compat_tpu_torch.refmath import curve as rc

    ks = [rng.randrange(1, R_SCALAR) for _ in range(POOL)]
    return (ks, [rc.G1.mul(rc.g1_generator(), k) for k in ks],
            [rc.G2.mul(rc.g2_generator(), k) for k in ks])


def synthetic_key(k, rng, ks, g1_pool, g2_pool):
    """A proving key for the squaring chain with k constraints (domain
    k + 2) whose every point has a known discrete log: query row i of a
    section is k_((i + offset) mod POOL) times the generator, three rows
    per section are infinity, and alpha, beta, gamma, delta are seeded.
    Returns (host ProvingKey, the secrets)."""
    from circom_compat_tpu_torch.circom.zkey import G1Section, G2Section, ProvingKey, VerifyingKey
    from circom_compat_tpu_torch.constants import R_SCALAR
    from circom_compat_tpu_torch.ops import curve as cv
    from circom_compat_tpu_torch.refmath import curve as rc

    n_vars, n_pub, n = k + 2, 1, k + 2
    pools = {False: cv.encode_g1_affine(g1_pool).view(np.uint16).reshape(POOL, 2, 16),
             True: cv.encode_g2_affine(g2_pool).view(np.uint16).reshape(POOL, 4, 16)}
    offsets = {"a": 0, "b1": 101, "l": 202, "h": 303, "b2": 404}

    def section(name, length):
        idx = (np.arange(length) + offsets[name]) % POOL
        limbs = pools[name == "b2"][idx]
        dlogs = [ks[j] for j in idx.tolist()]
        for i in (5, 77, length - 3):
            limbs[i] = 0
            dlogs[i] = 0
        return limbs, dlogs

    secs = {name: section(name, length) for name, length in
            (("a", n_vars), ("b1", n_vars), ("b2", n_vars), ("l", n_vars - n_pub - 1), ("h", n))}
    alpha, beta, gamma, delta = (rng.randrange(1, R_SCALAR) for _ in range(4))
    G, G2 = rc.g1_generator(), rc.g2_generator()
    vk = VerifyingKey(alpha_g1=rc.G1.mul(G, alpha), beta_g2=rc.G2.mul(G2, beta),
                      gamma_g2=rc.G2.mul(G2, gamma), delta_g2=rc.G2.mul(G2, delta),
                      gamma_abc_g1=g1_pool[: n_pub + 1])
    pk = ProvingKey(vk=vk, beta_g1=rc.G1.mul(G, beta), delta_g1=rc.G1.mul(G, delta),
                    a_query=G1Section(secs["a"][0]), b_g1_query=G1Section(secs["b1"][0]),
                    b_g2_query=G2Section(secs["b2"][0]), h_query=G1Section(secs["h"][0]),
                    l_query=G1Section(secs["l"][0]), n_vars=n_vars, n_public=n_pub,
                    domain_size=n)
    secret = dict(alpha=alpha, beta=beta, delta=delta,
                  dlogs={name: sec[1] for name, sec in secs.items()})
    return pk, secret


def expected_proof(secret, asg, h_ints, r, s):
    """The proof as three scalar multiples of the generators:
    A = (alpha + sum a_i kA_i + r delta) G, B = (beta + sum a_i kB2_i + s delta) G2,
    C = (sum_aux a_i kL_i + sum h_i kH_i + s A' + r B1' - r s delta) G."""
    from circom_compat_tpu_torch.constants import R_SCALAR as R
    from circom_compat_tpu_torch.models.groth16 import Proof
    from circom_compat_tpu_torch.refmath import curve as rc

    a = [v % R for v in asg]
    dl = secret["dlogs"]

    def dot(xs, ds):
        return sum(x * d for x, d in zip(xs, ds)) % R

    alpha, beta, delta = secret["alpha"], secret["beta"], secret["delta"]
    a_sc = (alpha + dot(a, dl["a"]) + r * delta) % R
    b1_sc = (beta + dot(a, dl["b1"]) + s * delta) % R
    b2_sc = (beta + dot(a, dl["b2"]) + s * delta) % R
    c_sc = (dot(a[2:], dl["l"]) + dot(h_ints, dl["h"]) + s * a_sc + r * b1_sc
            - r * s * delta) % R
    return Proof(a=rc.G1.mul(rc.g1_generator(), a_sc), b=rc.G2.mul(rc.g2_generator(), b2_sc),
                 c=rc.G1.mul(rc.g1_generator(), c_sc))


def server_phase(dev, card, work, pk, rows, circuit, asg, rng, on_path, kernels):
    """[9] The prove server over `pk` (written with write_zkey) and the
    circuit's assignment (write_wtns): ping, three witness_file requests,
    one with fixed r/s equal to the direct prove byte for byte, ok: false
    for a malformed request, one more proof, shutdown; a served proof
    verified by pairing. Returns the server's zkey load seconds."""
    import torch

    from circom_compat_tpu_torch import cli
    from circom_compat_tpu_torch.circom.wtns import write_wtns
    from circom_compat_tpu_torch.circom.zkey import read_zkey
    from circom_compat_tpu_torch.circom.zkey_writer import write_zkey
    from circom_compat_tpu_torch.constants import R_SCALAR as R
    from circom_compat_tpu_torch.models.groth16 import Groth16
    from circom_compat_tpu_torch.server import ProveServer, request

    cuda = dev.type == "cuda"
    n = pk.n_vars
    zkey, wtns, sock = (str(Path(work) / f) for f in ("key.zkey", "asg.wtns", "p.sock"))
    t0 = time.perf_counter()
    write_zkey(zkey, pk, rows[0], rows[1], len(circuit.r1cs.constraints))
    zkey_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_wtns(asg, wtns)
    wtns_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    print(f"[9] zkey of n_vars {n} written in {zkey_s:.4f} s ({Path(zkey).stat().st_size} B), "
          f"wtns in {wtns_s:.4f} s; earlier staged keys released: "
          f"{torch.cuda.memory_allocated() if cuda else 'not measured'} device bytes allocated")
    server = ProveServer(zkey, device=dev)
    server.warmup()
    ready = threading.Event()
    serving = threading.Thread(target=server.serve, args=(sock,), kwargs={"ready_cb": ready.set},
                               daemon=True)  # a failed phase must not leave the process waiting
    serving.start()
    if not ready.wait(60):
        raise AssertionError("the prove server did not start")
    ping = request(sock, {"cmd": "ping"})
    if not (ping["ok"] and ping["compile_s"] is not None and ping["n_vars"] == n):
        raise AssertionError(f"bad ping: {ping}")
    r9, s9 = rng.randrange(R), rng.randrange(R)
    reqs = [{"witness_file": wtns}] * 3 + [{"witness_file": wtns, "r": str(r9), "s": str(s9)}]
    walls = []

    def serve_four():
        out = []
        for req in reqs:
            t1 = time.perf_counter()
            resp = request(sock, req)
            walls.append(time.perf_counter() - t1)
            if not resp["ok"]:
                raise AssertionError(f"the server refused a good request: {resp}")
            out.append(resp)
        return out

    served, launches = on_path("server", kernels, serve_four)
    print(f"[9] launches in the four requests: {json.dumps(launches)}")
    if request(sock, {"nonsense": 1})["ok"]:
        raise AssertionError("the server accepted a malformed request")
    after = request(sock, {"witness_file": wtns})
    if not after["ok"]:
        raise AssertionError(f"the server stopped serving after a bad request: {after}")
    served.append(after)
    if request(sock, {"cmd": "shutdown"}) != {"ok": True, "bye": True}:
        raise AssertionError("the server did not shut down")
    serving.join(60)
    if serving.is_alive():
        raise AssertionError("the server thread did not end")
    peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
    prove_s = [resp["prove_s"] for resp in served]
    load_s = server.load_s
    print(f"[9] ProveServer ({card}): load_s {server.load_s:.4f}, stage_s {server.stage_s:.4f}, "
          f"warm-up {server.compile_s:.4f} s; prove_s of {len(served)} requests {prove_s}, median "
          f"{statistics.median(prove_s):.4f} s; client round trips (s) "
          f"{[round(w, 4) for w in walls]}; peak device memory {peak} B; the witness_file path "
          "reads (N, 16) limbs (read_wtns_limbs), no Python ints")
    public = [int(v) for v in served[0]["public"]]
    if public != circuit.get_public_inputs() or any(r["public"] != served[0]["public"] for r in served):
        raise AssertionError("the server's public inputs are wrong")
    if not Groth16.verify_proof(pk.vk, cli._proof_from_json(served[0]["proof"]), public):
        raise AssertionError("a served proof does not verify")
    del server
    if cuda:
        torch.cuda.empty_cache()
    pk_r, m_r = read_zkey(zkey)
    direct = Groth16.create_proof_with_reduction_and_matrices(
        pk_r, r9, s9, m_r, m_r.num_instance_variables, m_r.num_constraints, asg, device=dev)
    if json.dumps(cli._proof_to_json(direct)) != json.dumps(served[3]["proof"]):
        raise AssertionError("the served fixed-r/s proof differs from the direct prove")
    print("[9] a served proof verifies by pairing; the fixed-r/s request equals "
          "Groth16.create_proof_with_reduction_and_matrices byte for byte; the server answered "
          "ok: false to a malformed request and then served one more proof")
    del pk_r, m_r, direct
    if cuda:
        torch.cuda.empty_cache()
    return load_s


def cli_phase(card, work, pk, rows, circuit, on_path):
    """[10] The CLI on its default device: prove, then prove --backend
    streamed under --timings (the stage table must hold prove.msm_stream,
    the proof must verify), export-vkey, verify (and a tampered public
    input), export-calldata against the ethereum.Proof tuple."""
    import contextlib

    from circom_compat_tpu_torch import cli
    from circom_compat_tpu_torch import ethereum as eth
    from circom_compat_tpu_torch.circom.wtns import write_wtns
    from circom_compat_tpu_torch.circom.zkey_writer import write_zkey
    from circom_compat_tpu_torch.constants import R_SCALAR as R

    f = {name: str(Path(work) / name) for name in
         ("small.zkey", "small.wtns", "proof.json", "public.json", "vk.json", "bad.json",
          "proof_s.json", "public_s.json")}
    write_zkey(f["small.zkey"], pk, rows[0], rows[1], len(circuit.r1cs.constraints))
    write_wtns(circuit.full_assignment(), f["small.wtns"])
    public = circuit.get_public_inputs()

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        return rc, out.getvalue()

    t0 = time.perf_counter()
    (rc, _), launches = on_path("cli", ["fr_butterfly_stage", "fr_binary", "fr_tile_scan",
                                        "ntt_rows_low", "point_add_g1", "point_add_g2",
                                        "tile_scan_g1", "tile_scan_g2"],
                                lambda: run(["prove", f["small.zkey"], f["small.wtns"],
                                             f["proof.json"], f["public.json"]]))
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError("the CLI prove failed")
    print(f"[10] CLI prove at domain {pk.domain_size}: {wall:.4f} s wall (zkey read, staging, "
          f"prove, JSON; {card}); launches: {json.dumps(launches)}")
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        (rc, _), launches = on_path("cli_streamed", ["fr_butterfly_stage", "fr_binary", "fr_tile_scan",
                                                     "ntt_rows_low", "point_add_g1", "point_add_g2",
                                                     "tile_scan_g1", "tile_scan_g2"],
                                    lambda: run(["--timings", "prove", f["small.zkey"], f["small.wtns"],
                                                 f["proof_s.json"], f["public_s.json"],
                                                 "--backend", "streamed"]))
    wall = time.perf_counter() - t0
    table = err.getvalue()
    if rc != 0 or "prove.msm_stream" not in table:
        raise AssertionError(f"the CLI streamed prove failed or printed no prove.msm_stream: {table}")
    print(f"[10] CLI prove --backend streamed --timings at domain {pk.domain_size}: {wall:.4f} s wall "
          f"({card}); launches: {json.dumps(launches)}; stage table: "
          + json.dumps(table.splitlines()[1:]))
    if run(["verify", f["small.zkey"], f["public_s.json"], f["proof_s.json"]]) != (0, "OK!\n"):
        raise AssertionError("the CLI's streamed proof does not verify")
    if run(["export-vkey", f["small.zkey"], f["vk.json"]])[0] != 0:
        raise AssertionError("export-vkey failed")
    if json.loads(Path(f["vk.json"]).read_text()) != cli._vk_to_json(pk.vk):
        raise AssertionError("export-vkey wrote another key")
    if run(["verify", f["vk.json"], f["public.json"], f["proof.json"]]) != (0, "OK!\n"):
        raise AssertionError("the CLI does not verify its own proof")
    Path(f["bad.json"]).write_text(json.dumps([str((public[0] + 1) % R)]))
    if run(["verify", f["vk.json"], f["bad.json"], f["proof.json"]])[0] != 1:
        raise AssertionError("the CLI verified a tampered public input")
    rc, line = run(["export-calldata", f["public.json"], f["proof.json"]])
    proof = cli._proof_from_json(json.loads(Path(f["proof.json"]).read_text()))
    (ax, ay), ((bx1, bx0), (by1, by0)), (cx, cy) = eth.Proof.from_ark(proof).as_tuple()
    words = [int(v, 16) for v in line.replace("[", "").replace("]", "").replace('"', "")
             .strip().split(",")]
    if rc != 0 or words != [ax, ay, bx1, bx0, by1, by0, cx, cy] + public:
        raise AssertionError("the calldata line is not the ethereum.Proof tuple")
    print("[10] verify returns 0 (1 for a tampered public input); export-vkey equals the key's vk; "
          "the export-calldata line equals the ethereum.Proof tuple and the public input")


def msm_phase(dev, card, ks, g1_pool, g2_pool, gen, on_path, n=1 << LOG_N):
    """[11] msm_g1 / msm_g2 over n points of known discrete logs (pool
    points, every 997th row infinity) and seeded canonical scalars: equal
    to (sum s_i k_i) G, then points/s, the median of 3 after that call."""
    import torch

    from circom_compat_tpu_torch.constants import R_SCALAR as R
    from circom_compat_tpu_torch.ops import curve as cv
    from circom_compat_tpu_torch.ops import limbs as lc
    from circom_compat_tpu_torch.ops import msm
    from circom_compat_tpu_torch.refmath import curve as rc

    for g2, pool in ((False, g1_pool), (True, g2_pool)):
        grp, base = (rc.G2, rc.g2_generator()) if g2 else (rc.G1, rc.g1_generator())
        tag = "g2" if g2 else "g1"
        pool_xy = torch.from_numpy(cv.encode_g2_affine(pool) if g2 else cv.encode_g1_affine(pool))
        idx = torch.randint(0, len(pool), (n,), device=dev, generator=gen)
        xy = pool_xy.to(dev)[idx]
        xy[::997] = 0
        sc = torch.randint(-2**31, 2**31, (n, 8), dtype=torch.int32, device=dev, generator=gen)
        sc[:, 7] = torch.remainder(sc[:, 7].to(torch.int64), 0x30644E72).to(torch.int32)  # < r
        dl = [ks[j] for j in idx.tolist()]
        for i in range(0, n, 997):
            dl[i] = 0
        total = sum(a * b for a, b in zip(lc.words_to_ints(sc.cpu().numpy()), dl)) % R
        fn = msm.msm_g2 if g2 else msm.msm_g1
        got, launches = on_path(f"msm_{tag}", [f"tile_scan_{tag}", f"point_add_{tag}"],
                                lambda: fn(xy, sc, device=dev))
        if got != grp.mul(base, total):
            raise AssertionError(f"msm_{tag} differs from the known-dlog sum")
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            fn(xy, sc, device=dev)
            times.append(time.perf_counter() - t1)
        med = statistics.median(times)
        print(f"[11] msm_{tag} of {n} points (window bits {msm.pick_window_bits(n)}; launches "
              f"{json.dumps(launches)}): equals the known-dlog sum; median {med:.4f} s of "
              f"{[round(t, 4) for t in times]}: {n / med:.1f} points/s ({card})")


def _g1_row(limbs, i):
    """Row i of a (n, 2, 16) zkey section as a canonical affine point."""
    from circom_compat_tpu_torch.constants import Q
    from circom_compat_tpu_torch.ops import limbs as lc

    x, y = (lc.limbs_to_int(c) for c in limbs[i])
    if x == 0 and y == 0:
        return None
    rinv = pow(1 << 256, -1, Q)
    return (x * rinv % Q, y * rinv % Q)


def ceremony_phase(dev, card, work, pk, rows, circuit, asg, r, s, wbits, small_circuit, rng,
                   on_path, samples=64):
    """[14] (a) One contribution (fixed entropy) to phase 7's card-made key:
    delta_g1 / delta_g2 equal the host's, `samples` L and H rows equal
    s^-1 P on the host, a proof under the contributed key verifies and the
    old vk refuses it; the rescale's seconds for L and H (trace stages), its
    launches and peak device memory. (b) small_circuit set up on the card
    with delta = 1, two contributions: write_zkey / read_zkey keep section
    10, verify_mpc_chain is True, and False for a tampered g1_sx and an
    unlinked delta; the CLI's contribute exits 0 and verify-chain 0 (1 on
    a tampered file)."""
    import contextlib
    import dataclasses

    import torch

    from circom_compat_tpu_torch import cli
    from circom_compat_tpu_torch.circom import contribute as tc
    from circom_compat_tpu_torch.circom.zkey import read_zkey, verify_mpc_chain
    from circom_compat_tpu_torch.circom.zkey_writer import write_zkey
    from circom_compat_tpu_torch.constants import R_SCALAR as R
    from circom_compat_tpu_torch.models import generate_parameters_from_matrices
    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.models.groth16 import Groth16
    from circom_compat_tpu_torch.refmath import curve as rc
    from circom_compat_tpu_torch.utils import trace

    cuda = dev.type == "cuda"
    entropy = b"chip_smoke ceremony"
    secret = tc.derive_secret(entropy)
    s_inv = pow(secret, -1, R)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with trace.collect() as tr:
        t0 = time.perf_counter()
        new, launches = on_path(f"ceremony_{pk.domain_size}", ["point_add_g1", "f_binary_fq"],
                                lambda: tc.contribute(pk, entropy=entropy, name="chip", device=dev))
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
    st = tr.as_dict()
    print(f"[14] (a) contribute at domain {pk.domain_size} (L {len(pk.l_query)}, H "
          f"{len(pk.h_query)} rows): {wall:.4f} s wall; rescale L {st['contribute.l_query']:.4f} s, "
          f"H {st['contribute.h_query']:.4f} s ({card}); launches {json.dumps(launches)}; peak "
          f"device memory {peak} B")
    if new.delta_g1 != rc.G1.mul(pk.delta_g1, secret) or \
            new.vk.delta_g2 != rc.G2.mul(pk.vk.delta_g2, secret):
        raise AssertionError("the contributed delta differs from the host's")
    for name in ("l_query", "h_query"):
        old_sec, new_sec = getattr(pk, name).limbs, getattr(new, name).limbs
        idx = sorted({0, len(old_sec) - 1} | {rng.randrange(len(old_sec)) for _ in range(samples - 2)})
        for i in idx:
            if _g1_row(new_sec, i) != rc.G1.mul(_g1_row(old_sec, i), s_inv):
                raise AssertionError(f"{name} row {i} is not s^-1 P")
    dpk = gd.DeviceProvingKey.from_matrix_rows(new, rows[0], rows[1], circuit.r1cs.num_inputs,
                                               len(circuit.r1cs.constraints), device=dev)
    proof = gd.prove_prepared(dpk, r, s, asg, wbits)
    del dpk
    if cuda:
        torch.cuda.empty_cache()
    public = circuit.get_public_inputs()
    if not Groth16.verify_proof(new.vk, proof, public) or Groth16.verify_proof(pk.vk, proof, public):
        raise AssertionError("the proof under the contributed key does not verify, or the old vk "
                             "accepts it")
    print(f"[14] (a) delta_g1 and delta_g2 equal the host's; {samples} sampled L and H rows each "
          "equal s^-1 P; a proof under the contributed key verifies by pairing and the old vk "
          "refuses it")

    # (b) the chain from a delta-one key at the small circuit's domain
    rows_s = small_circuit.to_matrices()
    key = generate_parameters_from_matrices(
        *rows_s, small_circuit.r1cs.num_inputs, small_circuit.r1cs.num_variables, device=dev,
        alpha=rng.randrange(1, R), beta=rng.randrange(1, R), gamma=rng.randrange(1, R), delta=1,
        t=rng.randrange(1, R))

    def two():
        k = key
        for ent, name in ((b"first", "alice"), (b"second", "bob")):
            k = tc.contribute(k, entropy=ent, name=name, device=dev)
        return k

    t0 = time.perf_counter()
    chain, launches = on_path(f"ceremony_chain_{key.domain_size}", ["point_add_g1", "f_binary_fq"], two)
    wall = time.perf_counter() - t0
    nc = len(small_circuit.r1cs.constraints)
    buf = io.BytesIO()
    write_zkey(buf, chain, rows_s[0], rows_s[1], nc)
    buf.seek(0)
    back, _ = read_zkey(buf)
    if dataclasses.asdict(back.mpc) != dataclasses.asdict(chain.mpc) or len(back.mpc.contributions) != 2:
        raise AssertionError("write_zkey / read_zkey lost section 10")
    if not verify_mpc_chain(back):
        raise AssertionError("verify_mpc_chain refused a delta-one chain")
    first = dataclasses.replace(back.mpc.contributions[0], g1_sx=back.delta_g1)
    tampered = dataclasses.replace(back, mpc=dataclasses.replace(
        back.mpc, contributions=[first, back.mpc.contributions[1]]))
    g1_s = rc.G1.mul(rc.g1_generator(), 7)
    forged = dataclasses.replace(back.mpc.contributions[1], g1_s=g1_s, g1_sx=rc.G1.mul(g1_s, 0xF00D),
                                 g2_spx=rc.G2.mul(rc.g2_generator(), 0xF00D))
    unlinked = dataclasses.replace(back, mpc=dataclasses.replace(
        back.mpc, contributions=[back.mpc.contributions[0], forged]))
    if verify_mpc_chain(tampered) or verify_mpc_chain(unlinked):
        raise AssertionError("verify_mpc_chain accepted a tampered or unlinked chain")
    print(f"[14] (b) two contributions at domain {key.domain_size} from a delta-one card setup: "
          f"{wall:.4f} s ({card}); launches {json.dumps(launches)}; section 10 survives "
          "write_zkey / read_zkey; the chain verifies, a tampered g1_sx and an unlinked delta do not")

    f = {n: str(Path(work) / n) for n in ("c0.zkey", "c1.zkey", "bad.zkey")}
    write_zkey(f["c0.zkey"], key, rows_s[0], rows_s[1], nc)
    write_zkey(f["bad.zkey"], tampered, rows_s[0], rows_s[1], nc)

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = cli.main(argv)
        return code, out.getvalue()

    (code, _), launches = on_path("cli_contribute", ["point_add_g1", "f_binary_fq"], lambda: run(
        ["contribute", f["c0.zkey"], f["c1.zkey"], "--name", "carol", "--entropy", "chip",
         *([] if cuda else ["--device", "cpu"])]))
    if code != 0 or run(["verify-chain", f["c1.zkey"]])[0] != 0:
        raise AssertionError("the CLI's contribute or verify-chain failed")
    if run(["verify-chain", f["bad.zkey"]]) != (1, "2 contribution(s): chain INVALID\n"):
        raise AssertionError("the CLI's verify-chain accepted a tampered chain")
    print(f"[14] (b) CLI: contribute exits 0 (on the card by default; launches "
          f"{json.dumps(launches)}), verify-chain 0, and 1 on the tampered file")


def transforms_phase(dev, card, gen, on_path, logs=(LOG_N, LOG_SMALL, 9), points=16):
    """[14] (c) ops/ntt fft, ifft and coset_shift at each 2^log: equal to
    their plain versions on the card mod r, ifft(fft(x)) = x, fft equal to
    a host Horner evaluation at `points` sampled powers of the root; the
    time (CUDA events) and launches of each."""
    import torch

    from circom_compat_tpu_torch.constants import R_SCALAR as R
    from circom_compat_tpu_torch.constants import fr_root_of_unity
    from circom_compat_tpu_torch.ops import field_kernels as fk
    from circom_compat_tpu_torch.ops import limbs as lc
    from circom_compat_tpu_torch.ops import ntt

    for log in logs:
        n = 1 << log
        plan = ntt.NTTPlan(n)  # its own plan: get_plan's cache keeps the prove's
        x = torch.randint(-2**31, 2**31, (n, 8), dtype=torch.int32, device=dev, generator=gen)
        x[:, 7] = torch.remainder(x[:, 7].to(torch.int64), 0x30644E72).to(torch.int32)  # < r
        x[:2] = 0
        x[1, 0] = 1
        flat = plan.chain == "flat"  # K5 + K3, the inverse's 1/n a K1 pass; else two K3
        rows = ["fr_butterfly_stage", "ntt_rows_low"] if flat else ["ntt_rows_low"]
        names = {"fft": rows, "ifft": rows + ["fr_binary"] * flat, "coset_shift": ["fr_binary"]}
        shown, outs = {}, {}
        for name in ("fft", "ifft", "coset_shift"):
            fn = getattr(ntt, name)
            got, launches = on_path(f"{name}_2^{log}", names[name], lambda: fn(plan, x))
            want = fn(plan, x, ops=fk.PLAIN)
            if max_abs_err(fk.fr_from_mont(got), fk.fr_from_mont(want)) != 0:
                raise AssertionError(f"{name} at 2^{log} differs from its plain version mod r")
            ms = timed(lambda: fn(plan, x), 10)[1] if dev.type == "cuda" else None
            shown[name] = dict(ms=ms, launches=launches, chain=plan.chain,
                               words_equal=max_abs_err(got, want) == 0)
            outs[name] = got
        back = ntt.ifft(plan, outs["fft"])
        if max_abs_err(fk.fr_from_mont(back), fk.fr_from_mont(x)) != 0:
            raise AssertionError(f"ifft(fft(x)) != x at 2^{log}")
        coeffs = lc.words_to_ints(fk.fr_from_mont(x).cpu().numpy())
        evals = lc.words_to_ints(fk.fr_from_mont(outs["fft"]).cpu().numpy())
        w = fr_root_of_unity(n)
        picks = torch.randint(0, n, (points - 2,), generator=torch.Generator().manual_seed(log))
        ks = sorted({0, n - 1} | set(picks.tolist()))
        pts = [pow(w, k, R) for k in ks]
        acc = [0] * len(pts)
        for c in reversed(coeffs):
            acc = [(a * p + c) % R for a, p in zip(acc, pts)]
        if acc != [evals[k] for k in ks]:
            raise AssertionError(f"fft at 2^{log} differs from the host's Horner evaluation")
        print(f"[14] (c) transforms at 2^{log} ({plan.chain} chain; {card}): equal to the plain "
              f"versions mod r, ifft(fft(x)) = x, fft equal to Horner at {len(ks)} points; "
              + json.dumps(shown))
        plan.release()


def h_scalars_phase(dev, card, rng, on_path, log_n=LOG_N):
    """[14] (d) the iFFT H scalars at the 2^log_n domain (the iFFT at
    2^(log_n + 1)) word for word against the closed form, with the time of
    each."""
    import torch

    from circom_compat_tpu_torch.constants import R_SCALAR as R
    from circom_compat_tpu_torch.models import setup as ts
    from circom_compat_tpu_torch.ops import ntt

    n = 1 << log_n
    t, d = rng.randrange(2, R), rng.randrange(1, R)
    t0 = time.perf_counter()
    closed = ts._h_scalar_words(n, t, d, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    closed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    via_ifft, launches = on_path(f"h_scalars_ifft_2^{log_n}", ["ntt_rows_low", "fr_binary"],
                                 lambda: ts._h_scalar_words_ifft(n, t, d, dev))
    ifft_s = time.perf_counter() - t0
    if max_abs_err(via_ifft, closed) != 0:
        raise AssertionError("the iFFT H scalars differ from the closed form")
    ntt.get_plan(2 * n).release()
    print(f"[14] (d) H scalars at domain 2^{log_n}: the iFFT route (host powers, ifft at "
          f"2^{log_n + 1}; launches {json.dumps(launches)}) equals the closed form word for word; "
          f"iFFT route {ifft_s:.4f} s (host tables and powers included), closed form "
          f"{closed_s:.4f} s ({card})")


def signed_msm_phase(dev, card, ks, g1_pool, g2_pool, gen, on_path, n=1 << LOG_N):
    """[14] (e) msm_g1 / msm_g2 with signed=True at n points of known
    discrete logs (as phase 11): equal to the unsigned result and to
    (sum s_i k_i) G; points/s signed and unsigned side by side (a record,
    not a claim)."""
    import torch

    from circom_compat_tpu_torch.constants import R_SCALAR as R
    from circom_compat_tpu_torch.ops import curve as cv
    from circom_compat_tpu_torch.ops import limbs as lc
    from circom_compat_tpu_torch.ops import msm
    from circom_compat_tpu_torch.refmath import curve as rc

    for g2, pool in ((False, g1_pool), (True, g2_pool)):
        grp, base = (rc.G2, rc.g2_generator()) if g2 else (rc.G1, rc.g1_generator())
        tag = "g2" if g2 else "g1"
        pool_xy = torch.from_numpy(cv.encode_g2_affine(pool) if g2 else cv.encode_g1_affine(pool))
        idx = torch.randint(0, len(pool), (n,), device=dev, generator=gen)
        xy = pool_xy.to(dev)[idx]
        xy[::997] = 0
        sc = torch.randint(-2**31, 2**31, (n, 8), dtype=torch.int32, device=dev, generator=gen)
        sc[:, 7] = torch.remainder(sc[:, 7].to(torch.int64), 0x30644E72).to(torch.int32)  # < r
        dl = [ks[j] for j in idx.tolist()]
        for i in range(0, n, 997):
            dl[i] = 0
        total = sum(a * b for a, b in zip(lc.words_to_ints(sc.cpu().numpy()), dl)) % R
        fn = msm.msm_g2 if g2 else msm.msm_g1
        got, launches = on_path(f"msm_{tag}_signed", [f"tile_scan_{tag}", f"point_add_{tag}",
                                                      "f_binary_fq"],
                                lambda: fn(xy, sc, device=dev, signed=True))
        unsigned = fn(xy, sc, device=dev)
        if got != unsigned or got != grp.mul(base, total):
            raise AssertionError(f"signed msm_{tag} differs from the unsigned one or the known-dlog sum")
        rates = {}
        for signed in (True, False):
            times = []
            for _ in range(3):
                t1 = time.perf_counter()
                fn(xy, sc, device=dev, signed=signed)
                times.append(time.perf_counter() - t1)
            med = statistics.median(times)
            rates["signed" if signed else "unsigned"] = dict(median_s=round(med, 4),
                                                             points_per_s=round(n / med, 1))
        print(f"[14] (e) msm_{tag} signed at {n} points (window bits {msm.pick_window_bits(n)}, "
              f"{msm.bucket_count(msm.pick_window_bits(n), True)} buckets a window against "
              f"{msm.bucket_count(msm.pick_window_bits(n))}; launches {json.dumps(launches)}): equals "
              f"the unsigned result and the known-dlog sum; {json.dumps(rates)} ({card})")


def _pairing_input(proof, vk, public):
    """The ecPairing input of the Groth16 verifier contract: e(-A, B)
    e(alpha, beta) e(vk_x, gamma) e(C, delta)."""
    from circom_compat_tpu_torch.refmath import curve as rc

    vk_x = vk.gamma_abc_g1[0]
    for x, ic in zip(public, vk.gamma_abc_g1[1:]):
        vk_x = rc.G1.add(vk_x, rc.G1.mul(ic, x))
    words = []
    for p1, p2 in ((rc.G1.neg(proof.a), proof.b), (vk.alpha_g1, vk.beta_g2), (vk_x, vk.gamma_g2),
                   (proof.c, vk.delta_g2)):
        (x0, x1), (y0, y1) = p2
        words += [*p1, x1, x0, y1, y0]
    return b"".join(v.to_bytes(32, "big") for v in words)


def evm_phase(work, vk, proof, public):
    """[14] (f) evm.py: the keccak vectors; ecPairing on the proof and vk as
    the verifier contract feeds it (true; false with A not negated); the
    CLI's verify-onchain without the verifier artifact raises
    FileNotFoundError, as the JAX CLI does."""
    from circom_compat_tpu_torch import cli, evm
    from circom_compat_tpu_torch.models.groth16 import Proof
    from circom_compat_tpu_torch.refmath import curve as rc

    vectors = {b"": "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470",
               b"abc": "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"}
    if any(evm.keccak256(m).hex() != h for m, h in vectors.items()):
        raise AssertionError("keccak256 vectors")
    one, zero = (1).to_bytes(32, "big"), bytes(32)
    t0 = time.perf_counter()
    if evm._pre_ecpairing(_pairing_input(proof, vk, public)) != (True, one):
        raise AssertionError("ecPairing refused the proof")
    pairing_s = time.perf_counter() - t0
    bad = Proof(a=rc.G1.neg(proof.a), b=proof.b, c=proof.c)
    if evm._pre_ecpairing(_pairing_input(bad, vk, public)) != (True, zero):
        raise AssertionError("ecPairing accepted a tampered proof")
    f = {n: str(Path(work) / n) for n in ("vk.json", "public.json", "proof.json")}
    Path(f["vk.json"]).write_text(json.dumps(cli._vk_to_json(vk)))
    Path(f["public.json"]).write_text(json.dumps([str(v) for v in public]))
    Path(f["proof.json"]).write_text(json.dumps(cli._proof_to_json(proof)))
    try:
        cli.main(["verify-onchain", f["vk.json"], f["public.json"], f["proof.json"]])
    except FileNotFoundError as exc:
        missing = exc.filename
    else:
        raise AssertionError("verify-onchain ran without the verifier artifact")
    print(f"[14] (f) keccak256 vectors; ecPairing on the proof as the verifier contract feeds it: "
          f"true ({pairing_s:.4f} s on the host), false for A not negated; verify-onchain without "
          f"the artifact raises FileNotFoundError ({missing}), as the JAX CLI does")


STREAMED_KERNELS = ["fr_binary", "fr_tile_scan", "ntt_rows_low", "ntt_rows_mid", "point_add_g1",
                    "point_add_g2", "tile_scan_g1", "tile_scan_g2"]
SHARDED_KERNELS = STREAMED_KERNELS  # K1, K2, K3/K4, K6/K7 and K8


def streamed_phase(dev, card, pk, matrices, resident, asg, r, s, rng, ks, g1_pool, g2_pool,
                   on_path, resident_peak, log_n=LOG_N, log_big=LOG_BIG, big_chunk=1 << 20):
    """[12] The streamed prover (models/streamed.py). (a) Phase 4's key,
    assignment and r/s at chunk 3 * 2^(log_n - 3) (three chunks, the last
    padded) and at chunk 2^log_n (one): each proof equals phase 4's
    resident proof byte for byte. (b) A 2^log_big synthetic known-dlog key
    at chunk big_chunk: the proof equals the host's A, B, C and h the plain
    witness map on the device; the launches (every kernel of the path),
    the stage times (median of 3 after the checked prove), each chunk's
    copy and compute time, the peak device memory beside phase 4's (at
    most 1.10 times it), one profiled prove. The key and its plan's tables
    are released after."""
    import torch

    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.models import streamed as sm
    from circom_compat_tpu_torch.ops import field_kernels as fk
    from circom_compat_tpu_torch.ops import limbs as lc
    from circom_compat_tpu_torch.ops import ntt
    from circom_compat_tpu_torch.utils import trace
    from circom_compat_tpu_torch.utils.chain import chain_matrices, chain_witness

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    spk = sm.StreamedProvingKey.build(pk, matrices, matrices.num_constraints, device=dev)
    for chunk in (3 << (log_n - 3), 1 << log_n):
        spk.chunk_points = chunk
        t0 = time.perf_counter()
        got = sm.prove_streamed(spk, r, s, asg)
        wall = time.perf_counter() - t0
        if got != resident:
            raise AssertionError(f"the streamed proof at chunk {chunk} differs from the resident one")
        print(f"[12] 2^{log_n} streamed at chunk {chunk} ({len(sm.LAST_CHUNK_MS)} chunks on the "
              f"card): equals phase 4's resident proof byte for byte; {wall:.4f} s (first prove "
              f"at this chunk; {card})")
    del spk

    k = (1 << log_big) - 2
    t0 = time.perf_counter()
    big_pk, secret = synthetic_key(k, rng, ks, g1_pool, g2_pool)
    asg_big = chain_witness(k, a=3)
    spk = sm.StreamedProvingKey.build(big_pk, chain_matrices(k), k, 2, chunk_points=big_chunk,
                                      device=dev)
    host_bytes = sum(x.nbytes for x in (*spk.g1_sections, spk.g2_section))
    print(f"[12] 2^{log_big} synthetic key in {time.perf_counter() - t0:.3f} s (host sections "
          f"{host_bytes} B; matrices and NTT tables on the device; chunk {big_chunk})")
    proof, launches = on_path(f"streamed_2^{log_big}", STREAMED_KERNELS,
                              lambda: sm.prove_streamed(spk, r, s, asg_big))
    peak = sm.LAST_PEAK_DEVICE_BYTES
    print(f"[12] launches in one 2^{log_big} streamed prove: {json.dumps(launches)}")
    walls, stages = [], []
    for _ in range(3):
        with trace.collect() as tr:
            t1 = time.perf_counter()
            again = sm.prove_streamed(spk, r, s, asg_big)
            walls.append(time.perf_counter() - t1)
        stages.append(tr.as_dict())
        if again != proof:
            raise AssertionError("a repeated streamed prove gave another proof")
    print(f"[12] streamed prove at 2^{log_big}: median {statistics.median(walls):.4f} s of "
          f"{[round(w, 4) for w in walls]} ({card}); stages (median s): " + json.dumps(
              {k2: round(statistics.median(x[k2] for x in stages), 4) for k2 in stages[0]}))
    print(f"[12] chunks of the last prove (copy ms, compute ms; CUDA events on the copy and the "
          f"compute stream): {json.dumps([[round(c, 3), round(m, 3)] for c, m in sm.LAST_CHUNK_MS])}")
    if cuda:
        print(f"[12] peak device memory of the 2^{log_big} streamed prove {peak} B = "
              f"{peak / resident_peak:.4f} x phase 4's resident 2^{LOG_N} peak {resident_peak} B")
        if peak > 1.10 * resident_peak:  # the chunk, not the key, sets the working set
            raise AssertionError(f"the 2^{log_big} streamed prove's peak exceeds 1.10 x phase 4's")
        profile_prove(lambda: sm.prove_streamed(spk, r, s, asg_big), 12, f"2^{log_big} streamed")

    one = torch.tensor(lc.ints_to_words([1])[0], device=dev)
    asg_mont = fk.fr_to_mont(torch.from_numpy(gd.encode_assignment(asg_big)).to(dev))
    h = fk.fr_from_mont(spk.matrices.witness_map(asg_mont))
    h_plain = fk.fr_binary_plain("mul_canon",
                                 spk.matrices.witness_map(asg_mont, ops=fk.PLAIN), one)
    if max_abs_err(h, h_plain) != 0:
        raise AssertionError(f"the 2^{log_big} witness map differs from its plain version")
    h_ints = lc.words_to_ints(h.cpu().numpy())
    del asg_mont, h, h_plain
    if proof != expected_proof(secret, asg_big, h_ints, r, s):
        raise AssertionError(f"the 2^{log_big} streamed proof differs from the host's known-dlog A, B, C")
    print(f"[12] the 2^{log_big} streamed proof equals the host's known-dlog A, B, C; h equals the "
          "plain witness map")
    del spk
    ntt.get_plan(1 << log_big).release()
    if cuda:
        torch.cuda.empty_cache()
    print(f"[12] phase wall {time.perf_counter() - t_phase:.1f} s")


SHARDS = 4  # phase 13's mesh: four shards, on one card (repeated) and over the cards in turn


def sharded_phase(dev, card, dpk, matrices, resident, asg, r, s, g1_pool, gen, on_path,
                  record_launches, check, mad, resident_peak, log_n=LOG_N,
                  dryrun_k=(1 << LOG_SMALL) - 2, reps=3):
    """[13] The multi-device provers (parallel/) on phase 4's key, assignment
    and r/s, over a mesh of SHARDS entries that repeat the card (and over
    the machine's cards in turn where it has two or more): (a) build_sharded_prover with
    dist_ntt on and off, each proof equal to phase 4's resident proof byte for
    byte, with medians of 3, stages, peak device memory and launches, one
    profiled prove; ntt_rows held against its plain version at the
    distributed witness map's shapes; (b) the sharded witness map's h equal to
    its plain version word for word and to the resident witness map's under
    td_perm; (c) msm_g1_sharded at 2^log_n equal to msm_g1; (d)
    prove_streamed_sharded at chunk 3 * 2^(log_n - 3) equal to the resident
    proof, each part's copy and compute time; (e) the CLI's dist-dryrun with
    two gloo processes of two shards sharing the card at a 2^13 domain, whose
    worker proofs must agree with each other and the single-process prove."""
    import torch

    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.models import streamed as sm
    from circom_compat_tpu_torch.ops import curve as cv
    from circom_compat_tpu_torch.ops import field_kernels as fk
    from circom_compat_tpu_torch.ops import limbs as lc
    from circom_compat_tpu_torch.ops import msm
    from circom_compat_tpu_torch.parallel import mesh as pm
    from circom_compat_tpu_torch.parallel import msm_sharded as ms
    from circom_compat_tpu_torch.parallel import ntt_sharded as ns
    from circom_compat_tpu_torch.parallel import prove_sharded as ps
    from circom_compat_tpu_torch.parallel import streamed_sharded as ss
    from circom_compat_tpu_torch.utils import trace

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    here = torch.device("cuda", torch.cuda.current_device()) if cuda else dev
    meshes = {"one card x4": pm.make_mesh(devices=[here] * SHARDS)}
    cards = torch.cuda.device_count() if cuda else 0
    if cards >= 2:  # the shards over the cards in turn: cuda:0..3 on four, 0, 1, 0, 1 on two
        meshes["distinct cards"] = pm.make_mesh(
            devices=[torch.device("cuda", i % cards) for i in range(SHARDS)])
    else:
        print(f"[13] distinct cards: not run (the machine has {cards} card(s)); the times below "
              "run four shards one after another on one card: the sharded code path, not a "
              "speed-up")
    phys = [d for d in dict.fromkeys(str(d) for m in meshes.values() for d in m.devices)
            if torch.device(d).type == "cuda"]

    def peaks_since(base):
        return {d: [torch.cuda.max_memory_allocated(d), torch.cuda.max_memory_allocated(d) - base[d]]
                for d in phys}

    def reset_peaks():
        if cuda:
            torch.cuda.empty_cache()
            for d in phys:
                torch.cuda.reset_peak_memory_stats(d)
        return {d: torch.cuda.memory_allocated(d) for d in phys}

    # (a) the sharded prove, dist_ntt on and off
    for label, mesh in meshes.items():
        for dist_ntt in (True, False):
            name = f"{'dist_ntt' if dist_ntt else 'replicated'}, {label}"
            base = reset_peaks()
            t0 = time.perf_counter()
            prover = ps.build_sharded_prover(dpk, mesh, dist_ntt=dist_ntt)
            build_s = time.perf_counter() - t0
            got, launches = on_path(f"sharded {name}", SHARDED_KERNELS,
                                    lambda: ps.prove_sharded(dpk, prover, r, s, asg))
            if got != resident:
                raise AssertionError(f"the sharded proof ({name}) differs from the resident one")
            walls, stages = [], []
            for _ in range(reps):
                st = {}
                t1 = time.perf_counter()
                again = ps.prove_sharded(dpk, prover, r, s, asg, stage_times=st)
                walls.append(time.perf_counter() - t1)
                stages.append(st)
                if again != resident:
                    raise AssertionError(f"a repeated sharded prove ({name}) gave another proof")
            print(f"[13] (a) sharded prove at 2^{log_n} over {SHARDS} shards ({name}; devices "
                  f"{mesh.physical()}; window bits {prover.window_bits}): equals phase 4's resident "
                  f"proof byte for byte; build {build_s:.3f} s; median {statistics.median(walls):.4f} s "
                  f"of {[round(w, 4) for w in walls]} ({card}); stages (median s): " + json.dumps(
                      {k: round(statistics.median(x[k] for x in stages), 4) for k in stages[0]}))
            if cuda:
                print(f"[13] (a) {name}: peak device memory [bytes, bytes above the {base} allocated "
                      f"before the build] {json.dumps(peaks_since(base))}, phase 4's resident peak "
                      f"{resident_peak} B")
            print(f"[13] (a) {name}: launches in one prove {json.dumps(launches)}")
            if cuda:
                again, sites = sync_sites(lambda: ps.prove_sharded(dpk, prover, r, s, asg))
                if again != resident:
                    raise AssertionError(f"the sharded proof ({name}) under sync debugging differs")
                print(f"[13] (a) {name}: calls that synchronized a card in one prove (file:line: "
                      f"count; encode's host copies and the readback are expected): {json.dumps(sites)}")
            if cuda and label == "one card x4":
                profile_prove(lambda: ps.prove_sharded(dpk, prover, r, s, asg), 13, f"sharded {name}")
            del prover
    reset_peaks()

    # ntt_rows at the distributed witness map's shapes: shard 0's rows of four
    plan = ns.get_dist_plan(dpk.domain_size, SHARDS)
    mesh = meshes["one card x4"]
    tab = plan.shard_tables(mesh.devices, chain=True)[0]
    rows, L = plan.n2 // SHARDS, plan.n1
    cnt = rows * L

    def lazy(count):
        x = torch.randint(-2**31, 2**31, (count, 8), dtype=torch.int32, device=dev, generator=gen)
        x[:, 7] = torch.remainder(x[:, 7].to(torch.int64), 0x60C89CE5).to(torch.int32)
        return x.reshape(rows, L, 8)

    x, other = lazy(cnt), lazy(cnt)
    muls = rows * ((L // 2) * (L.bit_length() - 1) - (L - 1))  # butterflies whose twiddle is not one
    FP = "circom_compat_tpu/ops/field_pallas.py"
    FSRC = "circom_compat_tpu_torch/csrc/field_kernels.cu"
    shape = f"{rows} rows of {L}, one shard of {SHARDS} at 2^{log_n}"
    mid_kw = dict(pre=tab["twi"], tw_dif=tab["tw1_inv"], mid=tab["coset"], tw_dit=tab["tw1_fwd"],
                  post=tab["twf"])
    check("ntt_rows_mid", lambda: fk.ntt_rows(x, **mid_kw), lambda: fk.ntt_rows_plain(x, **mid_kw),
          10, 160 * cnt, mad * (2 * muls + 3 * cnt), f"{FP}:432", FSRC,
          f" dist middle: twiddle pre, DIF, coset mid, DIT, twiddle post ({shape})")
    check("ntt_rows_low", lambda: fk.ntt_rows(x, tw_dif=tab["tw2_inv"], pre=other),
          lambda: fk.ntt_rows_plain(x, tw_dif=tab["tw2_inv"], pre=other),
          10, 96 * cnt, mad * (muls + cnt), f"{FP}:387", FSRC, f" dist DIF + pre ({shape})")
    check("ntt_rows_low", lambda: fk.ntt_rows(x, tw_dit=tab["tw2_fwd"], post=other, post_op="sub"),
          lambda: fk.ntt_rows_plain(x, tw_dit=tab["tw2_fwd"], post=other, post_op="sub"),
          10, 96 * cnt, mad * muls, f"{FP}:387", FSRC, f" dist DIT + post sub ({shape})")
    del x, other

    # (b) the sharded witness map against its plain version and the resident one
    coo = ps._td_coo(dpk, plan, SHARDS)
    wm = ns.make_sharded_witness_map(plan, mesh, *coo)
    wm_plain = ns.make_sharded_witness_map(plan, mesh, *coo, ops=fk.PLAIN)
    asg_mont = fk.fr_to_mont(torch.from_numpy(gd.encode_assignment(asg)).to(dev))
    one = torch.tensor(lc.ints_to_words([1])[0], device=dev)
    h_sh = torch.cat([fk.fr_from_mont(b) for b in wm(asg_mont)])
    h_sh_plain = torch.cat([fk.fr_binary_plain("mul_canon", b, one) for b in wm_plain(asg_mont)])
    if max_abs_err(h_sh, h_sh_plain) != 0:
        raise AssertionError("the sharded witness map differs from its plain version")
    h_res = fk.fr_from_mont(dpk.matrices.witness_map(asg_mont))
    td = torch.from_numpy(plan.td_perm.astype(np.int64)).to(dev)
    if max_abs_err(h_sh[td], h_res) != 0:
        raise AssertionError("the sharded witness map's h differs from the resident one under td_perm")
    wm_ms, res_ms = (timed(fn, 5)[1] if cuda else None for fn in
                     (lambda: wm(asg_mont), lambda: dpk.matrices.witness_map(asg_mont)))
    print(f"[13] (b) the sharded witness map at 2^{log_n} over {SHARDS} shards (n1 {plan.n1}, n2 "
          f"{plan.n2}) equals its plain version word for word and the resident witness map under "
          f"td_perm (canonical); CUDA events, mean of 5: sharded {wm_ms} ms, resident {res_ms} ms "
          f"({card})")
    del wm, wm_plain, coo, asg_mont, h_sh, h_sh_plain, h_res, td
    plan.release()

    # (c) msm_g1_sharded against msm_g1
    n = 1 << log_n
    pool_xy = torch.from_numpy(cv.encode_g1_affine(g1_pool)).to(dev)
    xy = pool_xy[torch.randint(0, len(g1_pool), (n,), device=dev, generator=gen)]
    xy[::997] = 0
    sc = torch.randint(-2**31, 2**31, (n, 8), dtype=torch.int32, device=dev, generator=gen)
    sc[:, 7] = torch.remainder(sc[:, 7].to(torch.int64), 0x30644E72).to(torch.int32)  # < r
    wb = msm.pick_window_bits(n // SHARDS)
    t0 = time.perf_counter()
    want = msm.msm_g1(xy, sc, device=dev)
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, launches = on_path("msm_g1_sharded", ["tile_scan_g1", "point_add_g1"],
                            lambda: ms.msm_g1_sharded(xy, sc, mesh, window_bits=wb))
    sharded_s = time.perf_counter() - t0
    if got != want:
        raise AssertionError("msm_g1_sharded differs from msm_g1")
    print(f"[13] (c) msm_g1_sharded of {n} points over {SHARDS} shards (window bits {wb}) equals "
          f"msm_g1: {sharded_s:.4f} s against {single_s:.4f} s (first calls, {card}); launches "
          f"{json.dumps(launches)}")
    del xy, sc, pool_xy

    # (d) the streamed prove over the mesh
    chunk = 3 << (log_n - 3)
    spk = sm.StreamedProvingKey.build(dpk.pk, matrices, matrices.num_constraints,
                                      chunk_points=chunk, device=dev)
    for label, mesh_d in meshes.items():
        reset_peaks()
        got, launches = on_path(f"streamed_sharded {label}", STREAMED_KERNELS,
                                lambda: ss.prove_streamed_sharded(spk, mesh_d, r, s, asg))
        if got != resident:
            raise AssertionError(f"the streamed sharded proof ({label}) differs from the resident one")
        with trace.collect() as tr:
            t1 = time.perf_counter()
            again = ss.prove_streamed_sharded(spk, mesh_d, r, s, asg)
            wall = time.perf_counter() - t1
        if again != resident:
            raise AssertionError("a repeated streamed sharded prove gave another proof")
        print(f"[13] (d) streamed sharded prove at 2^{log_n}, chunk {chunk} over {SHARDS} shards "
              f"({label}; {mesh_d.physical()}): equals the resident proof byte for byte; second prove "
              f"{wall:.4f} s ({card}); stages (s): "
              + json.dumps({k: round(v, 4) for k, v in tr.as_dict().items()}))
        print(f"[13] (d) {label}: launches {json.dumps(launches)}; each shard's parts (copy ms, compute "
              f"ms; CUDA events on its copy and compute stream): " + json.dumps(
                  {i: [[round(c, 3), round(m, 3)] for c, m in v] for i, v in ss.LAST_CHUNK_MS.items()})
              + f"; peak device memory {json.dumps(ss.LAST_PEAK_DEVICE_BYTES)} B")
    del spk
    reset_peaks()

    # (e) the CLI's dist-dryrun: two gloo processes of two shards sharing the card
    root = Path(__file__).resolve().parent
    for extra in ([], ["--two-level"]):
        cmd = [sys.executable, "-m", "circom_compat_tpu_torch", "dist-dryrun", "--processes", "2",
               "--local-devices", "2", "--chain-k", str(dryrun_k), "--backend", "gloo",
               "--timeout", "240", *extra, *([] if cuda else ["--device", "cpu"])]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"dist-dryrun {extra} failed ({out.returncode}): {out.stderr[-3000:]}")
        line = json.loads(out.stdout.strip().splitlines()[-1])
        if not (line["ok"] and line["proof_matches_single_process"]):
            raise AssertionError(f"dist-dryrun {extra}: {line}")
        path = "dist_dryrun" + ("_two_level" if extra else "")
        record_launches(line["launches"], ["fr_butterfly_stage", "fr_binary", "fr_tile_scan",
                                           "ntt_rows_low", "point_add_g1", "point_add_g2",
                                           "tile_scan_g1", "tile_scan_g2"], path)
        print(f"[13] (e) {' '.join(cmd[3:])}: {wall:.3f} s wall ({card}); worker proofs "
              f"agree with each other and the single-process prove; record " + json.dumps(line))
    print(f"[13] phase wall {time.perf_counter() - t_phase:.1f} s")


def _engine_run(wc, k, a=3):
    """(seconds of the chain alone, seconds of calculate_witness, the
    witness) for one run of chain_wasm(k) on wc: init and setInputSignal
    (which runs the k squares) timed on their own, then the whole
    calculate_witness (readback included)."""
    wc.instance.exported("init")(0)
    t0 = time.perf_counter()
    wc._set_inputs_circom2({"a": a})
    chain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    witness = wc.calculate_witness({"a": a})
    return chain_s, time.perf_counter() - t0, witness


def witness_phase(dev, card, work, pk, rows, circuit, on_path, kernels, load9_s, log_n=LOG_N,
                  log_native=16, log_interp=10):
    """[15] The witness engines (witness/wasm/aot.py, native.py, interp.py)
    on chain_wasm, the squaring chain's WASM witness generator:
    (a) k = 2^log_n - 2 through engine="aot": its gcc build and run
        seconds; the witness equals chain_witness(k, 3) and
        calculate_witness_limbs its ints_to_limbs;
    (b) engine="native" at k = 2^log_native - 2 and "interp" at
        k = 2^log_interp - 2, each equal to chain_witness, all three engines
        equal at 2^log_interp - 2; seconds and WASM instructions a second
        of each (the interpreter never runs the 2^20 chain: hours);
    (c) `--timings fullprove ... --engine aot` at 2^log_n on `pk` (phase
        7's key, written with write_zkey): the stage table, K1, K2, K3, K4,
        K6/K7 and K8 launched, `verify` returning OK!;
    (d) chain_wasm(254) with {"a": 3} through each engine, proved on
        tests/golden/chain254.zkey at the golden r and s, equal to
        chain254_proof.json;
    (e) the native Montgomery strip against mont_strip_np on the key's
        section-4 values, word for word, with the seconds of each beside
        phase 9's zkey load."""
    import contextlib
    import mmap

    import torch

    from circom_compat_tpu_torch import cli
    from circom_compat_tpu_torch.circom.zkey import BinFile, read_zkey
    from circom_compat_tpu_torch.circom.zkey_writer import write_zkey
    from circom_compat_tpu_torch.constants import NPRIME_R, R_SCALAR
    from circom_compat_tpu_torch.models.groth16 import Groth16
    from circom_compat_tpu_torch.ops import limbs as lc
    from circom_compat_tpu_torch.utils import trace
    from circom_compat_tpu_torch.utils.chain import chain_witness
    from circom_compat_tpu_torch.utils.chain_wasm import chain_wasm, instructions_per_square
    from circom_compat_tpu_torch.witness import WitnessCalculator
    from circom_compat_tpu_torch.witness.wasm import aot

    t_phase = time.perf_counter()
    per_square = instructions_per_square()
    rates = {}

    def engine_row(engine, k, check=True):
        t0 = time.perf_counter()
        wc = WitnessCalculator(chain_wasm(k), engine=engine)
        setup_s = time.perf_counter() - t0
        chain_s, calc_s, witness = _engine_run(wc, k)
        if check and witness != chain_witness(k, 3):
            raise AssertionError(f"engine={engine} at k={k}: the witness is not chain_witness")
        rates.setdefault(engine, {})[k] = {
            "instance_s": round(setup_s, 4), "chain_s": round(chain_s, 4),
            "calculate_witness_s": round(calc_s, 4),
            "wasm_ops_per_s": round(per_square * k / chain_s)}
        return wc, witness

    # (a) the AOT engine at the full size
    k = (1 << log_n) - 2
    aot.build_seconds = 0.0
    wc, witness = engine_row("aot", k)
    t0 = time.perf_counter()
    limbs = wc.calculate_witness_limbs({"a": 3})
    limbs_s = time.perf_counter() - t0
    if not np.array_equal(limbs, lc.ints_to_limbs(witness, dtype=np.uint32)):
        raise AssertionError("calculate_witness_limbs differs from ints_to_limbs of the witness")
    print(f"[15] (a) chain_wasm({k}) ({len(chain_wasm(k))} B, {wc.instance.memory.pages} pages) "
          f"through engine=aot: C emission + gcc {aot.build_seconds:.4f} s (first use); "
          f"{json.dumps(rates['aot'][k])}; calculate_witness_limbs {limbs_s:.4f} s; equal to "
          f"chain_witness and its limbs ({per_square} WASM instructions a square; host CPU of "
          f"the {card} machine)")
    del wc, witness, limbs

    # (b) the other engines where they finish in seconds; all three agree at the smallest k
    small = (1 << log_interp) - 2
    for engine, log in (("aot", log_native), ("native", log_native), ("native", log_interp),
                        ("interp", log_interp), ("aot", log_interp)):
        engine_row(engine, (1 << log) - 2)
    same = {e: WitnessCalculator(chain_wasm(small), engine=e).calculate_witness({"a": 5})
            for e in ("aot", "native", "interp")}
    if not same["aot"] == same["native"] == same["interp"] == chain_witness(small, 5):
        raise AssertionError(f"the engines differ at k={small}")
    print("[15] (b) engines, seconds and WASM instructions a second (chain_s: setInputSignal, "
          "which runs the k squares; calculate_witness_s: init + input + readback): "
          + json.dumps({e: {str(kk): v for kk, v in rows_.items()} for e, rows_ in rates.items()}))
    print(f"[15] (b) aot, native and interp give equal witnesses at k={small}, equal to chain_witness")

    # (c) fullprove from inputs through the AOT engine at 2^log_n
    f = {name: str(Path(work) / name) for name in
         ("chain.zkey", "chain.wasm", "input.json", "proof.json", "public.json")}
    t0 = time.perf_counter()
    write_zkey(f["chain.zkey"], pk, rows[0], rows[1], len(circuit.r1cs.constraints))
    Path(f["chain.wasm"]).write_bytes(chain_wasm(k))
    Path(f["input.json"]).write_text(json.dumps({"a": 3}))
    print(f"[15] (c) zkey of n_vars {pk.n_vars} and chain.wasm written in "
          f"{time.perf_counter() - t0:.4f} s")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    err, out = io.StringIO(), io.StringIO()

    def fullprove():
        with trace.collect() as tr, contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
            rc = cli.main(["--timings", "fullprove", f["input.json"], f["chain.wasm"],
                           f["chain.zkey"], f["proof.json"], f["public.json"], "--engine", "aot",
                           *([] if dev.type == "cuda" else ["--device", str(dev)])])
        return rc, tr

    t0 = time.perf_counter()
    (rc, tr), launches = on_path("fullprove_aot", kernels, fullprove)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"fullprove failed: {err.getvalue()}")
    stages = tr.as_dict()
    prove_s = sum(v for name, v in stages.items() if name.startswith("prove.") and "/" not in name)
    peak = f"{torch.cuda.max_memory_allocated()} B" if dev.type == "cuda" else "not measured"
    print(f"[15] (c) fullprove --engine aot at 2^{log_n} ({card}): {wall:.4f} s wall; "
          f"witness.calculate {stages['witness.calculate']:.4f} s against the prove stages' "
          f"{prove_s:.4f} s (zkey.load {stages['zkey.load']:.4f} s, key.stage "
          f"{stages.get('key.stage', 0.0):.4f} s); peak device memory {peak}; launches: "
          f"{json.dumps(launches)}")
    print("[15] (c) stage table: " + json.dumps(err.getvalue().splitlines()[1:]))
    print("[15] (c) stages (s): " + json.dumps({n: round(v, 4) for n, v in stages.items()}))
    with contextlib.redirect_stdout(io.StringIO()) as said:
        rc = cli.main(["verify", f["chain.zkey"], f["public.json"], f["proof.json"]])
    if (rc, said.getvalue()) != (0, "OK!\n"):
        raise AssertionError("the fullprove proof does not verify")
    if json.loads(Path(f["public.json"]).read_text()) != [str(v) for v in circuit.get_public_inputs()]:
        raise AssertionError("fullprove wrote other public inputs")
    print("[15] (c) verify: OK!")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (d) the golden proof from inputs through each engine
    golden = Path(__file__).resolve().parent / "tests" / "golden"
    rec = json.loads((golden / "chain254_proof.json").read_text())
    gpk, gm = read_zkey(golden / "chain254.zkey")
    for engine in ("aot", "native", "interp"):
        w = WitnessCalculator(chain_wasm(254), engine=engine).calculate_witness({"a": 3})
        gp = Groth16.create_proof_with_reduction_and_matrices(
            gpk, rec["r"], rec["s"], gm, gm.num_instance_variables, gm.num_constraints, w,
            device=dev)
        got = {"a": [hex(v) for v in gp.a], "b": [[hex(v) for v in c] for c in gp.b],
               "c": [hex(v) for v in gp.c]}
        if json.dumps(got) != json.dumps(rec["proof"]):
            raise AssertionError(f"chain254 from inputs on engine={engine} is not the golden proof")
    print("[15] (d) chain_wasm(254) with {\"a\": 3} through aot, native and interp proves to "
          "tests/golden/chain254_proof.json byte for byte")

    # (e) the strip of section 4: native against numpy
    with open(f["chain.zkey"], "rb") as fh:
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
    pos = BinFile(mm, buffer=mm).sections[4][0]
    entry = np.dtype([("matrix", "<u4"), ("constraint", "<u4"), ("signal", "<u4"),
                      ("value", "<u2", (16,))])
    count = int.from_bytes(mm[pos : pos + 4], "little")
    values = np.ascontiguousarray(np.frombuffer(mm, dtype=entry, count=count, offset=pos + 4)["value"])
    t0 = time.perf_counter()
    native_out = lc.mont_strip(values, R_SCALAR)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain_out = lc.mont_strip_np(values, R_SCALAR, NPRIME_R)
    plain_s = time.perf_counter() - t0
    if not np.array_equal(native_out, plain_out):
        raise AssertionError("the native strip differs from mont_strip_np")
    print(f"[15] (e) section-4 strip of {count} coefficients: native {native_s:.4f} s, "
          f"mont_strip_np {plain_s:.4f} s, equal word for word; phase 9's zkey load (native "
          f"strip) {load9_s:.4f} s, (c)'s zkey.load {stages['zkey.load']:.4f} s")
    del values, native_out, plain_out, mm
    print(f"[15] phase wall {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    from circom_compat_tpu_torch import _build
    from circom_compat_tpu_torch.constants import R_SCALAR
    from circom_compat_tpu_torch.ops import curve as cv
    from circom_compat_tpu_torch.ops import curve_kernels as ck
    from circom_compat_tpu_torch.constants import Q
    from circom_compat_tpu_torch.ops import field as fl
    from circom_compat_tpu_torch.ops import field_bench as fbn
    from circom_compat_tpu_torch.ops import field_kernels as fk
    from circom_compat_tpu_torch.ops import limbs as lc
    from circom_compat_tpu_torch.ops import msm, ntt
    from circom_compat_tpu_torch.refmath import curve as rc

    dev = torch.device("cuda")
    rng = random.Random(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ---- 1. card -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[1] build {time.perf_counter() - t0:.3f} s (nvcc sm_90a, {_build.build_dir()})")
    ptxas = {}
    for name in _build.SOURCES:
        ptxas.update(_build.ptxas_report(_build.build_dir() / f"{name}.ptxas.txt"))
    for fn, row in ptxas.items():
        print(f"    ptxas {fn[:90]}: {row['registers']} registers, spill stores "
              f"{row['spill_stores']} B, spill loads {row['spill_loads']} B")
    scan_res = ck.tile_scan_resources(ptxas)
    add_res = ck.point_add_resources(ptxas)
    ntt_res = {log: dict(registers=row["registers"], spill_bytes=row["spill_stores"] + row["spill_loads"],
                         **fk.ntt_rows_launch_shape(log, dev))
               for log, row in fk.ntt_rows_resources(ptxas).items()}
    print("    K3/K4 entry kernels ccf_ntt_rows_log<k> (registers, spill B, threads, rows a block, "
          "dynamic shared B, warps an SM): " + json.dumps(
              {log: [r["registers"], r["spill_bytes"], r["threads"], r["rows_per_block"], r["smem_bytes"],
                     r["warps_per_sm"]] for log, r in ntt_res.items()}))
    print(f"    K2 fr_tile_scan (tiles of 16): {json.dumps(fk.tile_scan_launch_shape(dev))}")
    print("    K6/K7 entry kernels (registers, spill stores + loads B): " + json.dumps(
        {f"{g}_{m}": [row["registers"], row["spill_stores"] + row["spill_loads"]]
         for g, modes in add_res.items() for m, row in modes.items()}))
    card = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(card)
    mem_rate = 3.35e12
    MAD = 264  # multiply-adds per Montgomery multiply (csrc/field.cuh)

    def bound(nbytes, mads, per_sm_clock=64):
        """mads 32-bit integer operations at per_sm_clock an SM a clock: 64
        multiply-adds (the FMA pipe), or 128 for word adds and selects with
        no multiply (the ALU and FMA pipes side by side)."""
        tb, to = nbytes / mem_rate * 1e3, mads / (per_sm_clock * 132 * clock_mhz * 1e6) * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    # ---- 2 and 3. kernels vs plain at the 2^20 shapes, then their times -----
    n = 1 << LOG_N
    W = msm.num_windows(13)
    plan = ntt.get_plan(n)
    tb = plan.tables(dev)
    R = R_SCALAR
    results = {}

    def lazy_fr(count, p=R):
        """count random lazy words in [0, 2p) (p = r or q), led by 0, 1,
        p-1, 2p-1: a top word below 0x60c89ce5 (the top word of both 2r and
        2q) keeps the value below 2p."""
        x = torch.randint(-2**31, 2**31, (count, 8), dtype=torch.int32, device=dev, generator=gen)
        x[:, 7] = torch.remainder(x[:, 7].to(torch.int64), 0x60C89CE5).to(torch.int32)
        x[:4] = torch.tensor(lc.ints_to_words([0, 1, p - 1, 2 * p - 1]), device=dev)
        return x

    def check(name, kernel_fn, plain_fn, reps, nbytes, mads, replaces, source, note="", device=None,
              per_sm_clock=64, latency_ms=None):
        """Kernel vs plain on the same inputs (word for word), then the
        kernel's time (and, given `device`, a substring of its kernel's
        name, its profiler device time); the first check of a name makes
        its kernels row. per_sm_clock: the bound's operation rate
        (bound()); latency_ms, given, is the bound instead (a kernel whose
        time is one dependent chain)."""
        torch.cuda.synchronize()
        got = kernel_fn()
        want, plain_ms = once_ms(plain_fn)
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        err = max(max_abs_err(a, b) for a, b in zip(got_t, want_t))
        if err != 0:
            raise AssertionError(f"{name}: kernel and plain version differ")
        del got, want, got_t, want_t
        _, ms = timed(kernel_fn, reps)
        dev_ms = device_ms(kernel_fn, reps, device) if device else None
        b_ms, b_by = bound(nbytes, mads, per_sm_clock) if latency_ms is None else (latency_ms,
                                                                                  "latency")
        shown = "" if device is None else (
            f", device {dev_ms:.4f} ms (profiler)" if dev_ms is not None else ", device not measured")
        print(f"[2] {name}{note}: equal to plain (max_abs_err 0, tolerance 0: integer "
              f"arithmetic); [3] {ms:.4f} ms{shown}, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by})")
        results.setdefault(name, dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=0,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
        if device:
            results[name].setdefault("device_ms", dev_ms)
        if name.startswith("ntt_rows") or name in ("fr_butterfly_stage", "fr_tile_scan", "fr_binary",
                                                   "f_binary_fq", "fq_op_chain"):
            # every mode's numbers on the kernels line
            results[name].setdefault("modes", {})[note.strip()] = dict(
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, max_abs_err=err)

    FP = "circom_compat_tpu/ops/field_pallas.py"
    CP = "circom_compat_tpu/ops/curve_pallas.py"
    FSRC = "circom_compat_tpu_torch/csrc/field_kernels.cu"
    CSRC = "circom_compat_tpu_torch/csrc/curve_kernels.cu"

    a, b = lazy_fr(n), lazy_fr(n)
    for op in ("mul", "mul_canon", "add", "sub"):
        check("fr_binary", lambda: fk.fr_binary(op, a, b), lambda: fk.fr_binary_plain(op, a, b),
              20, 96 * n, (MAD if op.startswith("mul") else 0) * n, f"{FP}:84", FSRC, f" {op}",
              "binary_kernel")
    elem = a[5].clone()
    check("fr_binary", lambda: fk.fr_binary("mul", a, elem), lambda: fk.fr_binary_plain("mul", a, elem),
          20, 64 * n, MAD * n, f"{FP}:84", FSRC, " mul by one broadcast element", "binary_kernel")

    T = n // 16
    vt = a.reshape(T, 16, 8)
    ft = torch.rand(T, 16, device=dev, generator=gen) < 0.9  # sparse rows: most start a row
    check("fr_tile_scan", lambda: fk.fr_tile_scan(vt, ft), lambda: fk.fr_tile_scan_plain(vt, ft),
          20, 65 * n + 32 * T, 0, f"{FP}:228", FSRC, f" T={T}, K=16, flags 0.9", "fr_tile_scan_kernel")
    Tr = T - 37  # a ragged last batch
    vr, fr_ = vt[:Tr], ft[:Tr]
    check("fr_tile_scan", lambda: fk.fr_tile_scan(vr, fr_), lambda: fk.fr_tile_scan_plain(vr, fr_),
          20, (65 * 16 + 32) * Tr, 0, f"{FP}:228", FSRC, f" T={Tr} (ragged), K=16, flags 0.9")

    def row_muls(rows, L):
        """Butterfly multiplies of one stage sweep over rows of L: the
        (L/2) log2 L butterflies less the L - 1 whose twiddle is one."""
        return rows * ((L // 2) * (L.bit_length() - 1) - (L - 1))

    n1 = plan.n1
    x3 = a.reshape(n // n1, n1, 8)
    pre, post = b.reshape(x3.shape), lazy_fr(n).reshape(x3.shape)
    stages = row_muls(n // n1, n1)
    print(f"[3] ntt_rows bounds count {stages} butterfly multiplies a sweep at 2^{LOG_N} "
          f"(rows of {n1}; {(n1.bit_length() - 1) * n // 2} butterflies, {n // n1 * (n1 - 1)} by one)")
    check("ntt_rows_low", lambda: fk.ntt_rows(x3, tw_dif=tb["tw1_inv"], pre=pre, post=post),
          lambda: fk.ntt_rows_plain(x3, tw_dif=tb["tw1_inv"], pre=pre, post=post),
          10, 128 * n, MAD * (stages + 2 * n), f"{FP}:387", FSRC, " DIF, pre + post mul")
    check("ntt_rows_low", lambda: fk.ntt_rows(x3, tw_dit=tb["tw1_fwd"], pre=pre, post=post, post_op="sub"),
          lambda: fk.ntt_rows_plain(x3, tw_dit=tb["tw1_fwd"], pre=pre, post=post, post_op="sub"),
          10, 128 * n, MAD * (stages + n), f"{FP}:387", FSRC, " DIT, pre mul + post sub")
    mid = tb["coset4"].reshape(plan.n1, plan.n2, 8)
    x4 = a.reshape(mid.shape)
    check("ntt_rows_mid", lambda: fk.ntt_rows(x4, tw_dif=tb["tw2_inv"], mid=mid, tw_dit=tb["tw2_fwd"]),
          lambda: fk.ntt_rows_plain(x4, tw_dif=tb["tw2_inv"], mid=mid, tw_dit=tb["tw2_fwd"]),
          10, 96 * n, MAD * (2 * stages + n), f"{FP}:432", FSRC, " DIF, coset mid, DIT")
    # the four-step rows at 2^22 (phase 12's domain): rows of n1 = 2^11, the
    # entry kernel ccf_ntt_rows_log11, low (DIF + pre + post) and mid modes
    big = 1 << LOG_BIG
    plan_big = ntt.NTTPlan(big)  # its row tables only: no 2^22 coset tables staged here
    nb1 = plan_big.n1
    twb = {inv: torch.from_numpy(plan_big._row_table(nb1, inv)).to(dev) for inv in (True, False)}
    xb, preb, postb = (lazy_fr(big).reshape(big // nb1, nb1, 8) for _ in range(3))
    stages_big = row_muls(big // nb1, nb1)
    check("ntt_rows_low", lambda: fk.ntt_rows(xb, tw_dif=twb[True], pre=preb, post=postb),
          lambda: fk.ntt_rows_plain(xb, tw_dif=twb[True], pre=preb, post=postb),
          10, 128 * big, MAD * (stages_big + 2 * big), f"{FP}:387", FSRC,
          f" DIF, pre + post mul, 2^{LOG_BIG} (rows of {nb1})")
    check("ntt_rows_mid", lambda: fk.ntt_rows(xb, tw_dif=twb[True], mid=preb, tw_dit=twb[False]),
          lambda: fk.ntt_rows_plain(xb, tw_dif=twb[True], mid=preb, tw_dit=twb[False]),
          10, 96 * big, MAD * (2 * stages_big + big), f"{FP}:432", FSRC,
          f" DIF, coset mid, DIT, 2^{LOG_BIG} (rows of {nb1})")
    del xb, preb, postb, twb, plan_big
    # the flat chain's rows at 2^13: 16 rows of LOW_BLOCK, DIF and DIT + pre
    # (launch-bound: 16 blocks on 132 SMs)
    small = 1 << LOG_SMALL
    low = ntt.get_plan(small).tables(dev, "flat")
    xf, pf = a[:small].reshape(-1, ntt.LOW_BLOCK, 8), b[:small].reshape(-1, ntt.LOW_BLOCK, 8)
    fstages = row_muls(small // ntt.LOW_BLOCK, ntt.LOW_BLOCK)
    check("ntt_rows_low", lambda: fk.ntt_rows(xf, tw_dif=low["low_inv"]),
          lambda: fk.ntt_rows_plain(xf, tw_dif=low["low_inv"]),
          200, 64 * small, MAD * fstages, f"{FP}:387", FSRC, f" flat DIF, 2^{LOG_SMALL}")
    check("ntt_rows_low", lambda: fk.ntt_rows(xf, tw_dit=low["low_fwd"], pre=pf),
          lambda: fk.ntt_rows_plain(xf, tw_dit=low["low_fwd"], pre=pf),
          200, 96 * small, MAD * (fstages + small), f"{FP}:387", FSRC, f" flat DIT + pre, 2^{LOG_SMALL}")
    del a, b, vt, ft, vr, fr_, x3, pre, post, x4

    # K5a/K5b: the flat chain's high stages in one launch, at the 2^13 path's
    # shape first (half 4096 -> 512 DIF, 512 -> 4096 DIT: R = 16), then at the
    # smaller flat sizes (R = 8, 4, 2), and one stage at 2^20 for a rate; 64 B
    # an element, one multiply a butterfly a stage
    K5 = f"{FP}:276 (K5a), {FP}:169 (K5b, the DIT mode)"
    for log_m in (LOG_SMALL, 12, 11, 10):
        m = 1 << log_m
        # a plan of its own: get_plan's cache would evict the 2^20 plan, and
        # phase 4 would stage a second copy of its tables
        ftb = ntt.NTTPlan(m).tables(dev, "flat")
        xs = lazy_fr(m)
        stages = log_m - (ntt.LOW_BLOCK.bit_length() - 1)
        for dif in (True, False):
            tw = ftb["tw_inv" if dif else "tw_fwd"]
            check("fr_butterfly_stage", lambda: fk.fr_butterfly_stages(xs, tw, ntt.LOW_BLOCK, m // 2, dif),
                  lambda: fk.fr_butterfly_stages_plain(xs, tw, ntt.LOW_BLOCK, m // 2, dif),
                  200, 64 * m, MAD * m // 2 * stages, K5, FSRC,
                  f" {'DIF' if dif else 'DIT'} n=2^{log_m}, half {ntt.LOW_BLOCK}..{m // 2} "
                  f"(R = {2 ** stages}, fused)", "butterfly_stages_kernel")
        del xs
    m = 1 << LOG_N
    ftb = ntt.get_plan(m).tables(dev, "flat")
    xs = lazy_fr(m)
    for dif in (True, False):
        tw = ftb["tw_inv" if dif else "tw_fwd"]
        check("fr_butterfly_stage", lambda: fk.fr_butterfly_stage(xs, tw, m // 2, dif),
              lambda: fk.fr_butterfly_stage_plain(xs, tw, m // 2, dif),
              50, 160 * m // 2, MAD * m // 2, K5, FSRC,
              f" {'DIF' if dif else 'DIT'} n=2^{LOG_N}, half {m // 2} (one stage)", "butterfly_stages_kernel")
    del xs

    # K1's Fq mode (the setup's affine conversion and on-curve check)
    a, b = lazy_fr(n, Q), lazy_fr(n, Q)
    for op in ("mul", "mul_canon", "add", "sub"):
        check("f_binary_fq", lambda: fk.fr_binary(op, a, b, fl.FQ),
              lambda: fk.fr_binary_plain(op, a, b, fl.FQ),
              20, 96 * n, (MAD if op.startswith("mul") else 0) * n, f"{FP}:84", FSRC, f" {op}",
              "binary_kernel")
    elem = a[5].clone()
    check("f_binary_fq", lambda: fk.fr_binary("mul", a, elem, fl.FQ),
          lambda: fk.fr_binary_plain("mul", a, elem, fl.FQ),
          20, 64 * n, MAD * n, f"{FP}:84", FSRC, " mul by one broadcast element", "binary_kernel")
    del a, b

    # K9: K dependent steps of one Fq op per element, on the op's edge
    # operands (ops/field_bench.edge_operands: every pairing of 0, 1, q-1,
    # two values whose low seven words are all ones and, for the lazy ops,
    # 2q-1 with b = 1, q-1 and 2q-1, then seeded values): at n = 2^16 with
    # K = 64 and K = 5, at a ragged n, and at n = 2^20 (one thread an element
    # fills the card); device time at K = 64; the bound at the op's rate
    # (field_bench.OPS_PER_SM_CLOCK)
    for op in fbn.OPS:
        for n9, k9 in ((K9_N, K9_K), (K9_N, 5), (K9_N - 37, K9_K), (n, K9_K)):
            ka, kb = fbn.edge_operands(op, n9, device=dev)
            check("fq_op_chain", lambda: fbn.fq_op_chain(op, ka, kb, k9),
                  lambda: fbn.fq_op_chain_plain(op, ka, kb, k9), 10, 96 * n9, fbn.INT_OPS[op] * k9 * n9,
                  "scripts/bench_field_ops.py:79", FSRC, f" {op}, n={n9}, K={k9}",
                  "fq_op_chain" if k9 == K9_K and n9 in (K9_N, n) else None,
                  per_sm_clock=fbn.OPS_PER_SM_CLOCK[op])
            del ka, kb

    ks, g1_pool, g2_pool = point_pools(rng)

    def pool_tensor(g2, pts):
        enc = cv.encode_g2_affine(pts) if g2 else cv.encode_g1_affine(pts)
        return torch.from_numpy(enc).to(dev)

    def affine_rows(g2, count, pool_xy, neg_xy):
        """count affine-encoded rows: pool points, a few identity rows."""
        idx = torch.randint(0, POOL, (count,), device=dev, generator=gen)
        pts = cv.affine_to_proj(pool_xy[idx], g2)
        pts[::97] = cv.proj_identity_const(g2, dev)
        return pts, idx

    for g2, pool in ((False, g1_pool), (True, g2_pool)):
        grp = rc.G2 if g2 else rc.G1
        tag = "g2" if g2 else "g1"
        pool_xy = pool_tensor(g2, pool)
        neg_xy = pool_tensor(g2, [grp.neg(p) for p in pool])
        P, idx = affine_rows(g2, n, pool_xy, neg_xy)
        Qa, _ = affine_rows(g2, n, pool_xy, neg_xy)
        Qa[1::5] = P[1::5]  # P + P
        Qa[2::5] = cv.affine_to_proj(neg_xy[idx[2::5]], g2)  # P + (-P)
        Qa[3::101] = cv.proj_identity_const(g2, dev)
        Pg = ck.point_add_plain(P, Qa.roll(1, 0))  # general projective operands
        fq_muls = 42 if g2 else 12
        pb = 192 if g2 else 96
        Qg = Qa.roll(2, 0).contiguous()
        check(f"point_add_{tag}", lambda: ck.point_add(Pg, Qg), lambda: ck.point_add_plain(Pg, Qg),
              10, 3 * pb * n, fq_muls * MAD * n, f"{CP}:233", CSRC, " add")
        got = ck.point_add(P, Qa, mixed=True)
        check(f"point_add_{tag}", lambda: ck.point_add(P, Qa, mixed=True),
              lambda: ck.point_add_plain(P, Qa, mixed=True),
              10, 3 * pb * n, (fq_muls - 3 if g2 else 11) * MAD * n, f"{CP}:233", CSRC, " madd")
        # ... and at the path's largest shape: Phase C of the scan over the
        # level-0 tiles' carries (W * n / 16 per MSM; 4 MSMs in G1, 1 in
        # G2), word for word against the plain version in 2^20-row chunks;
        # every row is drawn afresh, so no two chunks hold the same inputs
        big = W * n // (16 if g2 else 4)

        def chunked_plain(a, b):
            return torch.cat([ck.point_add_plain(a[i : i + n], b[i : i + n]) for i in range(0, big, n)])

        Pb = chunked_plain(affine_rows(g2, big, pool_xy, neg_xy)[0],
                           affine_rows(g2, big, pool_xy, neg_xy)[0])  # Z != 1
        Qb = Pb.roll(3, 0).contiguous()
        check(f"point_add_{tag}", lambda: ck.point_add(Pb, Qb), lambda: chunked_plain(Pb, Qb),
              5, 3 * pb * big, fq_muls * MAD * big, f"{CP}:233", CSRC, f" add, n={big}")
        del Pb, Qb
        rows = list(range(0, 400))
        dec = cv.decode_g2_proj if g2 else cv.decode_g1_proj
        p_aff, q_aff = dec(P[rows]), dec(Qa[rows])
        assert dec(got[rows]) == [grp.add(x, y) for x, y in zip(p_aff, q_aff)]
        # K8 at the bucket reduce's level-0 shape: all windows of the
        # group's MSMs (4 in G1, 1 in G2) in one scan
        total = W * n * (1 if g2 else 4)
        T = total // 16
        vt, _ = affine_rows(g2, total, pool_xy, neg_xy)
        vt = vt.reshape((T, 16) + vt.shape[1:])
        ft = torch.rand(T, 16, device=dev, generator=gen) < 1 / 128
        madd_muls = (fq_muls - 3) if g2 else 11
        # bounds count the combines this data needs: one per unflagged position
        check(f"tile_scan_{tag}", lambda: ck.point_tile_scan(vt, ft, mixed=True),
              lambda: ck.point_tile_scan_plain(vt, ft, mixed=True),
              3, 2 * pb * total + total + pb * T, madd_muls * MAD * int((~ft).sum()), f"{CP}:352", CSRC,
              f" madd, T={T}")
        # ... and at level 1: the general scan over those tiles' carries
        _, carry = ck.point_tile_scan(vt, ft, mixed=True)
        Tg = T // 16
        vg = carry.reshape((Tg, 16) + carry.shape[1:])
        fg = ft.any(dim=1).reshape(Tg, 16)
        del vt, ft, carry
        check(f"tile_scan_{tag}", lambda: ck.point_tile_scan(vg, fg),
              lambda: ck.point_tile_scan_plain(vg, fg),
              5, 2 * pb * Tg * 16 + Tg * 16 + pb * Tg, fq_muls * MAD * int((~fg).sum()), f"{CP}:352",
              CSRC, f" add, T={Tg}")
        del P, Qa, Pg, Qg, got, vg, fg
        torch.cuda.empty_cache()
        for kind, res in (("tile_scan", scan_res[tag]), ("point_add", add_res[tag])):
            results[f"{kind}_{tag}"].update(
                registers={mode: row["registers"] for mode, row in res.items()},
                spill_bytes={mode: row["spill_stores"] + row["spill_loads"] for mode, row in res.items()})

    # K10 at the prove's two window shapes (2^20: w = 13, W = 20; 10^4: w =
    # 8, W = 32): window sums of two pool points each (Z != 1), with identity
    # windows (the top one of each MSM, every third of L) and two equal
    # consecutive windows; the key's five points from the pools, staged as
    # DeviceProvingKey stages them (Z = one); r and s random. Its bound is
    # latency: the longest chain of dependent Fq multiplies
    # (proof_fold_levels) times one multiply's latency, K9's 64 dependent
    # lazy Montgomery multiplies in one thread (device time) over 64
    k9_one = fbn.run(1, K9_K, ops=("mont_mul_lazy",), device=dev)["mont_mul_lazy"]
    mul_by = "device" if k9_one["device_ms"] is not None else "event (wrapper included)"
    mul_ms = (k9_one["device_ms"] or k9_one["event_ms"]) / K9_K
    print(f"[3] K9 in one thread, {K9_K} dependent mont_mul_lazy: {mul_ms * 1e3:.4f} us a "
          f"multiply by {mul_by} time")
    xy1, xy2 = pool_tensor(False, g1_pool), pool_tensor(True, g2_pool)

    def pool_sums(g2, xy, count):
        idx = torch.randint(0, POOL, (2, count), device=dev, generator=gen)
        return ck.point_add_plain(cv.affine_to_proj(xy[idx[0]], g2), cv.affine_to_proj(xy[idx[1]], g2))

    fixed10 = (cv.affine_to_proj(xy1[:3], False), cv.affine_to_proj(xy2[:2], True))
    for c10, w10 in ((13, W), (8, 32)):
        s1 = pool_sums(False, xy1, 4 * w10).reshape(4, w10, 3, 8)
        s2 = pool_sums(True, xy2, w10)
        s1[:, -1] = cv.proj_identity_const(False, dev)
        s1[2, ::3] = cv.proj_identity_const(False, dev)
        s1[0, 4], s2[1], s2[6] = s1[0, 3], cv.proj_identity_const(True, dev), s2[5]
        args10 = (s1, s2, *fixed10, rng.randrange(R), rng.randrange(R), c10)
        check("proof_fold", lambda: ck.proof_fold(*args10), lambda: ck.proof_fold_plain(*args10),
              20, 576 * w10 + 1056, 0, "circom_compat_tpu/models/groth16_jax.py:537",
              CSRC, f" w={c10}, W={w10}", "ccf_proof_fold",
              latency_ms=proof_fold_levels(c10, w10) * mul_ms)
    row10 = ptxas["ccf_proof_fold_kernel"]
    results["proof_fold"].update(registers=row10["registers"],
                                 spill_bytes=row10["spill_stores"] + row10["spill_loads"],
                                 chain_levels=proof_fold_levels(13, W), fq_mul_latency_us=mul_ms * 1e3)
    del s1, s2, args10

    def reset_all():
        fk.reset_launches()
        ck.reset_launches()
        fbn.reset_launches()
        msm.reset_counters()

    def counts():
        return {**fk.LAUNCHES, **ck.LAUNCHES, **fbn.LAUNCHES}

    def path_launches(counts_now, names, path):
        """Each of `names` launched on `path` (counts set to 0 just before):
        recorded beside the main path's count."""
        for name in names:
            if counts_now[name] <= 0:
                raise AssertionError(f"kernel {name} did not launch on {path}")
            results[name].setdefault("launches_by_path", {})[path] = counts_now[name]

    def on_path(path, names, fn):
        """fn() with every count set to 0 just before it; each of `names`
        must have launched just after."""
        reset_all()
        out = fn()
        torch.cuda.synchronize()
        now = counts()
        path_launches(now, names, path)
        return out, {k2: v for k2, v in now.items() if v}

    # ---- 4. main path at a 2^20 domain --------------------------------------
    from circom_compat_tpu_torch.models import groth16_device as gd

    from circom_compat_tpu_torch.utils import trace
    from circom_compat_tpu_torch.utils.chain import chain_circuit, chain_matrices

    t0 = time.perf_counter()
    circuit = chain_circuit(k=n - 2, a=3)
    rows = circuit.to_matrices()  # once: 3 (k,)-row lists at 2^20, for phases 7 and 9
    pk4, secret = synthetic_key(n - 2, rng, ks, g1_pool, g2_pool)
    m4 = chain_matrices(n - 2)
    dpk = gd.DeviceProvingKey.build(pk4, m4, n - 2, 2, device=dev)
    print(f"[4] chain k={n - 2}, n_vars={dpk.n_vars}, domain 2^{LOG_N}: circuit + key staged in "
          f"{time.perf_counter() - t0:.3f} s; staged key {dpk.nbytes()} device bytes")
    wbits = gd.default_window_bits(dpk)
    r_, s_ = rng.randrange(R), rng.randrange(R)
    asg = circuit.full_assignment()

    fk.reset_launches()
    ck.reset_launches()
    proof = gd.prove_prepared(dpk, r_, s_, asg, wbits)
    torch.cuda.synchronize()
    launches = {**fk.LAUNCHES, **ck.LAUNCHES}
    print(f"[4] window bits {wbits}; launches in one prove: {json.dumps(launches)}")

    def take_launches(counts, names, path):
        """The counts of `names` on one path: each must be > 0."""
        for name in names:
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} did not launch on {path}")
            results[name]["launches"] = counts[name]

    take_launches(launches, ["fr_binary", "fr_tile_scan", "ntt_rows_low", "ntt_rows_mid",
                             *ck.LAUNCHES], "the 2^20 prove")

    totals, stages_all = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        st = {}
        t1 = time.perf_counter()
        again = gd.prove_prepared(dpk, r_, s_, asg, wbits, stage_times=st)
        totals.append(time.perf_counter() - t1)
        stages_all.append(st)
        assert again == proof
    med = statistics.median(totals)
    stage_med = {k2: statistics.median(s[k2] for s in stages_all) for k2 in stages_all[0]}
    peak4 = torch.cuda.max_memory_allocated()
    print(f"[4] steady-state prove at 2^{LOG_N}: median {med:.4f} s of {totals} "
          f"({card}); peak device memory {peak4} B")
    print("[4] stages (median s): " + json.dumps({k2: round(v, 4) for k2, v in stage_med.items()}))
    with trace.collect() as tr4:
        gd.prove_prepared(dpk, r_, s_, asg, wbits)
    names4 = [name for name, _ in tr4.stages]
    if names4 != ["prove.encode", "prove.witness_map/witness_map.sparse", "prove.witness_map",
                  "prove.msm/sorts", "prove.msm/msm_g1",
                  "prove.msm/msm_g2", "prove.msm", "prove.assemble/fold",
                  "prove.assemble/readback", "prove.assemble"]:
        raise AssertionError(f"the prove's trace stages are {names4}")
    print("[4] trace stages of one prove (s, each ended by a device sync): "
          + json.dumps({k2: round(v, 4) for k2, v in tr4.as_dict().items()}))
    profile_prove(lambda: gd.prove_prepared(dpk, r_, s_, asg, wbits), 4, f"2^{LOG_N}")

    # h of the port, and the same witness map through the plain versions
    asg_dev = torch.from_numpy(gd.encode_assignment(asg)).to(dev)
    asg_mont = fk.fr_to_mont(asg_dev)
    h = fk.fr_from_mont(dpk.matrices.witness_map(asg_mont))
    h_plain = fk.fr_binary_plain("mul_canon", dpk.matrices.witness_map(asg_mont, ops=fk.PLAIN),
                                 torch.tensor(lc.ints_to_words([1])[0], device=dev))
    if max_abs_err(h, h_plain) != 0:
        raise AssertionError("witness map differs from its plain version on the card")
    h_ints = lc.words_to_ints(h.cpu().numpy())
    assert proof == expected_proof(secret, asg, h_ints, r_, s_), \
        "proof differs from the host's known-dlog A, B, C"
    print("[4] proof equals the host's known-dlog A, B, C; h equals the plain witness map")
    del asg_dev, asg_mont, h, h_plain

    # ---- 13. the multi-device provers on phase 4's key ----------------------
    sharded_phase(dev, card, dpk, m4, proof, asg, r_, s_, g1_pool, gen, on_path, path_launches,
                  check, MAD, peak4)
    del dpk
    torch.cuda.empty_cache()

    # ---- 5. golden ----------------------------------------------------------
    from circom_compat_tpu_torch.circom.zkey import read_zkey
    from circom_compat_tpu_torch.models.groth16 import Groth16

    golden = Path(__file__).resolve().parent / "tests" / "golden"
    rec = json.loads((golden / "chain254_proof.json").read_text())
    gpk, gm = read_zkey(golden / "chain254.zkey")
    c254 = chain_circuit(k=254, a=3)
    gp = Groth16.create_proof_with_reduction_and_matrices(
        gpk, rec["r"], rec["s"], gm, gm.num_instance_variables, gm.num_constraints,
        c254.full_assignment())
    want = rec["proof"]
    assert gp.a == tuple(int(v, 16) for v in want["a"])
    assert gp.b == tuple(tuple(int(v, 16) for v in c) for c in want["b"])
    assert gp.c == tuple(int(v, 16) for v in want["c"])
    assert Groth16.verify_proof(gpk.vk, gp, c254.get_public_inputs())
    print("[5] chain254 golden proof reproduced on the card and verified")

    # ---- 6. the small-circuit path at 2^13 (flat NTT chain) ------------------
    from circom_compat_tpu_torch.circom.zkey_writer import write_zkey
    from circom_compat_tpu_torch.models import generate_parameters_from_matrices

    def toxic():
        return dict(zip(("alpha", "beta", "gamma", "delta", "t"),
                        (rng.randrange(1, R) for _ in range(5))))

    cs = chain_circuit(k=(1 << LOG_SMALL) - 2, a=7)
    rows6 = cs.to_matrices()
    reset_all()
    st6 = {}
    t0 = time.perf_counter()
    pk6 = generate_parameters_from_matrices(*rows6, cs.r1cs.num_inputs, cs.r1cs.num_variables,
                                            device=dev, stage_times=st6, **toxic())
    setup6 = time.perf_counter() - t0
    print(f"[6] setup at 2^{LOG_SMALL} on the card (self-check passed): {setup6:.4f} s; stages (s): "
          + json.dumps({k2: round(v, 4) for k2, v in st6.items()}))
    print(f"[6] setup launches: {json.dumps(counts())}")
    buf = io.BytesIO()
    write_zkey(buf, pk6, rows6[0], rows6[1], len(cs.r1cs.constraints))
    buf.seek(0)
    pk6r, m6 = read_zkey(buf)
    dpk6 = gd.DeviceProvingKey.build(pk6r, m6, m6.num_constraints, device=dev)
    asg6 = cs.full_assignment()
    r6, s6 = rng.randrange(R), rng.randrange(R)
    reset_all()
    proof6 = gd.prove_prepared(dpk6, r6, s6, asg6)
    torch.cuda.synchronize()
    launches6 = counts()
    print(f"[6] zkey of {len(buf.getvalue())} B written and read back; launches in one prove: "
          f"{json.dumps(launches6)}")
    if launches6["ntt_rows_mid"] != 0:
        raise AssertionError("the 2^13 prove ran the four-step chain")
    take_launches(launches6, ["fr_butterfly_stage"], "the 2^13 prove")
    if launches6["fr_butterfly_stage"] != 6:  # one fused launch a transform
        raise AssertionError(f"the 2^13 prove made {launches6['fr_butterfly_stage']} stage launches, not 6")
    asg6_mont = fk.fr_to_mont(torch.from_numpy(gd.encode_assignment(asg6)).to(dev))
    h6 = fk.fr_from_mont(dpk6.matrices.witness_map(asg6_mont))
    h6_plain = fk.fr_binary_plain("mul_canon",
                                  dpk6.matrices.witness_map(asg6_mont, ops=fk.PLAIN),
                                  torch.tensor(lc.ints_to_words([1])[0], device=dev))
    if max_abs_err(h6, h6_plain) != 0:
        raise AssertionError("2^13 witness map differs from its plain version on the card")
    pub6 = cs.get_public_inputs()
    if not Groth16.verify_proof(pk6.vk, proof6, pub6):
        raise AssertionError("the 2^13 proof does not verify")
    if Groth16.verify_proof(pk6.vk, proof6, [(pub6[0] + 1) % R]):
        raise AssertionError("the 2^13 proof verifies a wrong public input")
    print("[6] h equals the plain witness map; the proof verifies by pairing; a wrong public "
          "input is refused")
    totals6, stages6 = [], []
    for _ in range(3):
        st = {}
        t1 = time.perf_counter()
        gd.prove_prepared(dpk6, r6, s6, asg6, stage_times=st)
        totals6.append(time.perf_counter() - t1)
        stages6.append(st)
    print(f"[6] steady-state prove at 2^{LOG_SMALL}: median {statistics.median(totals6):.4f} s of "
          f"{totals6} ({card}); stages (median s): "
          + json.dumps({k2: round(statistics.median(x[k2] for x in stages6), 5) for k2 in stages6[0]}))
    profile_prove(lambda: gd.prove_prepared(dpk6, r6, s6, asg6), 6, f"2^{LOG_SMALL}")
    plan6 = ntt.get_plan(1 << LOG_SMALL)
    a6, b6 = lazy_fr(plan6.n), lazy_fr(plan6.n)

    def chain_launches(fn):
        """The port's kernel launches of one fn() call."""
        reset_all()
        fn()
        torch.cuda.synchronize()
        return {k2: v for k2, v in counts().items() if v}

    flat_fn = lambda: ntt.witness_map_flat(plan6, a6, b6)  # noqa: E731
    four_fn = lambda: ntt.witness_map_four_step(plan6, a6, b6)  # noqa: E731
    flat_n, four_n = chain_launches(flat_fn), chain_launches(four_fn)
    if flat_n.get("fr_butterfly_stage", 0) > 6:  # six transforms, one fused launch each
        raise AssertionError(f"the flat chain ran fr_butterfly_stage more than once a transform: {flat_n}")
    flat_h, flat_ms = timed(flat_fn, 20)
    four_h, four_ms = timed(four_fn, 20)
    if max_abs_err(fk.fr_from_mont(flat_h), fk.fr_from_mont(four_h)) != 0:
        raise AssertionError("flat and four-step chains differ at 2^13")
    print(f"[6] witness-map transforms at 2^{LOG_SMALL}: flat chain {flat_ms:.4f} ms "
          f"({sum(flat_n.values())} launches: {json.dumps(flat_n)}), four-step chain {four_ms:.4f} ms "
          f"({sum(four_n.values())} kernel launches: {json.dumps(four_n)}, + transposes); equal results")
    del dpk6, a6, b6, flat_h, four_h
    torch.cuda.empty_cache()

    # ---- 7. setup on the card at 2^20 (phase 4's circuit), then a verified prove
    reset_all()
    torch.cuda.reset_peak_memory_stats()
    st7 = {}
    t0 = time.perf_counter()
    pk7 = generate_parameters_from_matrices(*rows, circuit.r1cs.num_inputs,
                                            circuit.r1cs.num_variables, device=dev,
                                            stage_times=st7, **toxic())
    setup7 = time.perf_counter() - t0
    launches7 = counts()
    print(f"[7] setup at 2^{LOG_N} on the card (self-check passed): {setup7:.4f} s; peak device "
          f"memory {torch.cuda.max_memory_allocated()} B; stages (s): "
          + json.dumps({k2: round(v, 4) for k2, v in st7.items()}))
    print(f"[7] setup launches: {json.dumps(launches7)}")
    take_launches(launches7, ["f_binary_fq"], "the 2^20 setup")
    for name in ("fr_binary", "point_add_g1", "point_add_g2"):
        if launches7[name] <= 0:
            raise AssertionError(f"kernel {name} did not launch in the 2^20 setup")
    dpk7 = gd.DeviceProvingKey.from_matrix_rows(pk7, rows[0], rows[1], circuit.r1cs.num_inputs,
                                                len(circuit.r1cs.constraints), device=dev)
    t1 = time.perf_counter()
    proof7 = gd.prove_prepared(dpk7, r_, s_, asg, wbits)
    prove7 = time.perf_counter() - t1
    if not Groth16.verify_proof(pk7.vk, proof7, circuit.get_public_inputs()):
        raise AssertionError("the 2^20 proof made with the card's setup key does not verify")
    print(f"[7] 2^{LOG_N} proof with the card's setup key ({prove7:.4f} s, first prove on this key) "
          "verifies by pairing")
    del dpk7  # pk7 (host) stays for phase 9's zkey
    torch.cuda.empty_cache()

    # ---- 8. K9: the per-op microbenchmark ------------------------------------
    reset_all()
    rates = {log: fbn.run(1 << log, K9_K, device=dev) for log in (16, LOG_N)}
    take_launches(counts(), ["fq_op_chain"], "the K9 microbenchmark")
    for log, rows8 in rates.items():
        shown = {op: [None if r["device_gops"] is None else round(r["device_gops"], 3),
                      round(r["event_gops"], 3), r["spans"]] for op, r in rows8.items()}
        print(f"[8] K9 G ops/s at n=2^{log}, K={K9_K} ({card}), [by device time (profiler spans), by CUDA "
              f"events around the launches (wrapper included), spans recorded]: {json.dumps(shown)}")

    streamed_phase(dev, card, pk4, m4, proof, asg, r_, s_, rng, ks, g1_pool, g2_pool, on_path,
                   peak4)

    with tempfile.TemporaryDirectory(prefix="chip_smoke") as work:
        load9 = server_phase(dev, card, work, pk7, rows, circuit, asg, rng, on_path,
                             ["fr_binary", "fr_tile_scan", "ntt_rows_low", "ntt_rows_mid",
                              *ck.LAUNCHES])
        cli_phase(card, work, pk6, rows6, cs, on_path)
    msm_phase(dev, card, ks, g1_pool, g2_pool, gen, on_path)

    # ---- 14. the ceremony, the transforms, the iFFT H scalars, signed MSM, EVM
    t14 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke") as work:
        ceremony_phase(dev, card, work, pk7, rows, circuit, asg, r_, s_, wbits, cs, rng, on_path)
        transforms_phase(dev, card, gen, on_path)
        h_scalars_phase(dev, card, rng, on_path)
        signed_msm_phase(dev, card, ks, g1_pool, g2_pool, gen, on_path)
        evm_phase(work, pk6.vk, proof6, cs.get_public_inputs())
    print(f"[14] phase wall {time.perf_counter() - t14:.1f} s")

    # ---- 15. the witness engines; fullprove from inputs at 2^20; the native strip
    with tempfile.TemporaryDirectory(prefix="chip_smoke") as work:
        witness_phase(dev, card, work, pk7, rows, circuit, on_path,
                      ["fr_binary", "fr_tile_scan", "ntt_rows_low", "ntt_rows_mid", *ck.LAUNCHES],
                      load9)

    for name in ("ntt_rows_low", "ntt_rows_mid"):
        results[name].update(entry_kernels={f"ccf_ntt_rows_log{log}": r for log, r in ntt_res.items()})
    missing = [k2 for k2, row in results.items() if row["launches"] <= 0]
    if missing:
        raise AssertionError(f"no path counted launches of {missing}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print("no PyTorch call computes these kernels' functions: library_ms is null")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
