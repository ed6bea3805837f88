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
     over the level-0 carries: 5,242,880 G1, 1,310,720 G2);
  3. each kernel's time (CUDA events, warmed up, averaged), its bound and
     the plain version's time; K3/K4's bounds count the butterflies whose
     twiddle is not one, and their rows are also checked and timed at the
     2^13 flat chain's shape (16 rows of 512: DIF, DIT + pre); K5's fused
     stages at the flat chain's shapes (all high stages of a 2^10 to 2^13
     transform, DIF and DIT) and as one stage at 2^20, with the profiler's
     device time beside the event time (at 2^13 an event time per call is
     mostly the host's); K2 also at a ragged T;
  4. the main path: a 2^20-domain squaring-chain proof through
     DeviceProvingKey.from_matrix_rows and prove_prepared, against a
     synthetic key whose every point has a known discrete log, so the host
     knows A, B and C exactly; h is also held against the plain witness
     map run on the card; after the timed proves, one prove under
     torch.profiler: the top device kernels, the device's idle share and
     each of the port's kernel families' summed device time and launches;
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
  8. the K9 microbenchmark (ops/field_bench.run): G ops/s of each Fq op;
  9. the prove server at 2^20: phase 7's key written with write_zkey and the
     chain's assignment with write_wtns; a ProveServer on a unix socket
     (staged keys released first) answers a ping, three witness_file
     requests, one with fixed r/s that must equal
     Groth16.create_proof_with_reduction_and_matrices on the same key byte
     for byte, ok: false to a malformed request, then one more proof; one
     served proof verified by pairing; load, staging, warm-up, each
     request's prove_s and the peak device memory;
 10. the CLI at 2^13 (`cli.main`, on the card by default): phase 6's key
     written to a file; prove (which must launch fr_butterfly_stages),
     export-vkey, verify (0; 1 for a tampered public input) and
     export-calldata (the ethereum.Proof tuple);
 11. the standalone msm_g1 / msm_g2 at 2^20 points of known discrete logs
     from phase 4's pools: equal to (sum s_i k_i) G, then points/s (median
     of 3 after the checked call).
Phases 2-3 also hold the flat chain's stage kernel (2^10 to 2^13 and 2^20), the Fq
binary modes (2^20) and the K9 op chain (2^16 elements, K = 64) against
their plain versions. Each kernel's launches are counted on the path that
runs it (phase 4, 6 or 7, or 8 for K9), the counts set to 0 just before;
phases 9-11 count theirs the same way (launches_by_path on the kernels
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
    """Mean device time per call of fn() over reps calls under
    torch.profiler, summed over the device kernels whose names hold
    `match`; None when the profiler recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
    return sum(spans) / 1e3 / reps if spans else None


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


def synthetic_key(k, rng, ks, g1_pool, g2_pool, device):
    """The squaring chain with k constraints (domain k + 2) and a staged
    proving key whose every point has a known discrete log: query row i of
    a section is k_((i + offset) mod POOL) times the generator, three rows
    per section are infinity, and alpha, beta, gamma, delta are seeded.
    Returns (circuit, its (A, B, C) rows, DeviceProvingKey, the secrets)."""
    from circom_compat_tpu_torch.circom.zkey import G1Section, G2Section, ProvingKey, VerifyingKey
    from circom_compat_tpu_torch.constants import R_SCALAR
    from circom_compat_tpu_torch.models import groth16_device as gd
    from circom_compat_tpu_torch.ops import curve as cv
    from circom_compat_tpu_torch.refmath import curve as rc
    from circom_compat_tpu_torch.utils.chain import chain_circuit

    circuit = chain_circuit(k=k, a=3)
    rows = circuit.to_matrices()  # once: 3 (k,)-row lists at 2^20
    n_vars, n_pub, n = k + 2, 1, k + 2
    pools = {False: cv.encode_g1_affine(g1_pool).view(np.uint16).reshape(POOL, 2, 16),
             True: cv.encode_g2_affine(g2_pool).view(np.uint16).reshape(POOL, 4, 16)}
    offsets = {"a": 0, "b1": 101, "l": 202, "h": 303, "b2": 404}

    def section(name, length):
        idx = (np.arange(length) + offsets[name]) % POOL
        limbs = pools[name == "b2"][idx].copy()
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
    dpk = gd.DeviceProvingKey.from_matrix_rows(pk, rows[0], rows[1], 2, k, device=device)
    secret = dict(alpha=alpha, beta=beta, delta=delta,
                  dlogs={name: sec[1] for name, sec in secs.items()})
    return circuit, rows, dpk, secret


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
    verified by pairing."""
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


def cli_phase(card, work, pk, rows, circuit, on_path):
    """[10] The CLI on its default device: prove, export-vkey, verify (and a
    tampered public input), export-calldata against the ethereum.Proof tuple."""
    import contextlib

    from circom_compat_tpu_torch import cli
    from circom_compat_tpu_torch import ethereum as eth
    from circom_compat_tpu_torch.circom.wtns import write_wtns
    from circom_compat_tpu_torch.circom.zkey_writer import write_zkey
    from circom_compat_tpu_torch.constants import R_SCALAR as R

    f = {name: str(Path(work) / name) for name in
         ("small.zkey", "small.wtns", "proof.json", "public.json", "vk.json", "bad.json")}
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
    mad_rate = 64 * 132 * clock_mhz * 1e6  # 32-bit integer multiply-adds per second
    mem_rate = 3.35e12
    MAD = 264  # multiply-adds per Montgomery multiply (csrc/field.cuh)

    def bound(nbytes, mads):
        tb, to = nbytes / mem_rate * 1e3, mads / mad_rate * 1e3
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

    def check(name, kernel_fn, plain_fn, reps, nbytes, mads, replaces, source, note="", device=None):
        """Kernel vs plain on the same inputs (word for word), then the
        kernel's time (and, given `device`, a substring of its kernel's
        name, its profiler device time); the first check of a name makes
        its kernels row."""
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
        b_ms, b_by = bound(nbytes, mads)
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
        if name.startswith("ntt_rows") or name in ("fr_butterfly_stage", "fr_tile_scan"):
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
              20, 96 * n, (MAD if op.startswith("mul") else 0) * n, f"{FP}:84", FSRC, f" {op}")
    elem = a[5].clone()
    check("fr_binary", lambda: fk.fr_binary("mul", a, elem), lambda: fk.fr_binary_plain("mul", a, elem),
          20, 64 * n, MAD * n, f"{FP}:84", FSRC, " mul by one broadcast element")

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
              20, 96 * n, (MAD if op.startswith("mul") else 0) * n, f"{FP}:84", FSRC, f" {op}")
    elem = a[5].clone()
    check("f_binary_fq", lambda: fk.fr_binary("mul", a, elem, fl.FQ),
          lambda: fk.fr_binary_plain("mul", a, elem, fl.FQ),
          20, 64 * n, MAD * n, f"{FP}:84", FSRC, " mul by one broadcast element")
    del a, b

    # K9: K dependent steps of one Fq op per element
    ka, kb = fbn.operands(K9_N, device=dev)
    for op in fbn.OPS:
        check("fq_op_chain", lambda: fbn.fq_op_chain(op, ka, kb, K9_K),
              lambda: fbn.fq_op_chain_plain(op, ka, kb, K9_K),
              10, 96 * K9_N, fbn.INT_OPS[op] * K9_K * K9_N,
              "scripts/bench_field_ops.py:79", FSRC, f" {op}, n=2^16, K={K9_K}")
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

    # ---- 4. main path at a 2^20 domain --------------------------------------
    from circom_compat_tpu_torch.models import groth16_device as gd

    t0 = time.perf_counter()
    circuit, rows, dpk, secret = synthetic_key(n - 2, rng, ks, g1_pool, g2_pool, dev)
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
    print(f"[4] steady-state prove at 2^{LOG_N}: median {med:.4f} s of {totals} "
          f"({card}); peak device memory {torch.cuda.max_memory_allocated()} B")
    print("[4] stages (median s): " + json.dumps({k2: round(v, 4) for k2, v in stage_med.items()}))
    profile_prove(lambda: gd.prove_prepared(dpk, r_, s_, asg, wbits), 4, f"2^{LOG_N}")

    # h of the port, and the same witness map through the plain versions
    asg_dev = torch.from_numpy(gd.encode_assignment(asg)).to(dev)
    asg_mont = fk.fr_to_mont(asg_dev)
    h = fk.fr_from_mont(gd.witness_map(dpk, asg_mont))
    h_plain = fk.fr_binary_plain("mul_canon", gd.witness_map(dpk, asg_mont, ops=fk.PLAIN),
                                 torch.tensor(lc.ints_to_words([1])[0], device=dev))
    if max_abs_err(h, h_plain) != 0:
        raise AssertionError("witness map differs from its plain version on the card")
    h_ints = lc.words_to_ints(h.cpu().numpy())
    assert proof == expected_proof(secret, asg, h_ints, r_, s_), \
        "proof differs from the host's known-dlog A, B, C"
    print("[4] proof equals the host's known-dlog A, B, C; h equals the plain witness map")
    del dpk
    torch.cuda.empty_cache()

    # ---- 5. golden ----------------------------------------------------------
    from circom_compat_tpu_torch.circom.zkey import read_zkey
    from circom_compat_tpu_torch.models.groth16 import Groth16
    from circom_compat_tpu_torch.utils.chain import chain_circuit

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

    def reset_all():
        fk.reset_launches()
        ck.reset_launches()
        fbn.reset_launches()

    def counts():
        return {**fk.LAUNCHES, **ck.LAUNCHES, **fbn.LAUNCHES}

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
    h6 = fk.fr_from_mont(gd.witness_map(dpk6, asg6_mont))
    h6_plain = fk.fr_binary_plain("mul_canon", gd.witness_map(dpk6, asg6_mont, ops=fk.PLAIN),
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
    rates = fbn.run(K9_N, K9_K, device=dev)
    take_launches(counts(), ["fq_op_chain"], "the K9 microbenchmark")
    print(f"[8] K9 G ops/s (n=2^16, K={K9_K}; {card}): "
          + json.dumps({k2: round(v, 3) for k2, v in rates.items()}))

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

    with tempfile.TemporaryDirectory(prefix="chip_smoke") as work:
        server_phase(dev, card, work, pk7, rows, circuit, asg, rng, on_path,
                     ["fr_binary", "fr_tile_scan", "ntt_rows_low", "ntt_rows_mid", *ck.LAUNCHES])
        cli_phase(card, work, pk6, rows6, cs, on_path)
    msm_phase(dev, card, ks, g1_pool, g2_pool, gen, on_path)

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
