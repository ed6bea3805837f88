"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to one configuration, circuit, traffic mix or
per-layer metric is a file found by its name in BENCHMARK.json:
  configs/<config>.json   the deployment: its circuit generator and size,
                          domain, the MSM window the work counts use, the
                          pool of inputs;
  circuits/<generator>.py the circuit a configuration names under
                          "generator", in plain Python, numpy and torch,
                          importing nothing of the program:
                            shape(cfg)      num_constraints, n_vars,
                                            num_inputs (the constant one and
                                            the public signals, outputs
                                            first);
                            matrices(cfg)   A, B and C as COO (rows, cols,
                                            coeffs) under "a", "b", "c";
                            pool_input(cfg, rng)  a pool entry's input;
                            witness(cfg, x) the full assignment, Python ints;
                            signals(x)      the input JSON of the inputs
                                            traffic;
                            wasm(cfg)       its witness module, or None;
  traffic/<traffic>.json  the mix: which driver below and its sizes;
  metrics/<metric>.py     a reader `read(rec)` of one per-layer metric from
                          the traced run's record, None when it finds
                          nothing to read.

A driver is the one general generator of a kind of traffic, each one
closed-loop client: `server_wtns` (ProveServer.handle on a pool of witness
files) and `batch_inputs` (BatchProver.prove_many kept busy with the
window's inputs). Every request takes its input from the configuration's
pool of seeded inputs, so the check recomputes every answer.
The program under test is circom_compat_tpu_torch; the benchmark takes
from it only the system under test, its trace stages and launch counters.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import logging
import os
import random
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

import devtrace
import inputs
import reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CIRCUITS = HERE / "circuits"
COLLECT_SHARE = 0.5  # of a traced run's window: the stretch that reads the stages


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    return _load(HERE / "metrics" / f"{name}.py", f"proofbench_metric_{name}")


def load_generator(name: str):
    return _load(CIRCUITS / f"{name}.py", f"proofbench_circuit_{name}")


class CellError(Exception):
    """A cell that cannot run as BENCHMARK.json states it."""


def cell(bench: dict, workload: str):
    """(workload entry, config, traffic, its end-to-end metrics, its per-layer metrics)."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in moved else [])]
    return wl, cfg, traffic, e2e, per_layer


def request_rng(seed: int, *tag) -> random.Random:
    return random.Random(":".join(str(t) for t in (seed,) + tag))


def request_inputs(seed: int, cfg: dict, j: int, tag: str = "req"):
    """(p, r, s) of request j of a run: p is its pool entry, j mod
    witness_pool; r and s are the request's own."""
    rq = request_rng(seed, tag, j)
    r, s = rq.randrange(reference.R), rq.randrange(reference.R)
    return j % cfg["witness_pool"], r, s


def circuit_inputs(gen, cfg: dict, seed: int):
    """(the pooled key, the pool's inputs) of a configuration and seed."""
    key = inputs.PooledKey.make(gen.shape(cfg), gen.matrices(cfg), cfg["domain_size"],
                                request_rng(seed, "key"))
    pool = [gen.pool_input(cfg, request_rng(seed, "pool", p))
            for p in range(cfg["witness_pool"])]
    return key, pool


def launches_total() -> int:
    from circom_compat_tpu_torch.ops import curve_kernels, field_kernels

    return sum(field_kernels.LAUNCHES.values()) + sum(curve_kernels.LAUNCHES.values())


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _LogTap(logging.Handler):
    """Keeps the seconds of every `witness.calculate` stage the program's
    trace logger reports, from any thread."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seconds = []

    def emit(self, record):
        if record.args and record.args[0] == "witness.calculate":
            self.seconds.append(record.args[1] / 1e3)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


class ServerWtns:
    """Closed loop, one client: ProveServer.handle({"witness_file", "r",
    "s"}) on the next file of a pool of seeded witness files."""

    needs_wasm = False

    def __init__(self, cfg, traffic, gen, pool, wasm, zkey, tmp, seed, device, timings):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        t0 = time.perf_counter()
        self.files = []
        for p, x in enumerate(pool):
            path = os.path.join(tmp, f"w{p}.wtns")
            inputs.write_wtns(gen.witness(cfg, x), path)
            self.files.append(path)
        timings["inputs_wtns"] = time.perf_counter() - t0
        from circom_compat_tpu_torch.server import ProveServer

        t0 = time.perf_counter()
        self.server = ProveServer(zkey, device=device)
        timings["zkey_load"] = self.server.load_s
        timings["key_stage"] = self.server.stage_s
        t0 = time.perf_counter()
        self.server.warmup()
        timings["warmup"] = time.perf_counter() - t0
        self.n = 0

    def _one(self, answers):
        j = self.n
        self.n += 1
        p, r, s = request_inputs(self.seed, self.cfg, j)
        path = self.files[p]
        ans = {"pool": p, "r": r, "s": s, "proof": None, "public": None, "error": None}
        t0 = time.perf_counter()
        try:
            resp = self.server.handle({"witness_file": path, "r": str(r), "s": str(s)})
        except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
            resp = {"ok": False, "error": repr(e)[:300]}
        ans["latency"] = time.perf_counter() - t0
        if resp.get("ok"):
            ans["proof"] = reference.proof_tuple(resp["proof"])
            ans["public"] = [int(v) for v in resp["public"]]
            ans["prove_s"] = resp["prove_s"]
        else:
            ans["error"] = resp.get("error", "not ok")
        answers.append(ans)
        return ans

    def window(self, seconds, answers):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._one(answers)
        return time.perf_counter() - t0

    def collect(self, seconds, answers, rec):
        """The traced run's first stretch: the stage means and launches."""
        from circom_compat_tpu_torch.utils import trace

        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            before = launches_total()
            with trace.collect() as tr:
                ans = self._one(answers)
            rec["launches"].append(launches_total() - before)
            if ans["error"] is None:
                rec["handle"].append([ans["latency"], ans["prove_s"]])
            for path, sec in tr.stages:
                rec["stages"].setdefault(path, []).append(sec)

    def profiled(self, answers, rec):
        """The traced run's second stretch, under the profiler."""
        t0 = time.perf_counter()
        first = len(answers)
        while (time.perf_counter() - t0 < self.traffic["profile_seconds"]
               or len(answers) - first < self.traffic["profile_min_requests"]):
            with torch.profiler.record_function(devtrace.REQUEST):
                self._one(answers)
        rec["profiled"] = answers[first:]

    def close(self):
        del self.server


class BatchInputs:
    """One closed-loop client on BatchProver(engine, workers).prove_many,
    the pool's inputs as the circuit's input signals, with given r and s.
    prove_many takes a finite list, so a stretch of the window goes to it in
    a few calls with no fixed size: the first fills half the stretch at the
    rate known before it (from the warm-up, or the stretch before), so a
    rate that was too high costs no more than the stretch again; each next
    fills the time left at the rate measured in the stretch, until less
    than half a proof's time is left."""

    needs_wasm = True

    def __init__(self, cfg, traffic, gen, pool, wasm, zkey, tmp, seed, device, timings):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.signals = [gen.signals(x) for x in pool]
        from circom_compat_tpu_torch.circom.zkey import read_zkey
        from circom_compat_tpu_torch.models import groth16_device as gd
        from circom_compat_tpu_torch.models.batch import BatchProver

        t0 = time.perf_counter()
        pk, matrices = read_zkey(zkey)
        timings["zkey_load"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dpk = gd.DeviceProvingKey.build(pk, matrices, matrices.num_constraints, device=device)
        timings["key_stage"] = time.perf_counter() - t0
        self.bp = BatchProver(dpk, wasm, workers=traffic["workers"], engine=traffic["engine"])
        self.n, self.calls = 0, 0
        t0 = time.perf_counter()
        warm = traffic["warmup_proofs"]
        self._call(warm, [], tag="warm")  # builds the witness engines, warms every shape
        timings["warmup"] = time.perf_counter() - t0
        self.rate = warm / timings["warmup"]  # proofs a second, before the first stretch

    def _call(self, size, answers, tag="req"):
        first = self.n if tag == "req" else 0
        if tag == "req":
            self.n += size
            self.calls += 1
        reqs = []
        for j in range(first, first + size):
            p, r, s = request_inputs(self.seed, self.cfg, j, tag)
            reqs.append({"pool": p, "r": r, "s": s, "proof": None, "public": None, "error": None})
        try:
            results = self.bp.prove_many([self.signals[q["pool"]] for q in reqs],
                                         rs=[(q["r"], q["s"]) for q in reqs],
                                         inflight=self.traffic["inflight"])
        except Exception as e:  # noqa: BLE001 - a failed call is counted, not fatal
            results = [None] * len(reqs)
            for q in reqs:
                q["error"] = repr(e)[:300]
        results = list(results) + [None] * (len(reqs) - len(results))
        for q, res in zip(reqs, results):
            if res is None:
                q["error"] = q["error"] or "no result"
            else:
                p = res.proof
                q["proof"] = (p.a, p.b, p.c)
                q["public"] = [int(v) for v in res.public_inputs]
        answers.extend(reqs)

    def _stretch(self, seconds, answers):
        t0, first, calls = time.perf_counter(), len(answers), 0
        while True:
            elapsed = time.perf_counter() - t0
            size = round((seconds - elapsed) * self.rate / (1 if calls else 2))
            if calls and size < 1:
                return elapsed
            self._call(max(size, 1), answers)
            calls += 1
            self.rate = (len(answers) - first) / (time.perf_counter() - t0)

    def window(self, seconds, answers):
        return self._stretch(seconds, answers)

    def collect(self, seconds, answers, rec):
        """The traced run's first stretch: the witness stage from the
        program's trace logger, which every thread reports to."""
        from circom_compat_tpu_torch.utils import trace

        tap = _LogTap()
        log = trace.logger
        level, propagate = log.level, log.propagate
        log.addHandler(tap)
        log.setLevel(logging.INFO)
        log.propagate = False
        os.environ["CIRCOM_TPU_TIMINGS"] = "1"
        try:
            self._stretch(seconds, answers)
        finally:
            os.environ.pop("CIRCOM_TPU_TIMINGS", None)
            log.removeHandler(tap)
            log.setLevel(level)
            log.propagate = propagate
        rec["logged"]["witness.calculate"] = tap.seconds

    def profiled(self, answers, rec):
        first = len(answers)
        with torch.profiler.record_function(devtrace.REQUEST):
            self._stretch(self.traffic["profile_seconds"], answers)
        rec["profiled"] = answers[first:]

    def close(self):
        del self.bp


DRIVERS = {"server_wtns": ServerWtns, "batch_inputs": BatchInputs}
STAGES = ("prove.encode", "prove.witness_map", "prove.msm", "sorts", "msm_g1", "msm_g2",
          "prove.assemble", "readback", "fold", "witness.calculate")


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------


def check(key, witness, pool, answers, device):
    """Recompute the expected proof of every answer with the plain
    reference (h once for each input of the pool; `witness(x)` the
    generator's, bound to its configuration) and compare. Returns
    (compared numbers, the reference's scalars by pool entry)."""
    ref = reference.Reference(key, witness, device)
    done = [a for a in answers if a["error"] is None]
    scalars, wrong = {}, 0
    for ans in done:
        p = ans["pool"]
        if p not in scalars:
            scalars[p] = ref.scalars(pool[p])
        sc = scalars[p]
        exp = ref.proof(sc["dots"], ans["r"], ans["s"])
        if tuple(ans["proof"]) != exp or ans["public"] != sc["public"]:
            wrong += 1
    compared = {
        "answers_wrong": {"value": wrong, "limit": 0},
        "answers_missing": {"value": len(answers) - len(done), "limit": 0},
        "answers_checked": {"value": len(done), "limit": 1, "at_least": True},
    }
    return compared, scalars


def is_correct(compared: dict) -> bool:
    for c in compared.values():
        if c.get("at_least"):
            if c["value"] < c["limit"]:
                return False
        elif c["value"] > c["limit"]:
            return False
    return True


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------


def run(workload: str, seed: int, seconds: float, traced: bool, device, t_start: float,
        bench: dict = None, traffic_overrides: dict = None) -> dict:
    """One run of `workload`; `bench` and `traffic_overrides` (shorter
    profiled stretches) serve the tests."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    wl, cfg, traffic, e2e, per_layer = cell(bench, workload)
    traffic = dict(traffic, **(traffic_overrides or {}))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gen = load_generator(cfg["generator"])
    drive = DRIVERS[traffic["driver"]]
    timings = {}
    wasm = None
    if drive.needs_wasm:
        t0 = time.perf_counter()
        wasm = gen.wasm(cfg)
        timings["inputs_wasm"] = time.perf_counter() - t0
        if wasm is None:
            raise CellError(f"{workload}: traffic {wl['traffic']!r} sends inputs to a witness "
                            f"module, and circuit {cfg['generator']!r} has none")
    t0 = time.perf_counter()
    key, pool = circuit_inputs(gen, cfg, seed)
    timings["inputs_key"] = time.perf_counter() - t0
    if cuda:
        from circom_compat_tpu_torch import _build

        t0 = time.perf_counter()
        _build.build_all()
        timings["kernels_build_or_load"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="proofbench-")
    rec = {"config": cfg, "traffic": traffic, "stages": {}, "handle": [], "launches": [],
           "logged": {}, "profile": None, "profiled": [], "scalars": {},
           "peaks": load_json(HERE / "peaks.json")}
    answers = []
    try:
        t0 = time.perf_counter()
        zkey = os.path.join(tmp, "key.zkey")
        zkey_bytes = key.write_zkey(zkey)
        timings["inputs_zkey_write"] = time.perf_counter() - t0
        driver = drive(cfg, traffic, gen, pool, wasm, zkey, tmp, seed, dev, timings)
        sync(dev)
        setup_s = time.perf_counter() - t_start
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        if not traced:
            window_s = driver.window(seconds, answers)
        else:
            from circom_compat_tpu_torch.utils import trace

            driver.collect(seconds * COLLECT_SHARE, answers, rec)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with devtrace.stage_ranges(trace):
                with torch.profiler.profile(activities=activities) as prof:
                    with torch.profiler.record_function(devtrace.WINDOW):
                        driver.profiled(answers, rec)
                        sync(dev)
            window_s = None
            rec["profile"] = devtrace.read_capture(prof, STAGES)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        calls = getattr(driver, "calls", None)
        driver.close()
        del driver
        if cuda:
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    t0 = time.perf_counter()
    compared, scalars = check(key, functools.partial(gen.witness, cfg), pool, answers, dev)
    rec["scalars"] = scalars
    check_s = time.perf_counter() - t0

    metrics = {}
    if not traced:
        done = [a for a in answers if a["error"] is None]
        lat = sorted(a["latency"] for a in done if "latency" in a)
        values = {
            "prove_s": window_s / max(len(done), 1),
            "prove_p95_s": (statistics.quantiles(lat, n=20, method="inclusive")[-1]
                            if len(lat) >= 2 else None),
            "proofs_per_s": len(done) / window_s,
            "peak_mem_gb": peak / 1e9,
            "setup_s": setup_s,
        }
        for m in e2e:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in per_layer:
            v = load_metric(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    result = {
        "correct": is_correct(compared),
        "attempted": len(answers),
        "failed": sum(a["error"] is not None for a in answers),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": 1, "memory_peak_bytes": peak},
    }
    result["setup"] = dict(timings, setup_s=setup_s, zkey_bytes=zkey_bytes)
    result["run"] = {"workload": workload, "seed": seed, "seconds": seconds, "traced": traced,
                     "window_s": window_s, "check_s": check_s, "calls": calls,
                     "errors": sorted({a["error"] for a in answers if a["error"]})[:3]}
    if traced:
        prof = rec["profile"]
        result["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = prof["breakdown"]
        result["run"].update({k: prof[k] for k in
                              ("device_events", "device_events_linked", "stage_device_s")})
    result["compared"] = compared
    return result


def report(result: dict) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line on standard output."""
    compared = result["compared"]
    for name, c in compared.items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"compared {name} {c['value']} (limit {rel} {c['limit']})", file=sys.stderr)
    line = {k: v for k, v in result.items() if k != "compared"}
    line["compared"] = compared  # the compared numbers come last
    print(json.dumps(line), flush=True)
