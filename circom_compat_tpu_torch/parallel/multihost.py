"""Multi-process execution over torch.distributed (the JAX package's
parallel/multihost.py, whose processes meet in jax.distributed).

  initialize()          torch.distributed.init_process_group over tcp://
  global_mesh()         this process's mesh of its local shards, in a
                        global 1-D layout of processes x local shards
  two_level_mesh()      the same shards in a (dcn, shards) layout
  build_multihost_prover / prove_multihost
                        a Groth16 prove whose MSMs are sharded over every
                        shard of every process; every process receives the
                        same window sums and assembles the same proof
  dist_dryrun           N local worker processes (dist_worker_main), their
                        proofs held against each other and against the
                        single-process prove

Each process drives its own shards as prove_sharded.py does. Only the
window sums cross processes, as in the JAX package (multihost.py:115-250):
a torch.distributed all_gather of the G1 (4, W, 3, 8) and G2 (W, 3, 2, 8)
sums, a few KB, then the K6/K7 tree fold. On the global mesh every
shard's sums cross and one fold runs over all of them; on the two-level
mesh each process folds its shards first and only one sum a process
crosses. The witness map runs replicated, once in each process on its lead
device (the single-card witness map).

Process p's M local shards lie on the cards (p M + i) mod device_count, so
on one card every shard of every process lies on cuda:0. The backend is
NCCL on cards and gloo on the CPU unless named. NCCL refuses two ranks on
one card: initialize raises there rather than switch, and ranks that
share a card must name gloo. Gloo's collectives are host collectives: with
gloo the sums go to the host for the all_gather and back.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import torch
import torch.distributed as dist

from ..models import groth16_device as gd
from ..models.groth16 import Proof
from ..ops import curve_kernels as ck
from ..ops import field_kernels as fk
from ..utils import trace
from . import prove_sharded as ps
from .mesh import SHARD_AXIS, Mesh, all_gather, copy_to, make_mesh, tree_fold
from .msm_sharded import fold_shard_sums

DCN_AXIS = "dcn"
TIMEOUT = datetime.timedelta(seconds=1800)  # a collective waits this long for its peers

_STATE: dict = {}  # this process's shard devices, set by initialize()


def _local_devices(platform: str, process_id: int, m: int) -> List[torch.device]:
    if platform == "cpu":
        return [torch.device("cpu")] * m
    count = torch.cuda.device_count()
    return [torch.device("cuda", (process_id * m + i) % count) for i in range(m)]


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               local_device_count: Optional[int] = None, platform: Optional[str] = None,
               backend: Optional[str] = None) -> None:
    """Join this process to the process group. coordinator_address is
    host:port of rank 0's rendezvous (tcp://host:port also taken);
    local_device_count the shards this process drives (default: one a card,
    or one on the CPU); platform "cuda" (the default) or "cpu"; backend
    "nccl" (the default on cards) or "gloo" (on the CPU, and for ranks that
    share a card)."""
    if platform is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass platform='cpu' to initialize "
                               "to run the processes on the CPU")
        platform = "cuda"
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"platform must be 'cuda' or 'cpu', not {platform!r}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("platform='cuda' but no CUDA device is available")
    m = local_device_count or (torch.cuda.device_count() if platform == "cuda" else 1)
    backend = backend or ("nccl" if platform == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if backend == "nccl":
        if platform == "cpu":
            raise ValueError("backend='nccl' runs on cards; the CPU takes backend='gloo'")
        leads = {(p * m) % torch.cuda.device_count() for p in range(num_processes)}
        if len(leads) < num_processes:
            raise ValueError(
                f"backend='nccl' refuses two ranks on one card: {num_processes} processes of "
                f"{m} shards on {torch.cuda.device_count()} card(s); pass backend='gloo'")
    devices = _local_devices(platform, process_id, m)
    bound = {}
    if backend == "nccl":  # the rank's card: NCCL would otherwise guess cuda:<rank> in barrier()
        torch.cuda.set_device(devices[0])
        bound["device_id"] = devices[0]
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT, **bound)
    _STATE["devices"] = devices


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This process's shards (`local`) in a layout over every process:
    axis_names ("shards",) for the global 1-D mesh, ("dcn", "shards") for
    the two-level one."""

    local: Mesh
    num_processes: int
    process_id: int
    axis_names: tuple

    @property
    def shape(self) -> dict:
        if self.axis_names == (SHARD_AXIS,):
            return {SHARD_AXIS: self.num_processes * self.local.size}
        return {DCN_AXIS: self.num_processes, SHARD_AXIS: self.local.size}

    @property
    def size(self) -> int:
        return self.num_processes * self.local.size


def _process_mesh(axis_names: tuple) -> ProcessMesh:
    if not dist.is_initialized():
        raise RuntimeError("call initialize() first")
    local = make_mesh(devices=_STATE["devices"])
    P = dist.get_world_size()
    total = P * local.size
    if total & (total - 1):
        raise ValueError(f"{P} processes of {local.size} shards: the shards' count must be a "
                         "power of two for the tree folds")
    return ProcessMesh(local, P, dist.get_rank(), axis_names)


def global_mesh() -> ProcessMesh:
    """Every shard of every process on one axis, process-major."""
    return _process_mesh((SHARD_AXIS,))


def two_level_mesh() -> ProcessMesh:
    """(dcn, shards): processes on the outer axis, each one's shards on the
    inner; only one folded sum a process crosses between processes."""
    return _process_mesh((DCN_AXIS, SHARD_AXIS))


def _all_gather_processes(x: torch.Tensor) -> torch.Tensor:
    """(P * x.shape[0], ...) on x's device: every process's x, rank-major."""
    P = dist.get_world_size()
    buf = x.cpu() if dist.get_backend() == "gloo" else x.contiguous()
    parts = [torch.empty_like(buf) for _ in range(P)]
    dist.all_gather(parts, buf)
    return copy_to(torch.cat(parts), x.device)


@dataclasses.dataclass
class MultihostProver:
    dpk: gd.DeviceProvingKey
    mesh: ProcessMesh
    window_bits: int
    sharded: ps.ShardedProver


def build_multihost_prover(dpk: gd.DeviceProvingKey, mesh: ProcessMesh,
                           window_bits: Optional[int] = None) -> MultihostProver:
    """Stage this process's shards of dpk's padded query stack (global
    shards p M .. p M + M - 1 of P M), then wait for every process."""
    M, P = mesh.local.size, mesh.num_processes
    with trace.span("key.stage", mesh.local):
        sharded = ps._build(dpk, mesh.local, P * M, range(mesh.process_id * M,
                                                         (mesh.process_id + 1) * M),
                            window_bits, dist_ntt=False)
    dist.barrier()
    return MultihostProver(dpk, mesh, sharded.window_bits, sharded)


def prove_multihost(prover: MultihostProver, r: int, s: int, full_assignment,
                    stage_times: Optional[dict] = None) -> Proof:
    """The sharded prove with the window sums gathered over every process;
    the same proof on every process, equal to prove_prepared's."""
    mesh = prover.mesh
    lead = mesh.local.lead

    def gather(g1, g2):
        if mesh.axis_names == (SHARD_AXIS,):  # every shard's sums cross, one fold
            return tuple(tree_fold(ck.point_add, _all_gather_processes(all_gather(x, [lead])[0]),
                                   mesh.size) for x in (g1, g2))
        return tuple(tree_fold(ck.point_add, _all_gather_processes(fold_shard_sums(x, lead)[None]),
                               mesh.num_processes) for x in (g1, g2))

    with gd.timed_stages(stage_times, ps._SHARDED_KEYS):
        return ps.sharded_proof(prover.sharded, r, s, full_assignment, gather)


# ---------------------------------------------------------------------------
# the local dry run
# ---------------------------------------------------------------------------


def proof_record(proof: Proof) -> dict:
    return {"a": [str(c) for c in proof.a],
            "b": [[str(c) for c in pair] for pair in proof.b],
            "c": [str(c) for c in proof.c]}


def dist_worker_main(process_id: int, num_processes: int, coordinator: str, local_devices: int,
                     out_path: str, zkey: str, chain_k: int = 62, two_level: bool = False,
                     platform: Optional[str] = None, backend: Optional[str] = None,
                     r: int = 0xAA, s: int = 0xBB, window_bits: Optional[int] = None) -> None:
    """One dry-run process: join the group, stage the chain's key (zkey)
    over its shards, prove the chain's assignment, write its record (with
    the kernel launches of the prove, counted in this process)."""
    from ..circom.zkey import read_zkey
    from ..utils.chain import chain_witness

    initialize(coordinator, num_processes, process_id, local_devices, platform, backend)
    mesh = two_level_mesh() if two_level else global_mesh()
    pk, matrices = read_zkey(zkey)
    dpk = gd.DeviceProvingKey.build(pk, matrices, matrices.num_constraints, device=mesh.local.lead)
    prover = build_multihost_prover(dpk, mesh, window_bits)
    times = {}
    fk.reset_launches()
    ck.reset_launches()
    t0 = time.perf_counter()
    proof = prove_multihost(prover, r, s, chain_witness(chain_k, a=3), stage_times=times)
    record = {"process_id": process_id, "devices": mesh.size, "processes": mesh.num_processes,
              "mesh": mesh.shape, "physical_devices": mesh.local.physical(),
              "backend": dist.get_backend(), "window_bits": prover.window_bits,
              "prove_s": time.perf_counter() - t0, "stages": times,
              "launches": {**fk.LAUNCHES, **ck.LAUNCHES}, "proof": proof_record(proof)}
    Path(out_path).write_text(json.dumps(record))
    dist.barrier()  # every record is written before any process leaves the group
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def dist_dryrun(num_processes: int = 2, local_devices: int = 2, chain_k: int = 62,
                two_level: bool = False, timeout: float = 900.0, device=None,
                backend: Optional[str] = None, r: int = 0xAA, s: int = 0xBB,
                window_bits: Optional[int] = None) -> dict:
    """Run num_processes local worker processes, each with local_devices
    shards, on the chain of chain_k constraints (its key from
    generate_parameters_from_matrices with the JAX dry run's toxic waste,
    made once here and written as a zkey), and check that every proof
    equals the others and the single-process prove_prepared on `device`,
    which runs while the workers do. `device` (default: the card) sets the
    workers' platform. Returns process 0's record with the wall times;
    raises on any failure or mismatch, and stops every worker it started."""
    from ..circom.zkey import read_zkey
    from ..circom.zkey_writer import write_zkey
    from ..device import resolve_device
    from ..models import generate_parameters_from_matrices
    from ..utils.chain import chain_circuit

    dev = resolve_device(device)
    t_start = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="dist_dryrun_"))
    procs: List[subprocess.Popen] = []
    try:
        circuit = chain_circuit(k=chain_k, a=3)
        ma, mb, mc = circuit.to_matrices()
        pk = generate_parameters_from_matrices(
            ma, mb, mc, circuit.r1cs.num_inputs, circuit.r1cs.num_variables,
            alpha=0xA, beta=0xB, gamma=0xC, delta=0xD, t=0xE1, device=dev)
        zkey = work / "chain.zkey"
        write_zkey(str(zkey), pk, ma, mb, len(ma))
        setup_s = time.perf_counter() - t_start

        coordinator = f"127.0.0.1:{_free_port()}"
        outs = [work / f"proof_{i}.json" for i in range(num_processes)]
        code = ("import sys\n"
                "from circom_compat_tpu_torch.parallel.multihost import dist_worker_main\n"
                "a = sys.argv\n"
                "dist_worker_main(int(a[1]), int(a[2]), a[3], int(a[4]), a[5], a[6], int(a[7]),\n"
                "                 bool(int(a[8])), a[9], a[10] or None, int(a[11]), int(a[12]),\n"
                "                 int(a[13]) or None)\n")
        env = dict(os.environ)
        root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(x for x in (root, env.get("PYTHONPATH")) if x)
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks meet on the loopback
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if dev.type == "cpu":
            env.setdefault("OMP_NUM_THREADS", "1")  # the workers share this host's cores
        t0 = time.perf_counter()
        for i in range(num_processes):
            with open(work / f"worker_{i}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, str(i), str(num_processes), coordinator,
                     str(local_devices), str(outs[i]), str(zkey), str(chain_k),
                     str(int(two_level)), dev.type, backend or "", str(r), str(s),
                     str(window_bits or 0)],
                    env=env, stdout=log, stderr=subprocess.STDOUT))

        pk_r, m_r = read_zkey(str(zkey))
        single = gd.prove_prepared(gd.DeviceProvingKey.build(pk_r, m_r, m_r.num_constraints,
                                                             device=dev),
                                   r, s, circuit.full_assignment(), window_bits)
        single_s = time.perf_counter() - t0

        deadline = t0 + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
        workers_s = time.perf_counter() - t0
        failed = [(i, p.poll()) for i, p in enumerate(procs) if p.poll() != 0]
        if failed:
            logs = {i: (work / f"worker_{i}.log").read_text()[-3000:] for i, _ in failed}
            raise RuntimeError(f"dist workers failed or timed out (process, rc): {failed}\n{logs}")

        records = [json.loads(o.read_text()) for o in outs]
        proofs = [rec["proof"] for rec in records]
        if any(p != proofs[0] for p in proofs[1:]):
            raise RuntimeError("the worker proofs disagree")
        if proofs[0] != proof_record(single):
            raise RuntimeError("the multi-process proof differs from the single-process proof")
        return {**records[0], "proof_matches_single_process": True, "setup_s": setup_s,
                "single_process_s": single_s, "workers_s": workers_s,
                "wall_s": time.perf_counter() - t_start,
                "worker_prove_s": [rec["prove_s"] for rec in records]}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(work, ignore_errors=True)
