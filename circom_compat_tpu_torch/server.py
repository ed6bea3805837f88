"""Prove server: load and stage once, serve many Groth16 proofs.

A resident process reads the zkey, stages the DeviceProvingKey on the card
(unless `device` names another device) and warms up once: the first prove
builds the kernels and stages the NTT plan's tables. Every request after
that proves at steady-state latency over a unix socket.

Protocol: newline-delimited JSON over SOCK_STREAM.

  request:  {"inputs": {...}}              (needs a wasm at server start)
            {"witness": ["1", "33", ...]}  (decimal strings or ints)
            {"witness_file": "path.wtns"}  (read as (N, 16) limbs: no Python-int pass)
            optional "r"/"s" decimal strings (omitted -> fresh randoms)
            {"cmd": "ping"} | {"cmd": "shutdown"}
  response: {"ok": true, "proof": {...}, "public": [...], "prove_s": ...}
            {"ok": false, "error": "..."}

One connection may carry many requests; requests are served one at a time
(one card). See cli.py `serve` / `prove-client`. Each prove request is one
trace request (utils/trace.py): the span server.handle holds
server.read_wtns, server.public, server.prove (the prove's own stages) and
server.respond.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Optional

import numpy as np

# the CLI's encoder, with its point-at-infinity encodings
from .cli import _proof_to_json
from .utils import trace


class ProveServer:
    """Resident prover: a staged key fed requests."""

    def __init__(self, zkey_path: str, wasm_path: Optional[str] = None, device=None,
                 engine: str = "aot"):
        from .circom.zkey import read_zkey
        from .models import groth16_device as gd

        t0 = time.perf_counter()
        self.pk, self.matrices = read_zkey(zkey_path)
        self.load_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.dpk = gd.DeviceProvingKey.build(self.pk, self.matrices,
                                             self.matrices.num_constraints, device=device)
        self.stage_s = time.perf_counter() - t0

        self.wc = None
        if wasm_path:
            from .witness import WitnessCalculator

            self.wc = WitnessCalculator.from_file(wasm_path, engine=engine)

        self._gd = gd
        self.window_bits = gd.default_window_bits(self.dpk)
        self.compile_s = None
        self.n_proofs = 0

    def warmup(self) -> float:
        """One prove on an assignment of ones (the result is discarded):
        builds the kernels, stages the plan and runs every stage of the MSM,
        so that every request after it runs at steady-state latency. (The
        MSM gathers only rows of nonzero digit: a zero assignment would
        leave its bucket reduce unrun.)"""
        t0 = time.perf_counter()
        ones = np.zeros((self.dpk.n_vars, 8), np.int32)
        ones[:, 0] = 1
        self._gd.prove_prepared(self.dpk, 0, 0, ones, self.window_bits)
        self.compile_s = time.perf_counter() - t0
        return self.compile_s

    def prove(self, witness, r: Optional[int] = None, s: Optional[int] = None):
        from .models.groth16 import random_scalar

        r = random_scalar() if r is None else r
        s = random_scalar() if s is None else s
        t0 = time.perf_counter()
        proof = self._gd.prove_prepared(self.dpk, r, s, witness, self.window_bits)
        return proof, time.perf_counter() - t0

    def handle(self, req: dict) -> dict:
        if req.get("cmd") == "ping":
            return {
                "ok": True,
                "n_vars": self.dpk.n_vars,
                "domain_size": self.dpk.domain_size,
                "window_bits": self.window_bits,
                "load_s": round(self.load_s, 2),
                "stage_s": round(self.stage_s, 2),
                "compile_s": None if self.compile_s is None else round(self.compile_s, 2),
                "n_proofs": self.n_proofs,
            }
        with trace.request(), trace.span("server.handle", root=True):
            return self._prove_request(req)

    def _prove_request(self, req: dict) -> dict:
        """One prove request, in the spans server.read_wtns and
        server.public (a witness file's read and public decode),
        server.prove and server.respond."""
        n_pub = self.matrices.num_instance_variables
        if "inputs" in req:
            if self.wc is None:
                return {"ok": False,
                        "error": "server started without a wasm; send 'witness' instead"}
            witness = self.wc.calculate_witness(req["inputs"])
            public = witness[1:n_pub]
        elif "witness" in req:
            witness = [int(v) for v in req["witness"]]
            public = witness[1:n_pub]
        elif "witness_file" in req:
            from .circom.wtns import read_wtns_limbs
            from .ops import limbs as limb_codec

            with trace.span("server.read_wtns"):
                witness = read_wtns_limbs(req["witness_file"])
            with trace.span("server.public"):
                public = limb_codec.limbs_to_ints(witness[1:n_pub])
        else:
            return {"ok": False, "error": "no inputs/witness in request"}

        r = int(req["r"]) if "r" in req else None
        s = int(req["s"]) if "s" in req else None
        with trace.span("server.prove", root=True):
            proof, dt = self.prove(witness, r, s)
        self.n_proofs += 1
        with trace.span("server.respond"):
            return {
                "ok": True,
                "proof": _proof_to_json(proof),
                "public": [str(v) for v in public],
                "prove_s": round(dt, 4),
            }

    # ------------------------------------------------------------- transport

    def serve(self, sock_path: str, ready_cb=None) -> None:
        """Blocking accept loop on a unix socket, one request at a time.
        {"cmd": "shutdown"} stops the loop; a request that fails is answered
        {"ok": false, ...} and the loop goes on."""
        if os.path.exists(sock_path):
            os.unlink(sock_path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(sock_path)
        srv.listen(8)
        if ready_cb:
            ready_cb()
        try:
            running = True
            while running:
                conn, _ = srv.accept()
                with conn, conn.makefile("rwb") as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            req = json.loads(line)
                        except ValueError as e:
                            resp = {"ok": False, "error": f"bad json: {e}"}
                            fh.write(json.dumps(resp).encode() + b"\n")
                            fh.flush()
                            continue
                        if req.get("cmd") == "shutdown":
                            fh.write(b'{"ok": true, "bye": true}\n')
                            fh.flush()
                            running = False
                            break
                        try:
                            resp = self.handle(req)
                        except Exception as e:  # noqa: BLE001 — answer, keep serving
                            resp = {"ok": False, "error": repr(e)[:2000]}
                        fh.write(json.dumps(resp).encode() + b"\n")
                        fh.flush()
        finally:
            srv.close()
            if os.path.exists(sock_path):
                os.unlink(sock_path)


def request(sock_path: str, req: dict, timeout: float = 600.0) -> dict:
    """One-shot client: send a request, read one JSON response line."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(timeout)
    c.connect(sock_path)
    with c, c.makefile("rwb") as fh:
        fh.write(json.dumps(req).encode() + b"\n")
        fh.flush()
        line = fh.readline()
    if not line:
        raise RuntimeError("prove server closed the connection")
    return json.loads(line)
