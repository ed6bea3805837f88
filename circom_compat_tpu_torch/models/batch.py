"""Batch proving: witness generation on host threads feeding the card.

Many proofs against one proving key is the common production shape. The
staged DeviceProvingKey stays resident and the work is pipelined:

  host witness workers (a thread pool, one WitnessCalculator per thread)
      -> the device prove core (prove_core; kernel launches are
         asynchronous, so the next witness is computed meanwhile)
      -> host proof assembly (readback, Horner fold, r/s algebra)

at most `inflight` proves queued on the device at once. Per-proof latency
equals the single prove's; results come back in input order.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..constants import R_SCALAR
from . import groth16_device as gd


@dataclass
class BatchResult:
    proof: object
    public_inputs: List[int]
    witness: Optional[List[int]] = None


class BatchProver:
    """Prove many input sets against one staged key (on the key's device).

    wasm_source: path or bytes of the circuit's witness program; each
    worker thread builds its own WitnessCalculator (an instance is stateful
    and must not be shared across threads).
    """

    def __init__(self, dpk: gd.DeviceProvingKey, wasm_source, workers: int = 2,
                 window_bits: Optional[int] = None, sanity_check: bool = False,
                 keep_witness: bool = False):
        self.dpk = dpk
        self.sanity_check = sanity_check
        self.keep_witness = keep_witness
        self.workers = max(1, workers)
        self.window_bits = gd.default_window_bits(dpk) if window_bits is None else window_bits
        if isinstance(wasm_source, bytes):
            self._wasm_bytes = wasm_source
        elif isinstance(wasm_source, str) or hasattr(wasm_source, "__fspath__"):
            with open(wasm_source, "rb") as fh:
                self._wasm_bytes = fh.read()
        else:
            raise TypeError("wasm_source must be a path or bytes")
        self._local = threading.local()

    def _calculator(self):
        from ..witness import WitnessCalculator

        wc = getattr(self._local, "wc", None)
        if wc is None:
            wc = WitnessCalculator(self._wasm_bytes)
            self._local.wc = wc
        return wc

    def _witness(self, inputs) -> List[int]:
        return self._calculator().calculate_witness(inputs, sanity_check=self.sanity_check)

    def prove_many(self, inputs_list: Sequence[dict],
                   rs: Optional[Sequence[Tuple[int, int]]] = None,
                   inflight: int = 2) -> List[BatchResult]:
        """Prove every input dict; results in input order. rs: optional
        per-proof (r, s) for deterministic output; else fresh randomness."""
        from .groth16 import random_scalar

        n = len(inputs_list)
        if rs is None:
            rs = [(random_scalar(), random_scalar()) for _ in range(n)]
        if len(rs) != n:
            raise ValueError("rs length must match inputs")
        dpk, wb = self.dpk, self.window_bits
        results: List[Optional[BatchResult]] = [None] * n
        pending: "queue.Queue" = queue.Queue()

        def drain_one():
            i, w, (g1, g2, _) = pending.get()
            r, s = rs[i]
            proof = gd.assemble_proof(dpk, r, s, g1.cpu().numpy(), g2.cpu().numpy(), wb)
            results[i] = BatchResult(
                proof=proof, public_inputs=[v % R_SCALAR for v in w[1 : dpk.num_inputs]],
                witness=list(w) if self.keep_witness else None)

        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
            futures = [pool.submit(self._witness, inp) for inp in inputs_list]
            for i, fut in enumerate(futures):
                w = fut.result()  # in order: keeps results aligned and bounded
                asg = torch.from_numpy(gd.encode_assignment(w)).to(dpk.device)
                pending.put((i, w, gd.prove_core(dpk, asg, wb)))
                if pending.qsize() >= inflight:
                    drain_one()
            while not pending.empty():
                drain_one()
        return results  # type: ignore[return-value]


def prove_batch(zkey_path, wasm_path, inputs_list: Sequence[dict],
                rs: Optional[Sequence[Tuple[int, int]]] = None, workers: int = 2,
                window_bits: Optional[int] = None, device=None) -> List[BatchResult]:
    """Load the key, stage it on the card (unless `device` names another
    device) and prove every input set."""
    from ..circom.zkey import read_zkey

    pk, matrices = read_zkey(zkey_path)
    dpk = gd.DeviceProvingKey.build(pk, matrices, matrices.num_constraints, device=device)
    bp = BatchProver(dpk, wasm_path, workers=workers, window_bits=window_bits)
    return bp.prove_many(inputs_list, rs=rs)
