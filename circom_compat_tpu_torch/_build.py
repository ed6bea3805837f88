"""Builds and loads the CUDA kernels of csrc/ at first use.

Each csrc/*.cu becomes its own shared library with a plain C interface,
compiled by `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC` and loaded with ctypes: no PyTorch headers, so a build
takes seconds. All sources compile in parallel, one nvcc each. The output
goes to _build_cache/<hash of the sources>/ inside this package (listed in
.gitignore), so an edited source rebuilds and an unchanged one loads at once.
The ptxas report (registers, spills) of each library is kept beside it as
<name>.ptxas.txt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).parent / "csrc"
CACHE = Path(__file__).parent / "_build_cache"
SOURCES = ("field_kernels", "curve_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argtypes of every C entry point (pointers and the stream as c_void_p)
SIGNATURES = {
    "field_kernels": {
        "ccf_fr_binary": [_P, _P, _P, _L, _I, _I, _I, _P],
        "ccf_fr_tile_scan": [_P, _P, _P, _P, _L, _I, _P],
        "ccf_ntt_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _P],
        "ccf_fr_butterfly_stage": [_P, _P, _P, _L, _I, _I, _P],
        "ccf_fq_op_chain": [_P, _P, _P, _L, _I, _I, _P],
    },
    "curve_kernels": {
        "ccf_point_add": [_I, _I, _P, _P, _P, _L, _P],
        "ccf_point_tile_scan": [_I, _I, _P, _P, _P, _P, _L, _I, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: float = 0.0  # wall time of the last build (0 when cached)


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return CACHE / source_hash()


def build_all() -> Path:
    """Compile every source that has no library yet, all in parallel."""
    global build_seconds
    out = build_dir()
    missing = [n for n in SOURCES if not (out / f"{n}.so").exists()]
    if not missing:
        return out
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = []
    for name in missing:
        tmp = out / f"{name}.{os.getpid()}.tmp.so"
        log = open(out / f"{name}.ptxas.txt", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, out / f"{name}.so")
    if failed:
        text = "\n".join((out / f"{n}.ptxas.txt").read_text()[-4000:] for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{text}")
    build_seconds = time.perf_counter() - t0
    return out


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _libs:
            path = build_all() / f"{name}.so"
            handle = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = ctypes.c_int
            _libs[name] = handle
        return _libs[name]


def runs_plain(t) -> bool:
    """A wrapper's dispatch: True for a CPU tensor (its plain version runs),
    False for a CUDA tensor (its kernel launches); other devices raise."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"the kernels run on CUDA tensors (plain versions on CPU), not {t.device}")


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc} launching {what}")
