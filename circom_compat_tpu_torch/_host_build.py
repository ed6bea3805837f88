"""Builds and loads the port's host libraries at first use.

hostsrc/wasm_vm.cpp (the C++ WASM VM behind engine="native") and
hostsrc/field_ops.cpp (the host Montgomery strip and G1 MSM of
ops/native_field.py) each become a shared library, compiled by
`g++ -O3 -shared -fPIC -pthread` into _build_cache/host-<hash of the
sources and flags>/ inside this package (listed in .gitignore), both
sources in parallel. witness/wasm/aot.py compiles the C it emits through
`compile_shared` as well.

Every output is first written under a name that carries the process id
and then renamed into place, so processes that build the same library at
once never load a partial file. A missing compiler or a failed build
raises with the compiler's output; nothing returns None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

HOSTSRC = Path(__file__).parent / "hostsrc"
CACHE = Path(__file__).parent / "_build_cache"
SOURCES = ("wasm_vm", "field_ops")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def compiler(tool: str) -> str:
    """The path of `tool` (gcc, g++) on PATH; raises when it is missing."""
    found = shutil.which(tool)
    if found is None:
        raise RuntimeError(f"{tool} not found on PATH: the port's host libraries are built with it")
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((HOSTSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return CACHE / f"host-{source_hash()}"


def _start(tool: str, flags: Sequence[str], source: Path,
           output: Path) -> Tuple[subprocess.Popen, Path]:
    tmp = output.with_name(f"{output.stem}.{os.getpid()}.tmp{output.suffix}")
    cmd = [compiler(tool), *flags, "-o", str(tmp), str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp


def _finish(proc: subprocess.Popen, tmp: Path, output: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {output.name} failed (exit {proc.returncode}):\n"
                           + log.decode(errors="replace")[-4000:])
    os.replace(tmp, output)


def compile_shared(tool: str, flags: Sequence[str], source: Path, output: Path) -> None:
    """Compile `source` into the shared library `output` (through a
    process-private temporary file)."""
    _finish(*_start(tool, flags, source, output), output)


def build_all() -> Path:
    """Compile every source of hostsrc/ that has no library yet, all in parallel."""
    out = build_dir()
    missing = [n for n in SOURCES if not (out / f"{n}.so").exists()]
    if not missing:
        return out
    out.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = [(_start("g++", GXX_FLAGS, HOSTSRC / f"{n}.cpp", out / f"{n}.so"),
                           out / f"{n}.so") for n in missing]
    errors = []
    for (proc, tmp), output in procs:
        try:
            _finish(proc, tmp, output)
        except RuntimeError as exc:  # wait for every compiler before raising
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of hostsrc/<name>.cpp, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build_all() / f"{name}.so"))
        return _libs[name]
