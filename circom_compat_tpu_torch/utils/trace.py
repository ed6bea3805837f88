"""Per-stage timing and device profiling for the proving pipeline.

  - ``stage(name, device=None)``: a context manager that records the wall
    time of a pipeline stage into the active collector(s). Library code
    wraps its stages unconditionally: with no active collector and the
    environment knob unset, a stage costs one thread-local read.
  - ``collect()``: a context manager yielding a :class:`Trace` that
    captures every stage entered on this thread while it is active.
    Nested stages are recorded with ``outer/inner`` paths.
  - ``CIRCOM_TPU_TIMINGS=1``: logs every stage to the
    ``circom_compat_tpu_torch.trace`` logger as it completes.
  - ``device_profile(logdir)``: a ``torch.profiler`` capture (host and, on
    a card, device activity) around a block, written as a Chrome trace
    into ``logdir``.
  - ``device_ms(fn, reps, match)``: the mean device time of one launch of a
    kernel, from the kernel spans torch.profiler records.

Timings use ``time.perf_counter``. CUDA work is asynchronous: a stage
that names a CUDA device synchronizes it when it starts and when it ends
(only while it records), so its wall time is its own work and not the
work queued before it. While a stage records and CUDA is initialised, it
also holds an NVTX range of its path, so an Nsight capture of a collected
or logged run shows the same names.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Tuple

import torch

logger = logging.getLogger("circom_compat_tpu_torch.trace")

_tls = threading.local()
_LOG_ENV = "CIRCOM_TPU_TIMINGS"


def _state():
    if not hasattr(_tls, "collectors"):
        _tls.collectors = []  # active Trace objects (innermost last)
        _tls.stack = []  # active stage-name path
    return _tls


@dataclass(eq=False)  # identity semantics: collect() removes its own Trace
class Trace:
    """Stages recorded while a ``collect()`` block was active."""

    stages: List[Tuple[str, float]] = field(default_factory=list)

    def add(self, path: str, seconds: float) -> None:
        self.stages.append((path, seconds))

    def total(self, prefix: str = "") -> float:
        """Sum of top-level stage times under ``prefix`` (nested stages are
        already contained in their parents)."""
        return sum(
            t for name, t in self.stages
            if name.startswith(prefix) and "/" not in name[len(prefix):].lstrip("/")
        )

    def as_dict(self) -> dict:
        out: dict = {}
        for name, t in self.stages:
            out[name] = out.get(name, 0.0) + t
        return out

    def table(self) -> str:
        """Human-readable stage table (indented by nesting depth)."""
        if not self.stages:
            return "(no stages recorded)"
        width = max(len(n) for n, _ in self.stages)
        lines = []
        for name, t in self.stages:
            depth = name.count("/")
            label = "  " * depth + name.rsplit("/", 1)[-1]
            pad = " " * (width + 2 - len(label))
            lines.append(f"{label}{pad}{t * 1e3:10.1f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def collect() -> Iterator[Trace]:
    """Capture every ``stage`` entered on this thread into a Trace."""
    st = _state()
    tr = Trace()
    st.collectors.append(tr)
    try:
        yield tr
    finally:
        st.collectors.remove(tr)


def _sync(device) -> None:
    if device is None:
        return
    if hasattr(device, "synchronize"):  # a parallel.mesh.Mesh: every card of it
        device.synchronize()
    elif torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage(name: str, device=None) -> Iterator[None]:
    """Record one pipeline stage. Nesting produces ``outer/inner`` paths.
    ``device``: the stage's device, or a parallel.mesh.Mesh; a CUDA device
    (every card of a mesh) is synchronized at both ends while the stage
    records. Free when nothing collects and
    ``CIRCOM_TPU_TIMINGS`` is unset."""
    st = _state()
    log = os.environ.get(_LOG_ENV, "") not in ("", "0")
    if not st.collectors and not log:
        yield
        return
    st.stack.append(name)
    path = "/".join(st.stack)
    nvtx = torch.cuda.is_initialized()
    _sync(device)
    if nvtx:
        torch.cuda.nvtx.range_push(path)
    t0 = time.perf_counter()
    try:
        yield
        _sync(device)
    finally:
        dt = time.perf_counter() - t0
        if nvtx:
            torch.cuda.nvtx.range_pop()
        st.stack.pop()
        for tr in st.collectors:
            tr.add(path, dt)
        if log:
            logger.info("%s: %.1f ms", path, dt * 1e3)


@contextlib.contextmanager
def device_profile(logdir: str, enabled: bool = True) -> Iterator[None]:
    """Capture a torch.profiler trace of the block (host activity, and the
    device's when CUDA is available) and write it into ``logdir`` as a
    Chrome trace (chrome://tracing, Perfetto). ``enabled=False`` is a
    no-op, so call sites can gate on a flag without reindenting."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json"))


def device_ms(fn, reps: int, match: str, sessions: int = 5):
    """(mean device ms, spans recorded) of fn(), one launch of a kernel whose
    name holds `match`: the mean of the kernel spans torch.profiler records
    over reps calls, None when it records none. Over many short sessions in
    one process the card's profiler loses spans, at times most of a
    session's, so the session repeats, up to `sessions` times, until reps
    spans are in hand. Never divide the spans' sum by the launches."""
    from torch.profiler import ProfilerActivity, profile

    spans = []
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans += [e.time_range.end - e.time_range.start for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
        if len(spans) >= reps:
            break
    return (sum(spans) / 1e3 / len(spans) if spans else None), len(spans)
