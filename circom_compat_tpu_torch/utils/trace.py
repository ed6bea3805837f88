"""Spans of the proving pipeline: one recorder, request-scoped and thread-aware.

  - ``span(name, device=None, root=False)``: a context manager around one
    stage or boundary of the pipeline. A span records its name, its
    ``outer/inner`` path, a span id, its parent's id (the enclosing span on
    the same thread), the thread's current request id, the thread id, and
    its start and end in ``time.perf_counter_ns()``. It goes to whichever
    sinks listen:

      collectors  while a ``collect()`` is active, on any thread;
      the logger  while ``CIRCOM_TPU_TIMINGS`` is set: one ``"%s: %.1f ms"``
                  line (path, ms) to ``circom_compat_tpu_torch.trace``;
      profiler    while torch.profiler records on this thread: a
                  ``record_function(name)`` range, on the device trace's
                  clock, which any capture shows;
      the ring    while any of the three listens: the last ``RING_SIZE``
                  spans, host-side, read by ``recent()``; each flagged
                  ``profiled`` when the profiler was on.

    With none listening a span costs a check of the collectors, the
    environment knob and ``torch.autograd._profiler_enabled()``.
  - ``request(rid=None)``: sets the calling thread's current request (a
    fresh id from ``new_request_id()`` when none is given). A worker thread
    enters ``request(rid)`` with the id its caller hands it, so the spans of
    one request share it across threads.
  - ``collect()``: a context manager yielding a :class:`Trace` that receives
    every span, on every thread, while it is active.
  - ``device_ms(fn, reps, match)``: the mean device time of one launch of a
    kernel, from the kernel spans torch.profiler records.

CUDA work is asynchronous: while a collector or the logger listens, a span
that names a CUDA device synchronizes it when it starts and when it ends,
so its time is its own work and not the work queued before it, and holds an
NVTX range of its path (once CUDA is initialised). Under the profiler alone
a span synchronizes nothing: its range and the device's operations share
the capture's clock.

``stage`` is an alias of ``span`` that no module of the package calls.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch

logger = logging.getLogger("circom_compat_tpu_torch.trace")

_LOG_ENV = "CIRCOM_TPU_TIMINGS"
RING_SIZE = 1 << 16

_tls = threading.local()
_collectors: Tuple["Trace", ...] = ()  # replaced, never mutated: spans read it unlocked
_collectors_lock = threading.Lock()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_ring: "collections.deque[Span]" = collections.deque(maxlen=RING_SIZE)


class Span(NamedTuple):
    """One recorded span."""

    name: str
    path: str
    span_id: int
    parent_id: Optional[int]
    request_id: Optional[int]
    thread_id: int
    start_ns: int
    end_ns: int
    profiled: bool

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _stack() -> list:
    """This thread's open spans, as (span id, path prefix for children)."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


@dataclass(eq=False)  # identity semantics: collect() removes its own Trace
class Trace:
    """Spans recorded while a ``collect()`` block was active: ``stages`` as
    (path, seconds), ``spans`` the full records, both in order of ending."""

    stages: List[Tuple[str, float]] = field(default_factory=list)
    spans: List[Span] = field(default_factory=list)

    def add(self, sp: Span) -> None:
        self.stages.append((sp.path, sp.seconds))
        self.spans.append(sp)

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
    """Capture every span, entered on any thread, into a Trace."""
    global _collectors
    tr = Trace()
    with _collectors_lock:
        _collectors = _collectors + (tr,)
    try:
        yield tr
    finally:
        with _collectors_lock:
            _collectors = tuple(c for c in _collectors if c is not tr)


def new_request_id() -> int:
    """A fresh request id from the process counter."""
    return next(_request_ids)


@contextlib.contextmanager
def request(rid: Optional[int] = None) -> Iterator[int]:
    """Make `rid` (a fresh id when None) the calling thread's current
    request for the block; yields it."""
    rid = new_request_id() if rid is None else rid
    prev = getattr(_tls, "rid", None)
    _tls.rid = rid
    try:
        yield rid
    finally:
        _tls.rid = prev


def recent() -> List[Span]:
    """The last RING_SIZE spans recorded while any sink listened, oldest
    first (spans whose children ended before them come after the children)."""
    return list(_ring)


def _sync(device) -> None:
    if device is None:
        return
    if hasattr(device, "synchronize"):  # a parallel.mesh.Mesh: every card of it
        device.synchronize()
    elif torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def span(name: str, device=None, root: bool = False) -> Iterator[None]:
    """Record one span. Nesting produces ``outer/inner`` paths; inside a
    `root` span (a request boundary such as the server's) paths start
    afresh, so a stage's path does not depend on who called it. `device`:
    the span's device, or a parallel.mesh.Mesh; a CUDA device (every card of
    a mesh) is synchronized at both ends while a collector or the logger
    listens. Records nothing when no sink listens."""
    log = os.environ.get(_LOG_ENV, "") not in ("", "0")
    timed = bool(_collectors) or log
    profiled = torch.autograd._profiler_enabled()
    if not (timed or profiled):
        yield
        return
    stack = _stack()
    parent_id, prefix = stack[-1] if stack else (None, "")
    path = f"{prefix}/{name}" if prefix else name
    sid = next(_span_ids)
    stack.append((sid, "" if root else path))
    nvtx = timed and torch.cuda.is_initialized()
    if timed:
        _sync(device)
    if nvtx:
        torch.cuda.nvtx.range_push(path)
    ranged = torch.profiler.record_function(name) if profiled else contextlib.nullcontext()
    t0 = time.perf_counter_ns()
    try:
        with ranged:
            yield
            if timed:
                _sync(device)
    finally:
        t1 = time.perf_counter_ns()
        if nvtx:
            torch.cuda.nvtx.range_pop()
        stack.pop()
        sp = Span(name, path, sid, parent_id, getattr(_tls, "rid", None),
                  threading.get_native_id(), t0, t1, profiled)
        _ring.append(sp)
        for tr in _collectors:
            tr.add(sp)
        if log:
            logger.info("%s: %.1f ms", path, (t1 - t0) / 1e6)


stage = span


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
