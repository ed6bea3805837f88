"""Reading a torch.profiler capture of a stretch of requests.

The harness wraps the stretch in a range named WINDOW, each request in
REQUEST, and each of the program's trace stages (utils/trace.py `stage`)
in a range of the stage's name (`stage_ranges`), none of which
synchronizes the card. From the capture:

  - busy_s: the union of device activity (kernels, copies, sets) inside
    the window, window_s its length; the idle share is 1 - busy / window
    (the frozen copy of chip_smoke.py `profile_prove`'s idle share);
  - stage_device_s: the device seconds of the operations launched inside
    each stage range, kernels and PyTorch built-ins alike: a device
    operation belongs to the ranges that hold the host call (matched by
    correlation id) that launched it;
  - the breakdown: device operations by total time, and the idle gaps by
    the innermost range the window's thread was in at the gap's middle;
  - kernel_family: the frozen copy of chip_smoke.py `kernel_family`.
"""

from __future__ import annotations

import contextlib
import re
from collections import defaultdict

import torch

WINDOW, REQUEST = "proofbench.window", "proofbench.request"


def kernel_family(name):
    """The family of one of the program's kernels in a profiler name, or
    None for other kernels: an entry kernel with a C name
    (ccf_point_add_g2_madd) gives its group's family (ccf_point_add_g2), a
    template kernel of csrc/field_kernels.cu (in an anonymous namespace)
    its function name."""
    m = re.search(r"\b(ccf_\w+?)(?:_madd|_add)?\b(?:\(|$)", name)
    if m:
        return m.group(1)
    if "anonymous namespace" in name:
        m = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
        return m.group(1) if m else None
    return None


@contextlib.contextmanager
def stage_ranges(trace_module):
    """While active, every `trace_module.stage(name, ...)` also opens a
    profiler range `name` around the stage (the stage itself, with no
    collector and no logger, records nothing and synchronizes nothing)."""
    original = trace_module.stage

    @contextlib.contextmanager
    def stage(name, device=None):
        with torch.profiler.record_function(name):
            with original(name, device):
                yield

    trace_module.stage = stage
    try:
        yield
    finally:
        trace_module.stage = original


def _short(name: str) -> str:
    fam = kernel_family(name)
    return fam if fam else name[:120]


def read_capture(prof, stage_names) -> dict:
    """Reduce a capture (torch.profiler.profile) of a window to numbers."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    ranges, runtime, device = [], {}, []
    annotation_names = set(stage_names) | {WINDOW, REQUEST}
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if name in annotation_names or getattr(e, "is_user_annotation", lambda: False)():
                continue
            device.append((e.start_ns(), e.end_ns(), name, e.correlation_id(),
                           e.linked_correlation_id()))
        elif name in annotation_names:
            ranges.append((e.start_ns(), e.end_ns(), name, e.start_thread_id()))
        elif name.startswith("cu") and e.correlation_id() > 0:  # CUDA runtime and driver calls
            runtime[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
    window = [r for r in ranges if r[2] == WINDOW]
    if len(window) != 1:
        raise RuntimeError(f"the capture holds {len(window)} window ranges, not one")
    w0, w1, _, wthread = window[0]

    # device busy time: the union of activity clipped to the window
    spans = sorted((max(a, w0), min(b, w1)) for a, b, *_ in device if b > w0 and a < w1)
    busy, end, gaps = 0, w0, []
    for a, b in spans:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if end < w1:
        gaps.append((end, w1))

    # each device operation's enclosing stage ranges, through its launch
    by_thread = defaultdict(list)
    for a, b, name, tid in ranges:
        by_thread[tid].append((a, b, name))
    all_ranges = [(a, b, name) for a, b, name, _ in ranges]
    stage_ns = defaultdict(int)
    linked = 0
    for a, b, name, corr, lcorr in device:
        launch = runtime.get(corr) or runtime.get(lcorr)
        if launch is None:
            continue
        linked += 1
        t, tid = launch
        # the launching thread's ranges; all ranges where the profiler names
        # host threads of runtime calls and of ranges apart
        for ra, rb, rname in by_thread.get(tid, all_ranges):
            if ra <= t <= rb and rname in stage_names:
                stage_ns[rname] += b - a

    ops = defaultdict(int)
    for a, b, name, *_ in device:
        ops[_short(name)] += b - a
    idle = defaultdict(int)
    main = sorted(by_thread.get(wthread, ()), key=lambda r: r[1] - r[0])
    for a, b in gaps:
        mid = (a + b) // 2
        label = next((rn for ra, rb, rn in main if ra <= mid <= rb), WINDOW)
        idle[label] += b - a

    def top(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "stage_device_s": {k: v / 1e9 for k, v in stage_ns.items()},
        "device_events": len(device),
        "device_events_linked": linked,
        "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)},
    }
