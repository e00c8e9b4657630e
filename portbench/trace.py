"""The traced part of a ``--trace 1`` window: one primed ``torch.profiler``
session over a run of consecutive units of work, and what the benchmark
reads from it.

A session on the card can miss its first device events, and the records
of its last ones can still be on their way when it stops. So a session
starts with a few spins of the card and a pause of the host (left out of
every number) and ends with a pause after the card is idle; and its count
of each of the program's kernels is held to the program's own launch
counters (``ops/launches``) over the same units. A session that lost a
launch is thrown away whole: it never becomes a number.

From a sound session: the traced window (the benchmark's own
``portbench.traced`` span), the device busy time (the union of every
kernel, copy and set on the device within it), each kernel's count and
time, and the device's idle gaps, each attributed to the benchmark span
(``portbench.<call>``, around its calls into the program) that the host
was in while the device waited.
"""

from __future__ import annotations

import re
import time
from typing import NamedTuple

import torch

PRIMER = "spin_kernel"  # torch.cuda._sleep's kernel
TRACED = "portbench.traced"
SPAN_PREFIX = "portbench."

# The program's launch counter of each kernel (ops/launches.launches())
# and the name the kernel has on the device.
KERNELS = {
    "ndt_terms_gathered": "terms_gathered_kernel",
    "ndt_gather_repack": "gather_repack_kernel",
    "ndt_terms_packed": "terms_packed_kernel",
    "nearest_neighbor": "nearest_kernel",
    "neg_dist_bf16": "neg_dist_kernel",
    "gicp_terms": "gicp_terms_kernel",
}


def kernel_pattern(device_name: str):
    return re.compile(rf"(?<![A-Za-z0-9_]){device_name}(?![A-Za-z0-9_])")


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    ops: int  # device operations in the window
    by_name: dict  # name -> [count, seconds]
    idle_by_span: dict  # span name -> idle seconds
    launches: dict  # counter name -> launches the program counted


class LostEvents(RuntimeError):
    """A session's count of a kernel differs from the program's."""


class Session:
    """``with Session(launches) as s: ...`` around the traced units, each
    run inside ``s.span(name)``; ``s.summary()`` afterwards. ``launches``
    is the program's counter function."""

    def __init__(self, launches):
        self.launches = launches

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        for _ in range(4):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        self.before = dict(self.launches())
        self.outer = torch.profiler.record_function(TRACED)
        self.outer.__enter__()
        return self

    def span(self, name: str):
        return torch.profiler.record_function(SPAN_PREFIX + name)

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.outer.__exit__(*exc)
        after = self.launches()
        self.counted = {k: after.get(k, 0) - self.before.get(k, 0)
                        for k in after}
        time.sleep(0.05)
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> Summary:
        """The session's numbers; raises ``LostEvents`` when its kernel
        counts differ from the program's."""
        events = self.prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        spans, device = [], []
        window = None
        for e in events:
            tr = e.time_range
            if e.device_type == cuda:
                # The benchmark's spans also appear on the device's
                # timeline, as annotations: they are no device work.
                if PRIMER not in e.name and not e.name.startswith(
                        SPAN_PREFIX):
                    device.append((tr.start, tr.end, e.name))
            elif e.name == TRACED:
                window = (tr.start, tr.end)
            elif e.name.startswith(SPAN_PREFIX):
                spans.append((tr.start, tr.end, e.name))
        if window is None:
            raise LostEvents("the profiler kept no record of the traced "
                             "span")
        w0, w1 = window
        device = [(max(a, w0), min(b, w1), n) for a, b, n in device
                  if b > w0 and a < w1]
        by_name = {}
        for a, b, n in device:
            c = by_name.setdefault(n, [0, 0.0])
            c[0] += 1
            c[1] += (b - a) * 1e-6
        seen = {k: sum(c for n, (c, _) in by_name.items()
                       if kernel_pattern(dev).search(n))
                for k, dev in KERNELS.items()}
        lost = {k: (seen.get(k, 0), n) for k, n in self.counted.items()
                if k in KERNELS and seen.get(k, 0) != n}
        if lost:
            raise LostEvents("profiler kernel counts differ from the "
                             "program's launches (seen, launched): "
                             f"{lost}")
        busy, gaps = _union(device, w0, w1)
        idle = {}
        spans.sort()
        for g0, g1 in gaps:
            covered = 0.0
            for s0, s1, name in spans:
                if s0 >= g1:
                    break
                part = min(s1, g1) - max(s0, g0)
                if part > 0:
                    idle[name] = idle.get(name, 0.0) + part * 1e-6
                    covered += part
            if g1 - g0 - covered > 0:
                idle["outside_calls"] = (idle.get("outside_calls", 0.0)
                                         + (g1 - g0 - covered) * 1e-6)
        return Summary((w1 - w0) * 1e-6, busy * 1e-6, len(device), by_name,
                       idle, dict(self.counted))


def _union(intervals, w0, w1):
    """Total length of the union of ``intervals`` (start, end, _) and the
    gaps it leaves in [w0, w1]."""
    busy, gaps, cur = 0.0, [], w0
    for a, b, _ in sorted(intervals):
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if w1 > cur:
        gaps.append((cur, w1))
    return busy, gaps


def breakdown(s: Summary, top: int = 10) -> dict:
    """The ``breakdown`` of a traced run: the device operations that took
    most time and the idle gaps by benchmark span, each at most ``top``."""
    ops = sorted(((n, t) for n, (_, t) in s.by_name.items()),
                 key=lambda x: -x[1])[:top]
    idle = sorted(s.idle_by_span.items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n[:120], t] for n, t in ops],
            "idle_gaps": [[n, t] for n, t in idle]}
