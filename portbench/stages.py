"""The traced units' stages, from the spans the program records in a
profiler session (``toyslam_tpu_torch/utils/profiling.span``).

The spans are the benchmark's ``portbench.<unit>`` around each call into
the program (``portbench.traced``, the window, is none) and the program's
``toyslam.<stage>`` inside it. They nest on the one host thread, so at
each moment of the window the host is inside a path of spans, from the
unit's span down to the innermost: ``("portbench.scan",
"toyslam.mapping.step", "toyslam.ndt.align", "toyslam.ndt.derivs")``.

``read(events)`` puts each part of the device's idle gaps, each span's
host time and each device operation (by the host op that launched it) on
that path. Device work is what ``trace.Session`` counts: every kernel,
copy and set in the window, but no annotation (a ``portbench.`` or
``toyslam.`` name, or ``is_user_annotation``). So a session whose only
spans are the units' gives ``trace.Session.summary()``'s busy time,
operations, ``by_name`` and ``idle_by_span`` exactly; ``idle_by_span`` is
keyed by the innermost span, and ``"outside_calls"`` holds idle outside
every unit.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

import torch

from portbench import trace

UNIT_PREFIX = trace.SPAN_PREFIX  # "portbench."
PROGRAM_PREFIX = "toyslam."
OUTSIDE = "outside_calls"


class Stages(NamedTuple):
    window_s: float
    busy_s: float
    ops: int
    by_name: dict  # device operation name -> [count, seconds]
    idle_by_span: dict  # innermost span name -> idle seconds
    idle_by_path: dict  # path (tuple of span names) -> idle seconds
    host_by_path: dict  # path of a span -> [spans, seconds]
    device_by_path: dict  # path the host was in at launch -> [ops, seconds]


def _is_annotation(e) -> bool:
    return (getattr(e, "is_user_annotation", False)
            or e.name.startswith((UNIT_PREFIX, PROGRAM_PREFIX)))


def _timeline(spans):
    """Spans ``(start, end, name)`` that nest -> the host's path over time,
    ``[(start, end, path)]`` in time order, where ``path`` is the tuple of
    the spans open there (outermost first), empty between units; and each
    span's ``(path, seconds)``."""
    out, each, stack, cur = [], [], [], None
    bounds = sorted([(s, 1, -e, n) for s, e, n in spans]
                    + [(e, 0, 0, n) for s, e, n in spans])
    for t, opening, neg_end, name in bounds:
        if cur is not None and t > cur:
            out.append((cur, t, tuple(n for _, n in stack)))
        cur = t
        if opening:
            stack.append((-neg_end, name))
            each.append((tuple(n for _, n in stack), (-neg_end - t) * 1e-6))
        else:
            # The innermost span ending now: spans close inside out.
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][1] == name and stack[i][0] == t:
                    del stack[i]
                    break
    return out, each


def _path_at(timeline, starts, t):
    """The path of ``timeline`` at time ``t`` (``starts`` its starts)."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and timeline[i][0] <= t < timeline[i][1]:
        return timeline[i][2]
    return ()


def read(events) -> Stages:
    """The stages of one profiler session's ``events()``; raises
    ``trace.LostEvents`` when the session kept no traced window."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, device, ops_on_host = [], [], []
    window = None
    for e in events:
        tr = e.time_range
        if e.device_type == cuda:
            if trace.PRIMER not in e.name and not _is_annotation(e):
                device.append((tr.start, tr.end, e.name))
        elif e.name == trace.TRACED:
            window = (tr.start, tr.end)
        else:
            if e.name.startswith((UNIT_PREFIX, PROGRAM_PREFIX)):
                spans.append((tr.start, tr.end, e.name))
            # What the op launched; a span launches what runs in it
            # outside any op (the program's kernels bound by ctypes).
            if getattr(e, "kernels", None):
                ops_on_host.append((tr.start, e.kernels))
    if window is None:
        raise trace.LostEvents("the profiler kept no record of the traced "
                               "span")
    w0, w1 = window
    device = [(max(a, w0), min(b, w1), n) for a, b, n in device
              if b > w0 and a < w1]
    by_name = {}
    for a, b, n in device:
        c = by_name.setdefault(n, [0, 0.0])
        c[0] += 1
        c[1] += (b - a) * 1e-6
    busy, gaps = trace._union(device, w0, w1)
    timeline, each = _timeline(spans)
    starts = [t0 for t0, _, _ in timeline]

    idle, idle_path = {}, {}
    for g0, g1 in gaps:
        covered = 0.0
        for s0, s1, path in timeline:
            if s0 >= g1:
                break
            part = min(s1, g1) - max(s0, g0)
            if part > 0 and path:
                idle[path[-1]] = idle.get(path[-1], 0.0) + part * 1e-6
                idle_path[path] = idle_path.get(path, 0.0) + part * 1e-6
                covered += part
        if g1 - g0 - covered > 0:
            rest = (g1 - g0 - covered) * 1e-6
            idle[OUTSIDE] = idle.get(OUTSIDE, 0.0) + rest
            idle_path[()] = idle_path.get((), 0.0) + rest

    host = {}
    for path, seconds in each:
        c = host.setdefault(path, [0, 0.0])
        c[0] += 1
        c[1] += seconds

    on_device = {}
    for t, kernels in ops_on_host:
        path = _path_at(timeline, starts, t)
        if not path or not w0 <= t < w1:
            continue
        for k in kernels:
            if trace.PRIMER in k.name or k.name.startswith(
                    (UNIT_PREFIX, PROGRAM_PREFIX)):
                continue
            c = on_device.setdefault(path, [0, 0.0])
            c[0] += 1
            c[1] += k.duration * 1e-6
    return Stages((w1 - w0) * 1e-6, busy * 1e-6, len(device), by_name, idle,
                  idle_path, host, on_device)


def subtree(idle_by_path: dict, name: str) -> float:
    """The idle seconds whose innermost span is span ``name`` or one
    inside it."""
    return sum(s for path, s in idle_by_path.items() if name in path)
