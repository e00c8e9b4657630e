"""Per-stage wall timers and the canonical scan log line (the port of
``toyslam_tpu/utils/profiling.py``).

Replaces the reference's inline timing prints (per-align "msec +
fitness", ``ndt_rosbag_mapping_node.cpp:127-133``; per-frame ms,
``loam_mapping_node.cpp:624-626``; the 1x/10x benchmark,
``align.cpp:20-30``). A timed section ends with
``torch.cuda.synchronize`` on every CUDA device that holds a tensor of its
result, so the time includes the work queued on the card for it; results
on the CPU need no wait. For device-side breakdowns use
``torch.profiler`` or CUDA events.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of every tensor in ``obj``: a tensor, or lists,
    tuples (the port's named-tuple results among them) and dicts of
    them, nested."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    return found


def block_until_ready(obj):
    """Wait for the card's work on every CUDA tensor in ``obj``; returns
    ``obj``."""
    for dev in _cuda_devices(obj, set()):
        torch.cuda.synchronize(dev)
    return obj


class StageTimer:
    """Accumulating named wall timers that wait for the card."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def stage(self, name: str, result_holder=None):
        """Time the block; ``result_holder`` (any structure of tensors,
        read when the block ends) is waited for before the clock stops."""
        t0 = time.perf_counter()
        yield
        if result_holder is not None:
            block_until_ready(result_holder)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def time(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args, **kwargs))
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        return out

    def summary(self):
        return {
            name: {
                "total_ms": self.totals[name] * 1e3,
                "count": self.counts[name],
                "avg_ms": self.totals[name] / max(self.counts[name], 1) * 1e3,
            }
            for name in self.totals
        }

    def scan_log_line(self, scan_idx: int, msec: float, fitness: float) -> str:
        """The reference's canonical per-scan line format."""
        return f"align: {msec:.3f} msec, fitness: {fitness:.6f} (scan {scan_idx})"


def bench_1x_10x(fn, *args):
    """align.cpp-style timing: two warm-up calls, one timed call, then ten
    timed calls in a row, each closed by a wait for the card. Returns
    (single_ms, ten_ms, out) on the host clock."""
    block_until_ready(fn(*args))
    block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = block_until_ready(fn(*args))
    single = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(10):
        out = fn(*args)
    block_until_ready(out)
    ten = (time.perf_counter() - t0) * 1e3
    return single, ten, out
