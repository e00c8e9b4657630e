"""Diagnostic entry points of the port (``python -m
toyslam_tpu_torch.diag.<name>``), and the timer they share.

``diag_bf16_concat`` measures how accurately bf16 splits rank ``s . t``
(kernel D1); ``profile_gather_modes`` measures row-gather cost in ns/row
(kernel D2). Both run on the card unless ``--device cpu`` asks for the
CPU, and raise without a card. ``k4_ablation`` times K4 with its pass-2
skipping mechanisms taken out; ``kernel_variants`` times K6 and D2 built
with other block shapes; ``ndt_eval_ops`` and ``gicp_call_ops`` count the
device operations of one NDT evaluation and of one K6 call;
``ndt_odometry_edge`` asks whether an odometry align that two routes end
apart sits on an edge of the data; these need the card.
"""

from __future__ import annotations

import time

import torch


def device(name: str = "cuda") -> torch.device:
    """The device a diagnostic runs on; a CUDA device must exist."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


SPIN_CYCLES = 20_000_000  # ~10 ms of the card at 2 GHz


def timed_ms(fn, dev: torch.device, reps: int = 20, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn``: ``warmup`` calls, then ``reps``
    calls between two CUDA events on the card, or between two host-clock
    reads on the CPU. On the card the timed calls are queued behind a spin
    of the card, so that the events see device time and not the host's
    launch rate; if the spin ends before the last call is queued, it is
    doubled (up to 16x) and the measurement repeated."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    for doubling in range(5):
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES << doubling)
        start.record()
        for _ in range(reps):
            fn()
        queued_in_time = not start.query()
        end.record()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / reps
    raise RuntimeError("the timed calls outlast a 16x spin of the card: they "
                       "wait on it, and events would time the host")


L2_FLUSH_BYTES = 256 << 20  # five times the card's 50 MB L2


def timed_cold_ms(fn, dev: torch.device, reps: int = 20,
                  warmup: int = 2) -> float:
    """Mean device milliseconds of one call of ``fn`` that finds the L2
    cache cold: each call follows a read of a buffer five times the L2's
    size (clean lines, so the call pays no write-backs) and is timed alone
    between two CUDA events, all of it queued behind a spin of the card as
    in ``timed_ms``. On the CPU, ``timed_ms``."""
    if dev.type != "cuda":
        return timed_ms(fn, dev, reps, warmup)
    for _ in range(warmup):
        fn()
    flush = torch.ones(L2_FLUSH_BYTES // 4, device=dev)
    for doubling in range(5):
        torch.cuda.synchronize(dev)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(SPIN_CYCLES << doubling)
        for start, end in events:
            flush.sum()
            start.record()
            fn()
            end.record()
        queued_in_time = not events[0][0].query()
        events[-1][1].synchronize()
        if queued_in_time:
            return sum(s.elapsed_time(e) for s, e in events) / reps
    raise RuntimeError("the timed calls outlast a 16x spin of the card: they "
                       "wait on it, and events would time the host")
