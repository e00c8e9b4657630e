"""Runs one cell of ``BENCHMARK.json`` and prints one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with as many CUDA devices as the
cell asks for (otherwise it exits 2 and prints no result). The run:

1. set-up (``setup_s``, from this module's import, which follows the
   interpreter's start by tens of milliseconds): the cell's loop makes
   its inputs on the card from the seed and warms up every shape the cell
   uses; the program's kernels are built on the first run of a checkout
   and found in its build directory afterwards;
2. the window: the cell's closed loop for ``--seconds`` (``window``);
   with ``--trace 1`` one run of units inside a profiler session
   (``trace``);
3. after the window: the device's peak memory, each metric of the cell
   from its reader (``metrics/<name>.py``; the end-to-end metrics, or with
   ``--trace 1`` the per-layer ones), then the check: the program's
   answers against the plain reference's, each number against the
   configuration's limit, which decides ``correct``.

The last line of standard output is the result; the numbers compared, each
with its limit, are the last lines of standard error and the result's
last key. It exits 3 when every profiler session of a traced run lost
events, and 4 when JAX or the JAX package is loaded at the end.
"""

from __future__ import annotations

import time

# The start of set-up: this module's import, tens of milliseconds after
# the interpreter's start (a clock read from /proc can disagree with the
# host's by a minute on a virtual machine).
STARTED = time.perf_counter()

import argparse
import gc
import importlib
import json
import math
import os
import subprocess
import sys
from typing import NamedTuple

from portbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "toyslam_tpu", "bench")


def set_cache_dirs():
    """Kernel caches at fixed paths inside the checkout (the program's
    nvcc libraries already live in ``toyslam_tpu_torch/_build``)."""
    cache = spec.ROOT / "portbench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


class Run(NamedTuple):
    """What a metric's reader reads."""

    setup_s: float
    window: object  # window.Window
    cell: spec.Cell


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def check(c, records):
    """The cell's check after its window: the program's answers (``c``
    frees the rest of its outputs), the reference's, and the numbers
    compared."""
    import torch

    got = c.program_answers(records)
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    ref = c.reference_answers(got)
    return got, ref, c.compare(got, ref)


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda") -> dict:
    """Runs the cell and returns the result's fields (without the checks
    for the device and for JAX)."""
    import torch

    from portbench import window
    from toyslam_tpu_torch.ops.launches import launches

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    loop = importlib.import_module(
        f"portbench.loops.{cell.traffic['loop']}")
    c = loop.Cell(cell.config, cell.traffic, seed, device)
    c.setup(seconds)
    sync()
    setup_s = time.perf_counter() - STARTED
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    w = window.run(c.units(), seconds, cell.traffic if trace else None,
                   launches, sync)
    if trace and w.trace is None:
        raise LostSessions("every profiler session lost events: "
                           + " | ".join(w.lost_sessions))
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run = Run(setup_s, w, cell)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    counted = [r for r in w.records if "failed" in r.info]
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev |= {"busy_s": w.trace.busy_s, "window_s": w.trace.window_s}
    facts = c.facts()
    t_ref = time.perf_counter()
    _, ref, numbers = check(c, w.records)
    facts |= ref.get("facts", {}) | {"check_s": time.perf_counter() - t_ref}
    limits = cell.config["limits"]
    # A number that is not finite (a diverged answer) fails and is
    # printed as null.
    compared = {k: {"value": v if math.isfinite(v) else None,
                    "limit": limits[k]} for k, v in numbers.items()}
    out = {"correct": all(x["value"] is not None and x["value"] <= x["limit"]
                          for x in compared.values()),
           "attempted": len(counted),
           "failed": sum(bool(r.info["failed"]) for r in counted),
           "metrics": metrics, "device": dev}
    if trace:
        from portbench.trace import breakdown
        out["breakdown"] = breakdown(w.trace)
        out["lost_sessions"] = len(w.lost_sessions)
    out["facts"] = facts | {"card": _card() if on_card else device}
    out["compared"] = compared
    return out


class LostSessions(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    cell = spec.cell(args.workload)

    import torch

    # Load from one process with one host thread, so that the program's
    # chain of small host calls competes with no idle worker threads. It
    # costs the rates 5-7 % against torch's default threads (PERF.md §2).
    torch.set_num_threads(1)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2
    try:
        out = execute(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda")
    except LostSessions as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    for name, x in out["compared"].items():
        ok = x["value"] is not None and x["value"] <= x["limit"]
        verdict = "ok" if ok else "FAILED"
        print(f"check {name} {x['value']!r} limit {x['limit']!r} {verdict}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
