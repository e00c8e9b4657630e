"""The readings a cell's limits are set from, many seeds in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 ...
        [--seconds 4] [--control] [--fault <name>]

For each seed: the cell's set-up and a short window at its own load (long
enough to finish a log or a sample of aligns), then the numbers the check
compares for the program against the float64 reference (``program``), and
with ``--control`` for the control: the same reference computed in
bfloat16 and put in the program's place, on the same inputs (``control``).
With ``--fault`` the program runs with that fault of ``portbench.faults``
planted under its timed path. One JSON line a seed. Runs on the card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from portbench import faults, run, spec, window


def readings(cell: spec.Cell, seed: int, seconds: float, control: bool,
             device: str = "cuda") -> dict:
    """The compared numbers of one seed: ``{"program": {...}}`` and, with
    ``control``, ``{"control": {...}}``."""
    loop = importlib.import_module(
        f"portbench.loops.{cell.traffic['loop']}")
    c = loop.Cell(cell.config, cell.traffic, seed, device)
    c.setup(seconds)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    w = window.run(c.units(), seconds, sync=sync)
    got, _, numbers = run.check(c, w.records)
    out = {"seed": seed, "units": len(w.records), "program": numbers}
    if control:
        low = c.reference_answers(got, torch.bfloat16)
        out["control"] = c.compare(low, c.reference_answers(low))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault")
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    cell = spec.cell(args.workload)
    if args.fault:
        faults.plant(cell.traffic["loop"], args.fault, setattr)
    for seed in args.seeds:
        out = readings(cell, seed, args.seconds, args.control)
        print(json.dumps({"fault": args.fault} | out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
