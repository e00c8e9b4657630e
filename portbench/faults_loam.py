"""Faults planted under the LOAM cell's timed path, to show that its check
catches them: by ``tests/test_pb_loam.py`` on the CPU, and on the card
at the cell's own size:

    python3 -m portbench.faults_loam --fault <name> --seeds 1 2 3 ...
        [--workload hdl32-loam.drive] [--seconds 30]

which prints ``calibrate.readings``' line a seed with the fault planted.

- ``maps_frozen``: a step hands back the maps it received, so no keyframe
  after the first scan's adds its features;
- ``half_surf``: every other surface pick of each scan is dropped;
- ``pose_moved``: each step's pose moved 2 cm along x where it is handed
  to the caller (the state carries the true one);
- ``gn_short``: one Gauss-Newton iteration fewer than the configuration's
  (9 in place of 10).

The cell runs on one card, so no exchange between chips can be left
out.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

FAULTS = ("maps_frozen", "half_surf", "pose_moved", "gn_short")


def plant(fault: str, setattr_) -> None:
    """Plants ``fault`` in ``toyslam_tpu_torch.pipelines.loam`` by
    ``setattr_(module, name, value)``: pytest's ``monkeypatch.setattr``,
    or ``setattr`` in a process of its own."""
    from toyslam_tpu_torch.pipelines import loam

    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r} for the loam loop")
    step = loam.loam_step
    if fault == "maps_frozen":
        def frozen(state, *a, **k):
            new, out = step(state, *a, **k)
            return new._replace(maps=state.maps), out

        setattr_(loam, "loam_step", frozen)
    elif fault == "half_surf":
        extract = loam.organize_and_extract

        def half(*a, **k):
            f = extract(*a, **k)
            keep = torch.arange(f.surf_mask.shape[0],
                                device=f.surf_mask.device) % 2 == 0
            return f._replace(surf_mask=f.surf_mask & keep)

        setattr_(loam, "organize_and_extract", half)
    elif fault == "pose_moved":
        def moved(*a, **k):
            new, out = step(*a, **k)
            t = out.t.clone()
            t[0] += 0.02
            return new, out._replace(t=t)

        setattr_(loam, "loam_step", moved)
    else:
        optimize = loam._optimize

        def short(features, maps, q, t, cfg):
            return optimize(features, maps, q, t, cfg._replace(
                optimization_iterations=cfg.optimization_iterations - 1))

        setattr_(loam, "_optimize", short)


def main(argv=None) -> int:
    from portbench import calibrate, run, spec

    ap = argparse.ArgumentParser(prog="python3 -m portbench.faults_loam")
    ap.add_argument("--workload", default="hdl32-loam.drive")
    ap.add_argument("--fault", required=True, choices=FAULTS)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    cell = spec.cell(args.workload)
    plant(args.fault, setattr)
    for seed in args.seeds:
        out = calibrate.readings(cell, seed, args.seconds, False)
        print(json.dumps({"fault": args.fault} | out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
