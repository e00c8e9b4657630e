"""Registration benchmark (port of ``apps/align.py``, after
``ndt_omp/apps/align.cpp``).

    python -m toyslam_tpu_torch.apps.align target.pcd source.pcd \\
        [--device cuda|cpu] [--json]

Downsamples both clouds at 0.1 m into at most 24576 voxels (and says how
many that cut), then aligns the source to the target with ICP, GICP and NDT
{DIRECT7, DIRECT1, DIRECT27} at resolution 1.0 and prints each method's
time and fitness score (``registration/ndt.fitness_score``).

Timing: 2 warm-up aligns, then 3 batches of ``REPS`` aligns from distinct
initial guesses (x offsets ``linspace(0, 1e-4)`` moved on per batch, as
the JAX app's), each batch closed by a device synchronisation; the median
batch's ms/align is printed with the card's name and power limit.
``--json`` adds one line with every number, the final transforms and the
kernel launches of each method's aligns. Runs on the card; ``--device
cpu`` runs the plain versions on the host (host-clock times).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

REPS = 8
LEAF = 0.1
CAPACITY = 24576


def aligners(s_ds, t_ds):
    """{method: align(guess) -> result with ``transform`` and
    ``converged``}; the NDT maps are built here, outside the timing."""
    from toyslam_tpu_torch.registration import gicp, icp, ndt

    out = {"ICP": lambda g: icp.icp_align(s_ds, t_ds, g),
           "GICP": lambda g: gicp.gicp_align(s_ds, t_ds, g)}
    for method in ("DIRECT7", "DIRECT1", "DIRECT27"):
        cfg = ndt.NDTConfig(resolution=1.0, search_method=method)
        m = ndt.build_ndt_map(t_ds, cfg)
        out[f"NDT ({method})"] = (
            lambda g, m=m, c=cfg: ndt.ndt_align(m, s_ds, g, c))
    return out


def bench(align, dev):
    """(per-batch ms/align, last result) of 2 warm-up aligns and 3 timed
    batches of REPS aligns."""
    from toyslam_tpu_torch.apps.common import synchronize

    eps = np.linspace(0.0, 1e-4, REPS, dtype=np.float32)

    def guess(e):
        g = torch.eye(4)
        g[0, 3] = float(e)
        return g

    for e in eps[:2]:
        align(guess(e))
    times, res = [], None
    for r in range(3):
        batch = eps + np.float32(2e-4 + r * 1e-4)
        synchronize(dev)
        t0 = time.perf_counter()
        for e in batch:
            res = align(guess(e))
        synchronize(dev)
        times.append((time.perf_counter() - t0) / REPS * 1e3)
    return times, res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("target")
    ap.add_argument("source")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json", action="store_true",
                    help="also print one JSON line with every result")
    args = ap.parse_args(argv)

    from toyslam_tpu_torch.apps.common import card_line, device
    from toyslam_tpu_torch.core import pcd_io, pointcloud
    from toyslam_tpu_torch.ops.launches import launches, reset_launches
    from toyslam_tpu_torch.registration import ndt

    dev = device(args.device)
    target_np = pcd_io.read_pcd(args.target)
    source_np = pcd_io.read_pcd(args.source)
    cap = max(len(target_np), len(source_np))
    clouds = [pointcloud.from_numpy(p, capacity=cap, device=dev)
              for p in (target_np, source_np)]
    # Every occupied voxel, to count what the capacity cuts.
    voxels = [int(pointcloud.voxel_downsample(c, LEAF).mask.sum())
              for c in clouds]
    # At most CAPACITY voxels, as the JAX app keeps; a smaller pair keeps
    # its own size, which cuts nothing more and spares the padding.
    ds_cap = min(CAPACITY, cap)
    t_ds, s_ds = (pointcloud.voxel_downsample(c, LEAF, ds_cap)
                  for c in clouds)
    cut = [max(v - ds_cap, 0) for v in voxels]
    print(f"{LEAF} m downsample: target {voxels[0]} voxels, source "
          f"{voxels[1]}; capacity {ds_cap} cut {cut[0]} and {cut[1]}")
    card = card_line(dev)
    print(f"device: {dev} ({card})")

    results = []
    for name, align in aligners(s_ds, t_ds).items():
        reset_launches()
        times, res = bench(align, dev)
        counts = launches()
        fit = float(ndt.fitness_score(s_ds, t_ds, res.transform))
        ms = statistics.median(times)
        print(f"--- {name} ---")
        print(f"median: {ms:.3f} [msec/align] (3 batches of {REPS} aligns, "
              f"{', '.join(f'{t:.3f}' for t in times)}; {card})")
        print(f"fitness: {fit:.6f}\n")
        results.append({
            "method": name, "ms_per_align": ms, "batch_ms_per_align": times,
            "fitness": fit, "converged": bool(res.converged),
            "transform": res.transform.tolist(),
            "launches": {k: v for k, v in counts.items() if v}})
    if args.json:
        print(json.dumps({"device": str(dev), "card": card,
                          "voxels": voxels, "cut": cut, "reps": REPS,
                          "methods": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
