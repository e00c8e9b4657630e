"""Toy ICP-SLAM with EvaPos scoring (port of ``apps/icp_demo.py``).

    python -m toyslam_tpu_torch.apps.icp_demo out_dir [--frames 10] \\
        [--points 2000] [--seed 0] [--step 0.12 0.05 0.0] \\
        [--device cuda|cpu]

The ``ICP/icpslam.py`` + ``ICP/EvaPos.py`` story: one random world field,
from ``numpy.random.default_rng(seed)`` as the JAX app draws it, seen from
a sensor that moves ``--step`` a frame; ``pipelines/icp_slam`` aligns
every frame into a bounded map. Writes:

    out_dir/Solution1.csv   ground truth (EvaPos "Baseline")
    out_dir/Solution2.csv   the ICP-SLAM estimate ("Proposed")
    out_dir/metrics.jsonl   per-frame ICP error and the EvaPos statistics

and prints one JSON line. Exits 0 iff the ATE is below 0.1 m. Runs on the
card; ``--device cpu`` runs the plain versions on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def scenario(frames: int, points: int, seed: int, step):
    """The JAX app's frames: ``(xyzi [S, cap, 4] f32, mask [S, cap],
    ground-truth poses [S, 4, 4] f64, cap)``."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-5, 5, size=(points, 3))
    cap = 1 << int(np.ceil(np.log2(points + 64)))
    xyzi = np.full((frames, cap, 4), 1e9, np.float32)
    mask = np.zeros((frames, cap), bool)
    gt = np.tile(np.eye(4), (frames, 1, 1))
    for i in range(frames):
        shift = np.asarray(step) * i
        xyzi[i, :points, :3] = base - shift + 0.002 * rng.normal(
            size=base.shape)
        xyzi[i, :points, 3] = 0
        mask[i, :points] = True
        gt[i, :3, 3] = shift
    return xyzi, mask, gt, cap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--points", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step", type=float, nargs=3, default=(0.12, 0.05, 0.0),
                    help="per-frame sensor translation (m)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from toyslam_tpu_torch.apps.common import card_line, device, synchronize
    from toyslam_tpu_torch.pipelines import icp_slam
    from toyslam_tpu_torch.utils import evalio

    dev = device(args.device)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    xyzi, mask, gt_T, cap = scenario(args.frames, args.points, args.seed,
                                     args.step)
    S = args.frames
    cfg = icp_slam.IcpSlamConfig(map_capacity=4 * cap, map_leaf=0.3)
    synchronize(dev)
    t0 = time.perf_counter()
    res = icp_slam.icp_slam(torch.from_numpy(xyzi).to(dev),
                            torch.from_numpy(mask).to(dev), cfg)
    map_points = int(res.map_mask.sum())
    wall = time.perf_counter() - t0

    est_T = res.poses.double().numpy()
    times = np.arange(S, dtype=np.float64) * 0.1
    traj_gt = evalio.from_transforms(times, gt_T)
    traj_est = evalio.from_transforms(times, est_T)
    evalio.write_evapos_csv(out / "Solution1.csv", traj_gt)
    evalio.write_evapos_csv(out / "Solution2.csv", traj_est)
    stats = evalio.compare_solutions(traj_gt, traj_est)
    ate_rmse, _ = evalio.ate(est_T[:, :3, 3], gt_T[:, :3, 3], align=False)

    logger = evalio.MetricsLogger(out / "metrics.jsonl")
    errs = res.errors.double().numpy()
    for i in range(S):
        logger.log(frame=i, icp_error=float(errs[i]),
                   tx=float(est_T[i, 0, 3]), ty=float(est_T[i, 1, 3]))
    logger.log(event="evapos",
               **{k: {"avg": float(v.avg), "max": float(v.max)}
                  for k, v in stats.items()})
    print(json.dumps({
        "frames": S,
        "map_points": map_points,
        "ate_rmse_m": round(float(ate_rmse), 5),
        "pos_3d_avg_m": round(float(stats["pos_3d"].avg), 5),
        "icp_iterations": res.iterations.tolist(),
        "wall_s": wall,
        "device": str(dev),
        "card": card_line(dev),
    }))
    return 0 if float(ate_rmse) < 0.1 else 1


if __name__ == "__main__":
    sys.exit(main())
