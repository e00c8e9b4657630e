"""LOAM ("TASLO") feature odometry as a CLI (port of ``apps/loam_demo.py``).

    python -m toyslam_tpu_torch.apps.loam_demo out_dir [scan_dir] \\
        [--rings 32] [--fov -30.67 10.67] [--capacity 65536] \\
        [--frames 12] [--seed 0] [--device cuda|cpu]

With ``scan_dir``: numbered PCD scans (the lidar_subscriber_node dump
layout) padded to ``--capacity`` points, ``--rings`` and ``--fov``
describing the sensor. Without: ``--frames`` scans of the synthetic
walls-poles-ground drive (``sim/loam_world``, 16 rings over -25..5 deg,
the JAX app's motion step rounded through f32 as it computes it). Runs
``pipelines/loam.loam_odometry`` in f32, as the JAX app does, on the card
unless ``--device cpu``. Writes:

    out_dir/taslo_trajectory.txt  '# timestamp tx ty tz qx qy qz qw'
                                  (``loam_mapping_node.cpp:1789-1809``)
    out_dir/solution.csv          EvaPos CSV
    out_dir/metrics.jsonl         frames, time, keyframes

and prints the frame rate with the card's name and power limit, and, on
the synthetic drive, the ATE against its ground truth.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("scan_dir", nargs="?", default=None)
    ap.add_argument("--rings", type=int, default=32)
    ap.add_argument("--fov", type=float, nargs=2, default=(-30.67, 10.67))
    ap.add_argument("--capacity", type=int, default=65536)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from toyslam_tpu_torch.apps.common import card_line, device, synchronize
    from toyslam_tpu_torch.core import se3
    from toyslam_tpu_torch.pipelines import loam
    from toyslam_tpu_torch.runtime import loader
    from toyslam_tpu_torch.sim import loam_world
    from toyslam_tpu_torch.utils import evalio

    dev = device(args.device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    gt_poses = None
    if args.scan_dir:
        files = loader.list_scan_files(args.scan_dir)
        xyzi, mask = loader.load_scan_stack(files, capacity=args.capacity)
        rings, fov = args.rings, tuple(args.fov)
    else:
        scans, gt_poses = loam_world.drive(args.frames, args.seed)
        xyzi, mask = loam_world.pack(scans)
        rings, fov = 16, (-25.0, 5.0)
    S = xyzi.shape[0]

    cfg = loam.LoamConfig(n_rings=rings, vertical_fov_deg=fov)
    x = torch.from_numpy(xyzi).to(dev)
    m = torch.from_numpy(mask).to(dev)
    synchronize(dev)
    t0 = time.perf_counter()
    outp = loam.loam_odometry(x, m, cfg)
    pos = outp.positions.double().cpu().numpy()
    quat = outp.quaternions.double().cpu().numpy()  # wxyz
    n_kf = int(outp.n_keyframes)
    wall = time.perf_counter() - t0
    times = np.arange(S) * 0.1

    with open(out_dir / "taslo_trajectory.txt", "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for k in range(S):
            f.write(f"{times[k]:.6f} "
                    f"{pos[k, 0]:.6f} {pos[k, 1]:.6f} {pos[k, 2]:.6f} "
                    f"{quat[k, 1]:.6f} {quat[k, 2]:.6f} {quat[k, 3]:.6f} "
                    f"{quat[k, 0]:.6f}\n")
    T = np.tile(np.eye(4), (S, 1, 1))
    T[:, :3, :3] = se3.quat_to_rot(torch.from_numpy(quat)).numpy()
    T[:, :3, 3] = pos
    evalio.write_evapos_csv(out_dir / "solution.csv",
                            evalio.from_transforms(times, T))
    log = evalio.MetricsLogger(out_dir / "metrics.jsonl")
    log.log(frames=S, wall_sec=round(wall, 3),
            frames_per_sec=round(S / wall, 2), keyframes=n_kf)

    print(f"{S} frames in {wall:.2f} s ({S / wall:.1f} frames/s, "
          f"{(S - 1) / wall:.1f} scans/s after the first; {dev}, "
          f"{card_line(dev)}), {n_kf} keyframes")
    if gt_poses is not None:
        ate = float(np.sqrt(np.mean(np.sum(
            (pos - gt_poses[:, :3, 3]) ** 2, 1))))
        print(f"ATE vs synthetic ground truth: {ate:.3f} m")
    print(f"wrote {out_dir}/taslo_trajectory.txt, solution.csv, "
          f"metrics.jsonl")
    return 0


if __name__ == "__main__":
    sys.exit(main())
