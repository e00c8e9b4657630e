"""End-to-end NDT mapping: scans in, trajectory, map and metrics out (port
of ``apps/mapping_demo.py``).

    python -m toyslam_tpu_torch.apps.mapping_demo <scans.bag | pcd_directory> \\
        <out_dir> [--leaf 0.3] [--map-leaf 0.5] [--capacity 131072] \\
        [--map-capacity 65536] [--config cfg.json] [--device cuda|cpu] \\
        [--stream [--checkpoint-every N] [--resume]]

Reads the PointCloud2 messages on ``/velodyne_points`` of a ROS1 bag
(none/bz2/lz4 chunks; times from the message stamps) or a directory of
``cloud_N.pcd`` scans (times 0, 1, ...), both parsed by the host
library's C readers (``runtime/native``), runs NDT odometry with the
bounded global map (``pipelines/odometry.ndt_mapping``, or with
``--stream`` one ``mapping_step`` a scan with a snapshot every N scans to
``out_dir/mapping_state.npz`` that ``--resume`` continues from), and
writes:

    out_dir/trajectory.txt     TUM poses
    out_dir/solution.csv       EvaPos CSV
    out_dir/map.pcd            the global map
    out_dir/metrics.jsonl      per-scan convergence, iterations, score

It runs on the card; ``--device cpu`` runs the plain versions on the host.
Without a card the default raises.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch


def load_scans(source: str, capacity: int):
    """A bag or a PCD directory -> (times [S], xyzi [S, capacity, 4] f32,
    mask [S, capacity])."""
    from toyslam_tpu_torch.runtime import loader, rosbag

    src = Path(source)
    if src.is_dir():
        files = loader.list_scan_files(src)
        if not files:
            raise FileNotFoundError(f"no .pcd files in {src}")
        xyzi, mask = loader.load_scan_stack(files, capacity)
        return np.arange(len(files), dtype=np.float64), xyzi, mask
    xyzi, mask, times, _counts = rosbag.pack_bag_scans(src,
                                                       capacity=capacity)
    if len(times) == 0:
        raise ValueError(f"no PointCloud2 messages in {src}")
    return times, xyzi, mask


def _stream(args, scans, masks, cfg, out_dir: Path):
    """The online loop: mapping_step a scan, a snapshot every
    ``--checkpoint-every`` scans. Returns (map cloud, poses, converged,
    iterations, trans_probability)."""
    from toyslam_tpu_torch.pipelines import odometry as odo
    from toyslam_tpu_torch.utils import checkpoint

    ckpt = out_dir / "mapping_state.npz"
    state = odo.mapping_init(scans[0], masks[0], args.map_capacity, cfg)
    S = scans.shape[0]
    # Fixed-shape snapshot, as the JAX app's: the state, the next scan and
    # the per-scan output buffers.
    poses = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    conv = np.ones((S,), bool)
    iters = np.zeros((S,), np.int32)
    probs = np.zeros((S,), np.float32)
    start = 1
    if args.resume and ckpt.exists():
        (state, start, poses, conv, iters, probs) = checkpoint.load_checkpoint(
            ckpt, (state, np.int32(0), poses, conv, iters, probs))
        start = int(start)
        print(f"resumed from {ckpt} at scan {start}")
    for i in range(start, S):
        state, o = odo.mapping_step(state, scans[i], masks[i], cfg)
        poses[i] = o[0].numpy()
        conv[i], iters[i], probs[i] = o[2], o[3], float(o[4])
        if args.checkpoint_every and i % args.checkpoint_every == 0:
            checkpoint.save_checkpoint(
                ckpt, (state, np.int32(i + 1), poses, conv, iters, probs))
    return state.map_cloud, poses, conv, iters, probs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", help="ROS bag or directory of PCD scans")
    ap.add_argument("out_dir")
    ap.add_argument("--leaf", type=float, default=0.3)
    ap.add_argument("--map-leaf", type=float, default=0.5)
    ap.add_argument("--capacity", type=int, default=131072)
    ap.add_argument("--map-capacity", type=int, default=65536)
    ap.add_argument("--config", default=None,
                    help="JSON config file; its odometry section is used")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--stream", action="store_true",
                    help="online mode: mapping_step fed one scan at a time")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="stream mode: snapshot the mapping state every N "
                         "scans (mapping_state.npz in out_dir)")
    ap.add_argument("--resume", action="store_true",
                    help="stream mode: continue from out_dir/"
                         "mapping_state.npz if present")
    args = ap.parse_args(argv)

    from toyslam_tpu_torch import config as cfgmod
    from toyslam_tpu_torch.apps.common import device
    from toyslam_tpu_torch.core import pcd_io
    from toyslam_tpu_torch.pipelines import odometry as odo
    from toyslam_tpu_torch.utils import evalio

    dev = device(args.device)
    times, xyzi, mask = load_scans(args.source, args.capacity)
    print(f"loaded {len(times)} scans (capacity {args.capacity})")
    if args.config:
        cfg = cfgmod.load_odometry(args.config)
    else:
        cfg = odo.OdometryConfig()._replace(scan_leaf=args.leaf,
                                            map_leaf=args.map_leaf)
    scans = torch.from_numpy(xyzi).to(dev)
    masks = torch.from_numpy(mask).to(dev)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    t0 = time.perf_counter()
    if args.stream:
        map_cloud, poses, conv, iters, probs = _stream(args, scans, masks,
                                                       cfg, out_dir)
        map_xyzi, map_mask = map_cloud
    else:
        out = odo.ndt_mapping(scans, masks, args.map_capacity, cfg)
        o = out.odometry
        poses, conv = o.poses.numpy(), o.converged.numpy()
        iters, probs = o.iterations.numpy(), o.trans_probability.numpy()
        map_xyzi, map_mask = out.map_xyzi, out.map_mask
    map_pts = map_xyzi[map_mask].cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"mapping: {dt:.2f} s total, {(len(times) - 1) / dt:.1f} scans/s "
          f"on {dev} (kernel builds included on a first run)")

    evalio.write_tum(out_dir / "trajectory.txt", times, poses)
    evalio.write_evapos_csv(out_dir / "solution.csv",
                            evalio.from_transforms(times, poses))
    pcd_io.write_pcd(out_dir / "map.pcd", map_pts)
    log = evalio.MetricsLogger(out_dir / "metrics.jsonl")
    for i in range(len(times)):
        log.log(scan=i, time=float(times[i]), converged=bool(conv[i]),
                iterations=int(iters[i]), trans_probability=float(probs[i]))
    print(f"wrote {out_dir}/trajectory.txt ({len(poses)} poses), "
          f"solution.csv, map.pcd ({len(map_pts)} pts), metrics.jsonl")
    return 0


if __name__ == "__main__":
    sys.exit(main())
