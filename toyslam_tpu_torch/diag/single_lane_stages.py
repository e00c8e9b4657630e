"""Speed and device work of the one-lane NDT odometry and mapping paths on
the card, stage by stage.

    python -m toyslam_tpu_torch.diag.single_lane_stages

Over the odometry scans of ``chip_smoke.py`` (16 generated 64 x 4096-ray
scans, seed 0, the shipped ``OdometryConfig``; odometry-256k):

- ``ndt_odometry`` and ``ndt_mapping`` (map capacity 65536 at 0.5 m) in
  scans/s on the host clock, each run ``REPEATS`` times after a warm-up
  run;
- one scan's stages: the 0.3 m downsample of a scan, the NDT map build of
  a downsampled scan, ``ndt_align`` of the downsampled scan to the map
  from the identity, and a whole ``odometry_step`` from the identity
  (downsample, map build and align), each as host ms closed by a sync
  (the best of ``REPEATS``) and, under torch.profiler, its device
  operations and device ms.

It uses only what the package has offered since the mapping path was
ported, so it also measures another checkout of the package, for a
comparison on one card in one call:
``PYTHONPATH=<checkout> python3 toyslam_tpu_torch/diag/single_lane_stages.py``.
Prints one JSON line with the card's name and power limit. Needs a CUDA
device.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

N_SCANS, SCAN = 16, 8
MAP_CAPACITY = 65536
REPEATS = 5


def host_runs_s(fn, repeats=REPEATS):
    """Host seconds of ``repeats`` calls of fn after a warm-up call, each
    closed by a sync."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def device_work(fn, sessions=3):
    """One call of fn under torch.profiler after a warm-up: device
    operations and device ms. A session on the card can miss its first
    device events, so each starts with a few spins of the card
    (``torch.cuda._sleep``), left out; an empty session is run again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.01)
            fn()
            torch.cuda.synchronize()
        rows = [(e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.key]
        if rows:
            return {"ops": sum(c for c, _ in rows),
                    "device_ms": sum(t for _, t in rows) / 1e3}
    raise RuntimeError(f"the profiler saw no device operation in {sessions} "
                       "sessions")


def stage(fn):
    runs = host_runs_s(fn)
    return {"host_ms": 1e3 * min(runs), **device_work(fn)}


def run():
    from toyslam_tpu_torch.core import pointcloud
    from toyslam_tpu_torch.pipelines import odometry
    from toyslam_tpu_torch.registration import ndt
    from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans

    if not torch.cuda.is_available():
        raise RuntimeError("single_lane_stages needs a CUDA device")
    dev = torch.device("cuda:0")
    xyzi, mask, _ = spinning_lidar_scans(0, N_SCANS)
    scans = torch.from_numpy(xyzi).to(dev)
    masks = torch.from_numpy(mask).to(dev)
    cfg = odometry.OdometryConfig()
    steps = N_SCANS - 1

    odo = host_runs_s(lambda: odometry.ndt_odometry(scans, masks, cfg))
    mapping = host_runs_s(lambda: odometry.ndt_mapping(
        scans, masks, MAP_CAPACITY, cfg))

    def downsample(k):
        return pointcloud.voxel_downsample(
            pointcloud.PointCloud(scans[k], masks[k]), cfg.scan_leaf,
            cfg.work_capacity, with_intensity=cfg.keep_intensity)

    prev = downsample(SCAN - 1)
    cur = downsample(SCAN)
    m = ndt.build_ndt_map(prev, cfg.ndt)
    state = odometry.odometry_init(scans[SCAN - 1], masks[SCAN - 1], cfg)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    return {
        "card": card, "scans": N_SCANS, "rays": int(masks.shape[1]),
        "odometry_scans_per_s": [steps / s for s in odo],
        "mapping_scans_per_s": [steps / s for s in mapping],
        "scan": SCAN,
        "downsample": stage(lambda: downsample(SCAN)),
        "map_build": stage(lambda: ndt.build_ndt_map(prev, cfg.ndt)),
        "align": stage(lambda: ndt.ndt_align(m, cur, None, cfg.ndt)),
        "odometry_step": stage(lambda: odometry.odometry_step(
            state, scans[SCAN], masks[SCAN], cfg)),
    }


if __name__ == "__main__":
    print(json.dumps(run()))
